"""The port's tri-modal path as a whole: the tri_mbt_vsltcls eval step on
vslt+img+txt inputs (BASELINE config 4's flags, and config 5's with
--multiimages 1) at a small MBT width with the full Swin-T trunk, against
the JAX package's eval step, through the packed trunk, its overflow to the
full batch and a batch with no image; one train step against the JAX
Trainer's; and the weight bridge of the img_enc subtree in both
directions."""
import flax
import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.models.convert_ref import \
    convert_reference_state_dict
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import \
    from_jax_variables
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
from test_torch_train import compare_train_state

B = 4
# BASELINE config 4 at a small MBT width; Swin-T stays full (--image-size
# takes only 224 or 512)
CONFIG4 = ["--model", "tri_mbt_vsltcls", "--input-types", "vslt_img_txt",
           "--vslt-type", "TIE", "--imgtxt-time", "1",
           "--output-type", "intubation",
           "--modality-inclusion", "train-missing_test-missing",
           "--batch-size", str(B), "--TIE-len", "64",
           "--transformer-num-layers", "2", "--transformer-dim", "64",
           "--transformer-num-head", "2", "--precision", "fp32"]
# images per sample: packed (present rows <= cap: 2 of 4 single images,
# 6 of 12 slots), overflow (3 > 2, 7 > 6) and none
IMAGES = {
    "single": {"packed": [1, 0, 1, 0], "overflow": [1, 1, 0, 1],
               "none": [0, 0, 0, 0]},
    "multi": {"packed": [3, 0, 1, 2], "overflow": [3, 3, 0, 1],
              "none": [0, 0, 0, 0]},
}


def _batch(cfg, counts, seed=3):
    """A synthetic batch whose sample i carries counts[i] images (0 or 1;
    0-3 with --multiimages 1), notes present and missing."""
    b = synthetic_batch(cfg, B, seed=seed)
    rng = np.random.default_rng(seed + 100)
    S = cfg.image_size
    multi = cfg.multiimages == 1
    img = np.zeros((B, 3 if multi else 1, 1, S, S), np.float32)
    times = np.full((B, 3 if multi else 1), 10.0 if multi else -1.0,
                    np.float32)
    for i, n in enumerate(counts):
        img[i, :n] = rng.integers(0, 256, (n, 1, S, S)) / np.float32(255)
        times[i, :n] = rng.uniform(-24, 0, n)
    b["img"] = img if multi else img[:, 0]
    b["img_time"] = times if multi else times[:, 0]
    b["missing"][:, 1] = np.asarray(counts) == 0
    b["missing"][:, 2] = [0, 1, 0, 1]
    b["txt_length"][:] = [128, 0, 1, 0]
    b["txt"][1] = b["txt"][3] = 0.0
    b["txt"][2, 1:] = 0.0
    return b


@pytest.fixture(scope="module", params=["single", "multi"])
def trimodal(request):
    """A JAX eval-only Trainer (XLA path on the CPU) with non-trivial
    BatchNorm statistics, the port with its weights carried across, and
    the batches of one image layout."""
    argv = CONFIG4 + (["--multiimages", "1"] if request.param == "multi"
                      else [])
    cfg = parse_config(argv)
    batches = {k: _batch(cfg, v) for k, v in IMAGES[request.param].items()}
    jcfg = jax_parse(argv)
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1,
                                 batches["packed"], eval_only=True)
        variables = {
            "params": flax.core.unfreeze(jax.device_get(jt.state.params)),
            "batch_stats": flax.core.unfreeze(
                jax.device_get(jt.state.batch_stats))}
        rng = np.random.default_rng(1)
        bn = variables["batch_stats"]["fc_list"]["bn"]
        bn["mean"] = rng.normal(0, .3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(.5, 2, bn["var"].shape).astype(np.float32)
        jt.state = jt.state.replace(batch_stats=variables["batch_stats"])
        model = get_model(cfg)
        model.load_state_dict(from_jax_variables(cfg, variables),
                              strict=True)
        yield cfg, batches, jt, variables, Trainer(cfg, model, "cpu")
    finally:
        jax_ops.configure(False)


@pytest.mark.parametrize("kind", ["packed", "overflow", "none"])
def test_trimodal_eval_step_matches_jax(trimodal, kind):
    """probs, loss and rmse of one eval step; 1e-5 on probabilities and
    loss: fp32 on both sides, the same math summed in another order through
    12 Swin blocks and two MBT layers (the gap measured 6e-8)."""
    cfg, batches, jt, _, tr = trimodal
    batch = batches[kind]
    probs, loss, rmse = tr.eval_step(batch)
    want_probs, want_loss, want_rmse = jt.eval_step(batch)
    rows = B * (3 if cfg.multiimages == 1 else 1)
    cap = rows // 2
    assert tr.model.trunk_rows == (rows if kind == "overflow" else cap + 1)
    assert probs.shape == (B,) and np.all(np.isfinite(probs))
    np.testing.assert_allclose(probs, np.asarray(want_probs), atol=1e-5)
    assert loss == pytest.approx(want_loss, abs=1e-5)
    assert rmse is None and want_rmse is None


def test_trimodal_images_move_the_output(trimodal):
    """The image stream reaches the head: the packed batch without its
    images gives other probabilities (its no-image twin is the same batch
    with every image missing)."""
    cfg, batches, _, _, tr = trimodal
    with_img, _, _ = tr.eval_step(batches["packed"])
    blank = dict(batches["packed"])
    blank["img"] = np.zeros_like(blank["img"])
    without, _, _ = tr.eval_step(blank)
    assert np.abs(with_img - without).max() > 1e-4


def test_img_enc_bridge_round_trip(trimodal):
    """JAX variables -> port state_dict -> the JAX package's own converter
    gives back the same tree, leaf for leaf (img_enc included), and uses
    every key; and seeded port weights survive the other direction."""
    cfg, _, _, variables, tr = trimodal
    sd = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    params, stats = convert_reference_state_dict(cfg, sd)
    assert "img_enc" in params["backbone"]
    for tree, ref in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        want = dict(jax.tree_util.tree_leaves_with_path(ref))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), str(k))
    seeded = get_model(cfg, torch.Generator().manual_seed(5)).state_dict()
    params, stats = convert_reference_state_dict(
        cfg, {k: v.numpy() for k, v in seeded.items()})
    back = from_jax_variables(cfg, {"params": params, "batch_stats": stats})
    assert back.keys() == seeded.keys()
    for k in seeded:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], seeded[k]), k


@pytest.mark.parametrize("trimodal", ["single"], indirect=True)
def test_trimodal_train_step_matches_jax(trimodal):
    """Config 4 (one image per sample; compiling the JAX train step around
    the full Swin-T takes most of this test's ~40 s, so config 5 is left
    to the eval cases): one optimizer step (--dropout 0, adamw) from the
    same weights on the packed batch: the loss within 1e-5, the parameters, Adam moments and
    BatchNorm statistics as in tests/test_torch_train.py; the frozen trunk
    unchanged on both sides and out of the port's optimizer. The module's
    JAX Trainer is switched to a dropout-0 model and an optimizer for the
    step, and restored after."""
    cfg, batches, jt, variables, _ = trimodal
    cfg0, jcfg0 = cfg.replace(dropout=0.0), jt.cfg.replace(dropout=0.0)
    saved = (jt.cfg, jt.model, jt.tx, jt.state, jt._train_step)
    try:
        jt.cfg, jt.model = jcfg0, jax_get_model(jcfg0)
        jt.tx = jax_trainer.build_optimizer(jcfg0, jt.schedule,
                                            mask_frozen_img=True)
        jt.state = jt.state.replace(opt_state=jt.tx.init(jt.state.params))
        jt._train_step = jax.jit(jt._train_step_impl)
        model = get_model(cfg0)
        model.load_state_dict(from_jax_variables(cfg0, variables),
                              strict=True)
        tr = Trainer(cfg0, model, "cpu", eval_only=False)
        trunk = {n: p.detach().clone()
                 for n, p in model.img_encoder.named_parameters()}
        in_opt = {id(p) for p in tr.optimizer.params}
        assert not in_opt & {id(p) for p in model.img_encoder.parameters()}
        lr = tr.current_lr()
        loss = tr.train_step(batches["packed"])
        assert loss == pytest.approx(float(jt.train_step(batches["packed"])),
                                     abs=1e-5)
        for n, p in model.img_encoder.named_parameters():
            assert torch.equal(p, trunk[n]), n
        compare_train_state(cfg0, jt, tr, lr)
    finally:
        jt.cfg, jt.model, jt.tx, jt.state, jt._train_step = saved
