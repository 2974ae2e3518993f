"""The v1 MBT heads in the port against the JAX package on the CPU:
``bi_vslttxt_mbt_v1`` (BASELINE config 2's model; TIE with BioBERT notes,
QIE with ``--berttype bert`` tokens), ``bi_vsltimg_mbt_v1`` (config 3's)
and ``tri_mbt_v1`` (variant 1): eval probabilities over every
``missing_num`` with the weights carried across (small MBT width, the
full Swin-T where the model has images), two train steps of
``bi_vslttxt_mbt_v1`` against the JAX Trainer, the weight bridge both
ways, the v1 family's frozen trunk at ``--img-pretrain No``, and the
variants and wirings that stay unported raising by name."""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.models import TRI_MBT_VSLTCLS
from medical_tri_modal_pilot_tpu_torch.train.trainer import (
    Trainer, compute_missing_num)
from test_torch_unimodal import (B, SMALL, check_eval, check_train_steps,
                                 jax_and_port, round_trip)

BI_TXT = SMALL + ["--model", "bi_vslttxt_mbt_v1", "--input-types",
                  "vslt_txt", "--imgtxt-time", "1"]
BI_IMG = SMALL + ["--model", "bi_vsltimg_mbt_v1", "--input-types",
                  "vslt_img", "--imgtxt-time", "1"]
TRI = SMALL + ["--model", "tri_mbt_v1", "--input-types", "vslt_img_txt",
               "--imgtxt-time", "1"]
# per sample: image present, note present. With both modalities the
# codes are 2 * img missing + txt missing = 0, 1, 2, 3
PRESENT = {"img": [1, 1, 0, 0], "txt": [1, 0, 1, 0]}


def batch_for(cfg, seed=3):
    """A synthetic batch whose samples take every missing-modality code
    of the model's inputs (two CXRs of four: the packed trunk)."""
    b = synthetic_batch(cfg, B, seed=seed)
    rng = np.random.default_rng(seed + 100)
    mods = cfg.input_types.split("_")
    if "img" in mods:
        S = cfg.image_size
        present = np.asarray(PRESENT["img"], bool)
        b["img"] = np.zeros((B, 1, S, S), np.float32)
        b["img"][present] = rng.integers(
            0, 256, (int(present.sum()), 1, S, S)) / np.float32(255)
        b["img_time"] = np.where(present, rng.uniform(-24, 0, B),
                                 -1.0).astype(np.float32)
        b["missing"][:, 1] = ~present
    if "txt" in mods:
        gone = np.asarray(PRESENT["txt"]) == 0
        b["missing"][:, 2] = gone
        b["txt"][gone] = 0.0
        b["txt_length"][gone] = 0
        if b["txt_length"][0] == 0:
            b["txt_length"][0] = 1
    return b


def _codes(cfg, batch):
    return sorted(set(compute_missing_num(
        cfg, torch.from_numpy(batch["missing"])).tolist()))


def check_model_eval(argv, bridge=True):
    """One eval step on a batch of every missing_num of the model's inputs
    (0-1, or 0-3 with three): probabilities and loss within 1e-5; with
    ``bridge`` the weights carried back by the reference converter. An
    image model runs the full frozen Swin-T, packed (2 CXRs of 4)."""
    cfg = parse_config(argv)
    batch = batch_for(cfg)
    assert _codes(cfg, batch) == list(range(2 * cfg.n_modality - 2))
    try:
        _, jt, variables, tr = jax_and_port(argv, batch)
        check_eval(jt, tr, batch)
        if "img" in cfg.input_types:
            assert tr.model.trunk_rows == 3
        if bridge:
            round_trip(cfg, variables, tr.model)
    finally:
        jax_ops.configure(False)


@pytest.mark.parametrize("argv", [
    BI_TXT + ["--vslt-type", "TIE"],
    BI_TXT + ["--vslt-type", "QIE", "--berttype", "bert"], BI_IMG, TRI,
], ids=["bi_vslttxt_mbt_v1", "bi_vslttxt_mbt_v1_qie_bert",
        "bi_vsltimg_mbt_v1", "tri_mbt_v1"])
def test_v1_eval_step_matches_jax(argv):
    check_model_eval(argv)


def test_bi_vslttxt_train_steps_match_jax():
    cfg = parse_config(BI_TXT)
    check_train_steps(BI_TXT, [batch_for(cfg, seed=s) for s in (3, 4)])


@pytest.mark.parametrize("model,inputs", [
    ("bi_vsltimg_mbt_v1", "vslt_img"), ("tri_mbt_v1", "vslt_img_txt")])
def test_v1_trunk_frozen_without_pretrain(model, inputs):
    """The v1 family's trunk is frozen at --img-pretrain No too (JAX
    models.py:314, :368, their img_freeze_override): a train step runs
    (no item-11 refusal), leaves the trunk as it was and keeps it out of
    the optimizer; the flagship at --img-pretrain No stays trainable: its
    trunk trains with the model."""
    cfg = parse_config(SMALL + ["--model", model, "--input-types", inputs,
                                "--img-pretrain", "No", "--dropout", "0"])
    flagship = TRI_MBT_VSLTCLS(cfg.replace(model="tri_mbt_vsltcls"))
    assert not flagship.frozen
    assert flagship.train().img_encoder.training
    model = get_model(cfg)
    assert model.frozen
    tr = Trainer(cfg, model, "cpu", eval_only=False)
    trunk = tr.model.img_encoder
    before = {n: p.detach().clone() for n, p in trunk.named_parameters()}
    assert not {id(p) for p in tr.optimizer.params} & {
        id(p) for p in trunk.parameters()}
    assert np.isfinite(tr.train_step(batch_for(cfg)))
    assert not trunk.training
    for n, p in trunk.named_parameters():
        assert torch.equal(p, before[n]), n
    lin = dict(tr.model.named_parameters())["linear.weight"]
    assert lin.grad is not None and float(lin.grad.abs().max()) > 0


def test_unported_v1_variants_raise():
    """tri_mbt_v2 (the trunk trains) and tri_mbt_v3 (the patch stem) build
    (tests/test_torch_mbt_v23.py holds them to JAX); the v1 family's
    variants take three streams, v2 and v3 one image per sample, the
    bimodal v1 models one image per sample too."""
    tri = ["--input-types", "vslt_img_txt"]
    v2 = get_model(parse_config(SMALL + ["--model", "tri_mbt_v2"] + tri))
    assert not v2.frozen and v2.variant == 2
    v3 = get_model(parse_config(SMALL + ["--model", "tri_mbt_v3"] + tri))
    assert hasattr(v3, "patch_embedding") and not hasattr(v3, "img_encoder")
    with pytest.raises(ValueError, match="one image per sample"):
        get_model(parse_config(SMALL + ["--model", "tri_mbt_v2",
                                        "--multiimages", "1"] + tri))
    with pytest.raises(ValueError, match="one image per sample"):
        get_model(parse_config(BI_IMG + ["--multiimages", "1"]))
    with pytest.raises(ValueError, match="vslt_img_txt"):
        get_model(parse_config(SMALL + ["--model", "tri_mbt_v1",
                                        "--input-types", "vslt_txt"]))
