"""The paper's MBT ablations in the port against the JAX package on the
CPU: ``tri_mbt_vsltcls_noshareumse`` (the img and txt streams' own
stems), ``tri_mbt_vflexible`` / 2 / 3 (learned missing-aware weights of
per-stream logits), ``tri_mbt_vnoshavgtr`` and ``tri_mbt_vnoshnoavgtr``
(a BatchNorm head per stream; the Trainer's loss weighting and output
selection for the latter). Per model, from the JAX Trainer's weights with
every leaf perturbed and random running statistics in every BatchNorm
head, carried across by ``from_jax_variables``: the eval step's
probabilities, loss (and rmse) within 1e-5, then one train step (dropout
0, adamw): the loss within 1e-5, the parameters and Adam moments (so the
gradients, 2e-4 relative) and the running statistics within
``compare_train_state``'s bounds. Also the three distinct stems of
noshareumse, and the bimodal ``*_mbt_vflexible1`` names, which raise on
both sides. Small
width: 2 layers, d 64, 2 heads, TIE-len 64, batch 4, fp32, the full
frozen Swin-T over every image row (``--img-pack 0``: the packed trunk is
held in tests/test_torch_trimodal.py). The flexible temperatures and the
vnosh models: tests/test_torch_variants_flexible.py and
tests/test_torch_variants_vnosh.py; ``*_mt_v1``, the weight bridge's
names of all twelve names of this slice and their trunks:
tests/test_torch_mt.py and tests/test_torch_mt_img.py."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import convert, get_model
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_mbt_v1 import batch_for
from test_torch_train import compare_train_state
from test_torch_unimodal import perturb

# fp32 on both sides: outputs within 1e-5; gradients through the Adam
# moments at compare_train_state's bounds (2e-4 relative)
ATOL = 1e-5
KEY = jax.random.PRNGKey(0)
B = 4
SMALL = ["--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--TIE-len", "64",
         "--transformer-num-layers", "2", "--transformer-dim", "64",
         "--transformer-num-head", "2", "--precision", "fp32",
         "--imgtxt-time", "1", "--img-pack", "0"]
# the twelve names of this slice and their --input-types
NAMES = {"tri_mbt_vsltcls_noshareumse": "vslt_img_txt",
         "tri_mbt_vflexible": "vslt_img_txt",
         "tri_mbt_vflexible2": "vslt_img_txt",
         "tri_mbt_vflexible3": "vslt_img_txt",
         "biimg_mbt_vflexible1": "vslt_img",
         "bitxt_mbt_vflexible1": "vslt_txt",
         "tri_mbt_vnoshavgtr": "vslt_img_txt",
         "tri_mbt_vnoshnoavgtr": "vslt_img_txt",
         "tri_mt_v1": "vslt_img_txt", "biimg_mt_v1": "vslt_img",
         "bitxt_mt_v1": "vslt_txt", "mt_v1": "vslt_img_txt"}


def argv_for(model, *extra):
    return SMALL + ["--model", model, "--input-types", NAMES[model]] + \
        list(extra)


def _random_stats(stats, seed=1):
    """Random running statistics in every BatchNorm head (and in a
    BatchNorm at the model's root, gru_d's ``bn``)."""
    rng = np.random.default_rng(seed)
    for head in stats.values():
        bn = head.get("bn", head)
        bn["mean"] = rng.normal(0, .3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(.5, 2, bn["var"].shape).astype(np.float32)
    return stats


def _jax_outputs(jt, batch):
    """The JAX model's (logits, rmse) of an eval forward on ``batch``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mn = jax_trainer.compute_missing_num(jt.cfg, jb["missing"])
    fn = jax.jit(lambda st, b, m: jt.model.apply(
        {"params": st.params, "batch_stats": st.batch_stats}, b, m,
        True)[:2])
    return fn(jt.state, jb, mn)


def check_model(argv, batch, logits=False, train_loss_tol=ATOL):
    """One model against the JAX package, from the same perturbed
    weights: the eval step (probabilities, loss, rmse) within 1e-5; with
    ``logits`` the raw model outputs too (the [3, B] heads and rmse of
    tri_mbt_vnosh*); then one train step at dropout 0: the loss within
    ``train_loss_tol``, parameters, Adam moments and running statistics.
    Returns the port's Trainer."""
    argv = argv + ["--dropout", "0"]
    cfg, jcfg = parse_config(argv), jax_parse(argv)
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batch)
        variables = {
            "params": perturb(flax.core.unfreeze(jax.device_get(
                jt.state.params))),
            "batch_stats": _random_stats(flax.core.unfreeze(
                jax.device_get(jt.state.batch_stats)))}
        jt.state = jt.state.replace(params=variables["params"],
                                    batch_stats=variables["batch_stats"])
        model = get_model(cfg)
        model.load_state_dict(convert.from_jax_variables(cfg, variables),
                              strict=True)
        tr = trainer.Trainer(cfg, model, "cpu", eval_only=False)
        if logits:
            b = tr.device_batch(batch)
            with torch.no_grad():
                got = tr.model(b, trainer.compute_missing_num(
                    cfg, b["missing"]))[:2]
            for g, w in zip(got, _jax_outputs(jt, batch)):
                assert (g is None) == (w is None)
                if g is not None:
                    assert g.shape == w.shape
                    np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                               atol=ATOL, rtol=ATOL)
        probs, loss, rmse = tr.eval_step(batch)
        want_probs, want_loss, want_rmse = jt.eval_step(batch)
        assert probs.shape == np.shape(want_probs)
        assert probs.shape[0] == cfg.batch_size
        assert np.all(np.isfinite(probs))
        np.testing.assert_allclose(probs, np.asarray(want_probs), atol=ATOL)
        assert loss == pytest.approx(float(want_loss), abs=ATOL)
        assert (rmse is None) == (want_rmse is None)
        if rmse is not None:
            assert rmse == pytest.approx(float(want_rmse), abs=ATOL)
        lr = tr.current_lr()
        assert lr == pytest.approx(jt.current_lr(), rel=1e-6)
        assert tr.train_step(batch) == pytest.approx(
            float(jt.train_step(batch)), abs=train_loss_tol)
        compare_train_state(cfg, jt, tr, lr)
        return tr
    finally:
        jax_ops.configure(False)


def test_noshareumse_matches_jax():
    """The img and txt streams' own stems (umse_img: the timestamp stem
    and feature table; umse_txt: those and the note projection), the
    perturbed weights of the three stems all different; ops.umse still
    runs on the shared vslt stem only."""
    argv = argv_for("tri_mbt_vsltcls_noshareumse")
    batch = batch_for(parse_config(argv))
    tr = check_model(argv, batch)
    calls = []
    umse, ops.umse = ops.umse, lambda *a: calls.append(1) or umse(*a)
    try:
        tr.eval_step(batch)
    finally:
        ops.umse = umse
    assert len(calls) == 1
    sd = tr.model.state_dict()
    stems = [sd[f"{pre}ie_time.0.weight"]
             for pre in ("", "umse_img.", "umse_txt.")]
    assert not any(torch.equal(a, b) for a, b in
                   ((stems[0], stems[1]), (stems[0], stems[2]),
                    (stems[1], stems[2])))
    assert "txt_embedding.weight" not in sd
    assert "umse_txt.txt_embedding.weight" in sd
    assert not any(k.startswith(("umse_img.ie_vslt", "umse_img.ie_demo",
                                 "umse_txt.ie_vslt", "umse_txt.ie_demo"))
                   for k in sd)


def test_vflexible_matches_jax():
    """tri_mbt_vflexible (flex_temp 1): the learned weights perturbed off
    zero, so the masked softmax is exercised in every missing case."""
    argv = argv_for("tri_mbt_vflexible")
    tr = check_model(argv, batch_for(parse_config(argv)))
    assert tr.model.flex_temp == 1.0


@pytest.mark.parametrize("name", ["biimg_mbt_vflexible1",
                                  "bitxt_mbt_vflexible1"])
def test_bimodal_vflexible_raises_on_both_sides(name):
    """The JAX model stacks the two streams' cls tokens but broadcasts the
    demographics to three (models.py:411) and raises; the port refuses the
    name at construction (ROADMAP Queue 3)."""
    argv = argv_for(name)
    jcfg, cfg = jax_parse(argv), parse_config(argv)
    jb = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(lambda b: jax_get_model(jcfg).init(
            KEY, b, jnp.zeros(B, jnp.int32), True), jb)
    with pytest.raises(ValueError, match="Queue 3"):
        get_model(cfg)
