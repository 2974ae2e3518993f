"""The multitoken MBT family in the port against the JAX package on the
CPU: the group tables and hand-built block masks (exactly), the plain
attention block under a 3-D block mask against ``xla_attn_block``
(forward and gradients), both multitoken fusions with the weights carried
across (fp32, every missing case, a sample without a note, whose txt rows
14-15 have every key masked), ``tri_mbt_vmulti`` end to end (the [4, B]
logits, the selected probabilities and loss, one train step at dropout
0; the VSLTMAIN models ``tri_mbt_vmulti2`` and ``tri_mbt_vmultivslt`` in
tests/test_torch_multitoken_vsltmain.py), the weight bridge's names, and
the trainer's multi branches. Small width: 2 layers, d 32 or 64, 2 or 4
heads; each check states its tolerance. The 3-D kernels against their
plain version on the card: tests/test_torch_cuda.py."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.kernels.attn_block import xla_attn_block
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.models import mbt as jmbt
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import \
    torch_attn_block
from medical_tri_modal_pilot_tpu_torch.models import convert, get_model
from medical_tri_modal_pilot_tpu_torch.models import mbt
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_mbt_v1 import batch_for
from test_torch_train import compare_train_state
from test_torch_unimodal import B, SMALL, perturb

ATOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)
MODELS = ("tri_mbt_vmulti", "tri_mbt_vmulti2", "tri_mbt_vmultivslt")


def _argv(model):
    return SMALL + ["--model", model, "--input-types", "vslt_img_txt",
                    "--imgtxt-time", "1"]


# ------------------------------------------------- tables and masks

def test_group_tables_and_masks_match_jax():
    """The group tables, _group_case_weights and the three hand-built
    masks, exactly (the img/txt pattern at several lengths, the first two
    content tokens masked against the whole 16 x 16 block)."""
    for name in ("GROUPS_PER_MODALITY", "_GROUP_CONTRIBUTORS",
                 "_GROUP_CASE_SUBSETS"):
        assert getattr(mbt, name) == getattr(jmbt, name), name
    np.testing.assert_array_equal(mbt._group_case_weights(),
                                  jmbt._group_case_weights())
    np.testing.assert_array_equal(mbt._block_mask_vslt(4),
                                  jmbt._block_mask_vslt(4))
    np.testing.assert_array_equal(mbt._block_mask_groups12(4),
                                  jmbt._block_mask_groups12(4))
    for L in (15, 16, 30, 63):
        np.testing.assert_array_equal(mbt._block_mask_imgtxt(L, 4),
                                      jmbt._block_mask_imgtxt(L, 4))
    m = mbt._block_mask_imgtxt(30, 4)
    assert m[14, :16].all() and m[15, :16].all() and not m[14, 16:].any()
    with pytest.raises(AssertionError, match="bottlenecks_n=4"):
        mbt._block_mask_vslt(2)


# -------------------------------------- the attention block, 3-D mask

def _block_mask_3d(B_, L, groups=4, dead_row=None):
    """The JAX package's own test geometry (tests/test_attn_block.py:
    129-136): a group-diagonal block mask plus the first group; with
    ``dead_row``, that query row of sample 1 has every key masked."""
    g = np.minimum(np.arange(L) * groups // L, groups - 1)
    allow = (g[:, None] == g[None, :]) | (g[None, :] == 0)
    m = np.array(np.broadcast_to(~allow, (B_, L, L)))
    if dead_row is not None:
        m[1, dead_row] = True
    return m


@pytest.mark.parametrize("dead_row", [None, 70])
def test_plain_attn_block_3d_mask_matches_jax(dead_row):
    """torch_attn_block under a [B, L, L] mask against xla_attn_block at
    the JAX test's shapes (B 2, L 130, C 64, 2 heads): forward within
    2e-5, and dx, dgamma, dbeta, dw, db within 2e-4, also where a row has
    every key masked (uniform attention over the real keys)."""
    B_, L, C, H = 2, 130, 64, 2
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B_, L, C)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(C)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(3 * C)).astype(np.float32)
    cot = rng.standard_normal((B_, L, C)).astype(np.float32)
    mask = _block_mask_3d(B_, L, dead_row=dead_row)
    scale = float(np.sqrt(C // H))
    args = (x, gamma, beta, w, b)

    def jloss(*a):
        return jnp.sum(xla_attn_block(*a, jnp.asarray(mask), scale, H)
                       * cot)

    want = xla_attn_block(*args, jnp.asarray(mask), scale, H)
    want_g = jax.grad(jloss, argnums=tuple(range(5)))(*args)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    got = torch_attn_block(*leaves, torch.from_numpy(mask), scale, H)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    got_g = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for g, e, name in zip(got_g, want_g, ["dx", "dgamma", "dbeta", "dw",
                                          "db"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=2e-4,
                                   rtol=2e-4, err_msg=name)


# ------------------------------------------------------- the fusions

D_F = 32
# per sample: vslt lengths, note lengths (txt_length: 0 = no note, 1 =
# the VSLTMAIN stream's vlen == 3 -> 0 rule), missing cases 0-3 and 0
VSLT_LEN = np.array([20, 5, 11, 1, 17])
TXT_LEN = np.array([5, 0, 14, 1, 9])
MISSING = np.array([0, 1, 2, 3, 0])


def _fusion_inputs():
    rng = np.random.default_rng(11)
    inputs = [rng.standard_normal((5, L, D_F)).astype(np.float32)
              for L in (20, 49, 16)]
    varying = [VSLT_LEN, np.full(5, 49), TXT_LEN + 2]
    return inputs, varying


@pytest.mark.parametrize("vslt_main", [False, True],
                         ids=["multitoken", "vsltmain"])
def test_multitoken_fusion_matches_jax(vslt_main):
    """MultitokenMBTFusion and MultitokenMBTVSLTMAINFusion (2 layers, d
    32, 2 heads, dropout 0) with the perturbed JAX weights carried
    across: every stream's output within 1e-5 over missing cases 0-3, a
    sample without a note (the multitoken txt stream's rows 14-15 then
    have every key masked) and one whose note length makes vlen 3."""
    kw = dict(n_modality=3, bottlenecks_n=4, fusion_startidx=0, n_layers=2,
              n_head=2, d_model=D_F, d_ff=4 * D_F, dropout=0.0, txt_idx=2,
              use_pe=(False, False, True), mask=(True, True, True))
    jcls = (jmbt.MultitokenMBTVSLTMAINFusion if vslt_main
            else jmbt.MultitokenMBTFusion)
    pcls = (mbt.MultitokenMBTVSLTMAINFusion if vslt_main
            else mbt.MultitokenMBTFusion)
    inputs, varying = _fusion_inputs()
    jx = [jnp.asarray(x) for x in inputs]
    jv = [jnp.asarray(v) for v in varying]
    jmod = jcls(**kw)
    p = perturb(jax.jit(jmod.init)(KEY, jx, jv,
                                   jnp.asarray(MISSING))["params"])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jmod.apply)({"params": p}, jx, jv,
                                   jnp.asarray(MISSING))
    sd = {}
    convert._multitoken_fusion(sd, "f", p)
    mod = pcls(**kw)
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    got = mod.eval()([torch.from_numpy(x) for x in inputs],
                     [torch.from_numpy(v) for v in varying],
                     torch.from_numpy(MISSING))
    for m in range(3):
        assert got[m].shape == want[m].shape
        np.testing.assert_allclose(got[m].detach().numpy(),
                                   np.asarray(want[m]), err_msg=str(m),
                                   **ATOL)


# ------------------------------------------------- the three models

def _jax_logits(jt, batch):
    """The JAX model's [4, B] logits of an eval step on ``batch``."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    missing_num = jax_trainer.compute_missing_num(jt.cfg, jb["missing"])
    fn = jax.jit(lambda st, b, mn: jt.model.apply(
        {"params": st.params, "batch_stats": st.batch_stats}, b, mn,
        True)[0])
    return np.asarray(fn(jt.state, jb, missing_num)), np.asarray(missing_num)


def check_multitoken_model(model):
    """One model end to end (the full frozen Swin-T over all four rows,
    unpacked; TIE-len 64; every missing case, two samples without a
    note), from the JAX Trainer's weights, every leaf perturbed, carried
    across: the [4, B] logits within 1e-5; the eval step's probabilities
    and loss against the JAX trainer's select_eval_output and BCE on
    those logits, within 1e-5; then one train step (dropout 0, adamw): the
    loss within 1e-5, the parameters and Adam moments (so the gradients)
    within compare_train_state's bounds."""
    argv = _argv(model) + ["--dropout", "0"]
    cfg, jcfg = parse_config(argv), jax_parse(argv)
    batch = batch_for(cfg)
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batch)
        params = perturb(flax.core.unfreeze(jax.device_get(jt.state.params)))
        jt.state = jt.state.replace(params=params)
        model_ = get_model(cfg)
        model_.load_state_dict(
            convert.from_jax_variables(cfg, {"params": params}), strict=True)
        tr = trainer.Trainer(cfg, model_, "cpu", eval_only=False)
        want, missing_num = _jax_logits(jt, batch)
        b = tr.device_batch(batch)
        with torch.no_grad():
            logits = tr.model(b, trainer.compute_missing_num(
                cfg, b["missing"]))[0]
        assert logits.shape == want.shape == (4, B)
        np.testing.assert_allclose(logits.numpy(), want, **ATOL)
        assert tr.model.trunk_rows == B and tr.multi_head
        probs, loss, _ = tr.eval_step(batch)
        out = jax_trainer.select_eval_output(jcfg, want, missing_num)
        np.testing.assert_allclose(probs, np.asarray(jax.nn.sigmoid(out)),
                                   atol=1e-5)
        want_loss = jax_trainer._bce(out, batch["target"]).mean()
        assert loss == pytest.approx(float(want_loss), abs=1e-5)
        lr = tr.current_lr()
        assert lr == pytest.approx(jt.current_lr(), rel=1e-6)
        assert tr.train_step(batch) == pytest.approx(
            float(jt.train_step(batch)), abs=1e-5)
        compare_train_state(cfg, jt, tr, lr)
    finally:
        jax_ops.configure(False)


def test_vmulti_matches_jax():
    """tri_mbt_vmulti end to end (check_multitoken_model); the two
    VSLTMAIN models: tests/test_torch_multitoken_vsltmain.py."""
    check_multitoken_model("tri_mbt_vmulti")


def test_multitoken_bridge_names():
    """The port's state_dict keys are the ones from_jax_variables writes
    for each model's JAX tree: every parameter, nothing else."""
    for model in MODELS:
        argv = _argv(model)
        jcfg = jax_parse(argv)
        cfg = parse_config(argv)
        batch = batch_for(cfg)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        shapes = jax.eval_shape(
            lambda b: jax_get_model(jcfg).init(
                KEY, b, jnp.zeros(B, jnp.int32), True), jb)
        params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                              flax.core.unfreeze(shapes["params"]))
        sd = convert.from_jax_variables(cfg, {"params": params})
        port = get_model(cfg).state_dict()
        assert sd.keys() == port.keys(), model
        for k, v in sd.items():
            assert v.shape == port[k].shape, k


# ------------------------------------------------------ the trainer

def test_trainer_multi_branches_match_jax():
    """compute_loss (multi: the BCE of the heads each missing case
    trains), select_eval_output (the head of the sample's case) and
    multitoken_targets (the 2x repeat under --multitoken 1 and fullmodal
    txt1) against the JAX trainer's."""
    cfg = parse_config(_argv("tri_mbt_vmulti"))
    rng = np.random.default_rng(4)
    n = 8
    logits = rng.normal(0, 2, (4, n)).astype(np.float32)
    targets = rng.integers(0, 2, n).astype(np.float32)
    missing_num = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int64)
    missing = np.zeros((n, 3), np.float32)
    want = jax_trainer.compute_loss(cfg, logits, None, targets, targets,
                                    missing, missing_num)
    got = trainer.compute_loss(cfg, torch.from_numpy(logits), None,
                               torch.from_numpy(targets),
                               torch.from_numpy(targets),
                               torch.from_numpy(missing),
                               torch.from_numpy(missing_num),
                               multi_head=True)
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_array_equal(
        trainer.select_eval_output(cfg, torch.from_numpy(logits),
                                   torch.from_numpy(missing_num),
                                   multi_head=True).numpy(),
        np.asarray(jax_trainer.select_eval_output(cfg, logits,
                                                  missing_num)))
    for c in (cfg, cfg.replace(multitoken=1, fullmodal_definition="txt1")):
        np.testing.assert_array_equal(
            trainer.multitoken_targets(c, torch.from_numpy(targets)).numpy(),
            np.asarray(jax_trainer.multitoken_targets(c, targets)))
    with pytest.raises(ValueError, match="missing_num"):
        trainer.compute_loss(cfg, torch.from_numpy(logits), None,
                             torch.from_numpy(targets),
                             torch.from_numpy(targets), multi_head=True)


def test_multitoken_refusals():
    """The family fuses three streams of one image each; the hand masks
    are built for 4 bottlenecks. (mbt_vnoshnoavgtr's selection and loss,
    once refused here, are held to the JAX trainer's in
    tests/test_torch_variants_vnosh.py.)"""
    with pytest.raises(ValueError, match="vslt_img_txt"):
        get_model(parse_config(SMALL + ["--model", "tri_mbt_vmulti",
                                        "--input-types", "vslt_txt"]))
    with pytest.raises(ValueError, match="one image per sample"):
        get_model(parse_config(_argv("tri_mbt_vmulti2")
                               + ["--multiimages", "1"]))
    with pytest.raises(AssertionError, match="bottlenecks_n=4"):
        get_model(parse_config(_argv("tri_mbt_vmultivslt")
                               + ["--mbt-bottlenecks-n", "2"]))
