"""The port's cross-modal transformer (models/legacy.py::CROSS_TRANSFORMER,
``cross_transformer_txt_vslt`` and ``bi_cross_transformer_txt_vslt``)
against the JAX package at a small width: 2 layers (1 self + 1 cross per
stream), d 64, 2 heads, batch 4, window 24, 768-wide notes, fp32, weights
carried across by a strict load through models/convert.py. Eval
probabilities against the JAX ``model.apply`` within 1e-5 and two train
steps at --dropout 0 against the JAX Trainer (tolerances at
tests/test_torch_train.py::compare_train_state); the route through
``ops``, the carryforward batches, and the refusals."""
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
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import \
    from_jax_variables
from medical_tri_modal_pilot_tpu_torch.models.legacy import CROSS_TRANSFORMER
from medical_tri_modal_pilot_tpu_torch.train import trainer as port_trainer
from test_torch_train import compare_train_state

B = 4
NAMES = ("cross_transformer_txt_vslt", "bi_cross_transformer_txt_vslt")
SMALL = ["--input-types", "vslt_txt", "--vslt-type", "carryforward",
         "--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--transformer-num-layers", "2",
         "--transformer-dim", "64", "--transformer-num-head", "2",
         "--precision", "fp32"]


def _argv(name=NAMES[0], *extra):
    return ["--model", name] + SMALL + list(extra)


def _batch(cfg, seed=3):
    """Notes present and missing (length 0: two valid tokens by the
    clip(len + 2) rule), a one-step and a full-window vslt sample."""
    b = synthetic_batch(cfg, B, seed=seed)
    b["missing"][:, 2] = [0, 1, 0, 1]
    b["txt_length"][:] = [128, 0, 1, 0]
    b["txt"][1] = b["txt"][3] = 0.0
    b["txt"][2, 1:] = 0.0
    b["input_length"][:2] = [1, 24]
    b["vslt"][0, :, 1:] = 0.0
    return b


def _jax_trainer(argv, batch, eval_only=False):
    jcfg = jax_parse(argv)
    jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batch,
                             eval_only=eval_only)
    variables = jax.device_get({"params": jt.state.params,
                                "batch_stats": jt.state.batch_stats})
    return jt, variables


@pytest.mark.parametrize("name", NAMES)
def test_eval_matches_jax_apply(name):
    """Probabilities and loss of one eval step against the JAX model's
    apply on the same weights (1e-5: fp32 on both sides, the same math
    summed in another order), with non-trivial BatchNorm statistics."""
    _check_eval(_argv(name))


def test_cross_transformer_bert_eval_matches_jax():
    """--berttype bert: the notes as token ids through the 30000 x d table
    (JAX legacy.py:138-141), the eval step as above."""
    _check_eval(_argv(NAMES[0], "--berttype", "bert"))


def _check_eval(argv):
    cfg = parse_config(argv)
    batch = _batch(cfg)
    try:
        jt, variables = _jax_trainer(argv, batch, eval_only=True)
        rng = np.random.default_rng(1)
        bn = variables["batch_stats"]["fc_list"]["bn"]
        bn["mean"] = rng.normal(0, .3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(.5, 2, bn["var"].shape).astype(np.float32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        missing_num = jax_trainer.compute_missing_num(jt.cfg, jb["missing"])
        logits, rmse, aux = jt.model.apply(variables, jb, missing_num, True)
        assert rmse is None and aux is None
        want = np.asarray(jax.nn.sigmoid(logits.astype(jnp.float32)))
    finally:
        jax_ops.configure(False)
    model = get_model(cfg)
    assert isinstance(model, CROSS_TRANSFORMER)
    model.load_state_dict(from_jax_variables(cfg, variables), strict=True)
    probs, loss, rmse = port_trainer.Trainer(cfg, model, "cpu").eval_step(
        batch)
    assert probs.shape == (B,) and rmse is None
    np.testing.assert_allclose(probs, want, atol=1e-5)
    want_loss = float(jax_trainer._bce(np.log(want / (1 - want)),
                                       batch["target"]).mean())
    assert loss == pytest.approx(want_loss, abs=1e-5)


def test_train_steps_match_jax():
    """Two optimizer steps at --dropout 0 from the same weights: the loss
    (1e-5), then parameters, Adam moments and BatchNorm running statistics
    against the JAX Trainer's."""
    argv = _argv(NAMES[0], "--dropout", "0")
    cfg = parse_config(argv)
    batches = [_batch(cfg, seed=s) for s in (3, 4)]
    try:
        jt, variables = _jax_trainer(argv, batches[0])
        model = get_model(cfg)
        model.load_state_dict(from_jax_variables(cfg, variables),
                              strict=True)
        tr = port_trainer.Trainer(cfg, model, "cpu", eval_only=False)
        lr_sum = 0.0
        for batch in batches:
            assert tr.current_lr() == pytest.approx(jt.current_lr(),
                                                    rel=1e-6)
            lr_sum += tr.current_lr()
            loss = tr.train_step(batch)
            assert loss == pytest.approx(float(jt.train_step(batch)),
                                         abs=1e-5)
        compare_train_state(cfg, jt, tr, lr_sum)
    finally:
        jax_ops.configure(False)


def test_the_forward_goes_through_ops(monkeypatch):
    """Each self layer through attn_block and ffn (key-mask row tiles),
    each cross layer through ops.attention (the kv stream's key mask, not
    a self-attention) and ffn over every row."""
    cfg = parse_config(_argv())
    model = get_model(cfg)
    calls = []
    for name in ("attention", "attn_block", "ffn"):
        real = getattr(ops, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append((_name, args, kw))
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    port_trainer.Trainer(cfg, model, "cpu").eval_step(_batch(cfg))
    assert [c[0] for c in calls] == ["attn_block", "ffn", "attn_block", "ffn",
                                     "attention", "ffn", "attention", "ffn"]
    (_, (q, k, v, mask_v, _), kw_v), (_, (q2, k2, _, mask_o, _), kw_o) = [
        c for c in calls if c[0] == "attention"]
    assert q.shape == (B, 24, 2, 32) and k.shape == (B, 128, 2, 32)
    assert q2.shape == (B, 128, 2, 32) and k2.shape == (B, 24, 2, 32)
    assert mask_v.shape == (B, 128) and mask_o.shape == (B, 24)
    assert kw_v == kw_o == {"is_self": False}
    ffn_valid = [c[2]["block_valid"] for c in calls if c[0] == "ffn"]
    assert ffn_valid[0] is None                    # L = 24: no whole tiles
    assert ffn_valid[1].shape == (B, 2)            # L = 128: 64-row tiles
    assert ffn_valid[2] is None and ffn_valid[3] is None


def test_registry_and_parameters():
    """Both names build the same module tree; every parameter is drawn
    from the seed (same seed, same weights); the layer counts follow
    --transformer-num-layers as in the JAX package (n // 2 self layers,
    the rest cross, at least one each)."""
    a, b = (get_model(parse_config(_argv(n))) for n in NAMES)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert "cross_o_0.attention_prenorm_kv.gamma" in sa
    assert "vslt_tokens.init_fc.weight" in sa
    w = sa["vslt_tokens.init_fc.weight"]
    assert w.shape == (64, 18)
    assert 0.1 < float(w.std()) * 18 ** .5 < 10
    for layers, (n_self, n_cross) in {"1": (1, 1), "6": (3, 3),
                                      "5": (2, 3)}.items():
        m = get_model(parse_config(_argv(
            NAMES[0], "--transformer-num-layers", layers)))
        assert (m.n_self, m.n_cross) == (n_self, n_cross)
    with pytest.raises(KeyError, match="cross_transformer_txt_vslt"):
        get_model(parse_config(_argv("cross_transformer_img_vslt_ssscc")))


def test_carryforward_batches():
    cfg = parse_config(_argv())
    b = synthetic_batch(cfg, 16, seed=2)
    assert b["vslt"].shape == (16, 3, 24, 16)
    n = b["input_length"]
    assert n.min() >= 1 and n.max() <= 24
    past = np.arange(24)[None, :] >= n[:, None]
    assert not b["vslt"].transpose(0, 2, 1, 3)[past].any()
    assert set(np.unique(b["vslt"][:, 1])) <= {0.0, 1.0}


def test_unported_inputs_raise():
    """What still raises: a TIE or QIE --vslt-type on a legacy model (the
    legacy families read the carryforward grid; images and vital signs
    with notes run, tests/test_torch_legacy_fusion.py), one stream alone
    in the cross transformer, and note token ids that reach a BioBERT
    projection by mistake, naming --berttype bert (whose token table is
    ported: test_cross_transformer_bert_eval_matches_jax)."""
    for vslt_type in ("TIE", "QIE"):
        for name in (NAMES[0], "earlyfusion_img_txt_vslt", "auxcpc_mbt"):
            with pytest.raises(NotImplementedError, match="carryforward"):
                get_model(parse_config(_argv(name, "--vslt-type",
                                             vslt_type)))
    with pytest.raises(ValueError, match="vslt with img or txt"):
        get_model(parse_config(_argv(NAMES[0], "--input-types", "vslt")))
    cfg = parse_config(_argv())
    batch = _batch(cfg)
    batch["txt"] = np.zeros((B, 128), np.int32)
    with pytest.raises(ValueError, match="--berttype bert"):
        port_trainer.Trainer(cfg, get_model(cfg), "cpu").eval_step(batch)
