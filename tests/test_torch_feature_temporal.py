"""``feature_temporal_v1`` in the port against the JAX package on the CPU,
and the unmasked, PE-free form of ``TransformerEncoder`` its instance
transformer runs. fp32, outputs within 1e-5. The encoder alone (weights
carried across, a 19-row stream, no key mask) against JAX
``TransformerEncoder(mask=False, use_pe=False)``; the model's eval step
and one JAX-Trainer train step at --dropout 0 (loss, parameters, Adam
moments, running statistics at ``compare_train_state``'s bounds) at batch
16: at batch 4 the head's BatchNorm over four samples is ill-conditioned
and the train-mode loss of both sides sits 2.7e-5 apart (ROADMAP Queue
3, the classification entry), at 16 within 3e-7. The bridge a bijection;
the kernels' calls: the instance layers on [B T, 19, D] with no mask,
the temporal layers under the key mask of input_length + 1."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.models import encoder as jencoder
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import convert, get_model
from medical_tri_modal_pilot_tpu_torch.models.encoder import \
    TransformerEncoder
from test_torch_baselines import CARRYFORWARD, SMALL, check_bridge
from test_torch_unimodal import perturb
from test_torch_variants import check_model

ATOL = dict(atol=1e-5, rtol=1e-5)
B = 16
ARGV = [a if a != "4" else str(B) for a in SMALL] + [
    "--model", "feature_temporal_v1"] + CARRYFORWARD


def test_unmasked_encoder_matches_jax():
    """[6, 18, 64] plus the cls token, 2 layers, no key mask, no PE: every
    row a live query and key, nothing padded."""
    x = np.random.default_rng(3).standard_normal((6, 18, 64)).astype(
        np.float32)
    jenc = jencoder.TransformerEncoder(
        d_input=64, n_layers=2, n_head=2, d_model=64, d_ff=256, dropout=0.0,
        use_pe=False, classification=True, mask=False)
    params = perturb(flax.core.unfreeze(jax.device_get(jax.jit(
        jenc.init, static_argnums=(2, 3))(jax.random.PRNGKey(0),
                                          jnp.asarray(x), None, True)[
        "params"])))
    want = jax.jit(jenc.apply, static_argnums=(2, 3))(
        {"params": params}, jnp.asarray(x), None, True)
    sd = {}
    convert._encoder(sd, "enc", params)
    enc = TransformerEncoder(2, 2, 64, 256, dropout=0.0, use_pe=False,
                             mask=False)
    enc.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = enc.eval()(torch.from_numpy(x), None)
    assert got.shape == (6, 19, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATOL)
    with torch.no_grad():
        lengths = torch.full((6,), 3)
        assert torch.equal(enc(torch.from_numpy(x), lengths), got)


def test_feature_temporal_matches_jax():
    cfg = parse_config(ARGV)
    check_model(ARGV, synthetic_batch(cfg, B, seed=3))


def test_feature_temporal_bridge_and_calls(monkeypatch):
    """The bridge; feat_stems drawn as flax's lecun-normal over [F, 1, D]
    (std 1/sqrt(F)), feat_bias 0; and the attention and FFN halves each
    model layer calls: 2 unmasked on [B T, 19, 64], then 2 under the
    temporal stream's key mask on [B, 25, 64]."""
    cfg = parse_config(ARGV)
    batch = synthetic_batch(cfg, B, seed=3)
    check_bridge(ARGV, batch)
    model = get_model(cfg)
    assert not model.feat_bias.any()
    assert float(model.feat_stems.detach().std()) == pytest.approx(16 ** -0.5,
                                                          rel=0.1)
    calls = []
    attn_block = ops.attn_block

    def record(x, *args):
        calls.append((tuple(x.shape), None if args[4] is None
                      else tuple(args[4].shape)))
        return attn_block(x, *args)

    monkeypatch.setattr(ops, "attn_block", record)
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        out = model(b, torch.zeros(B, dtype=torch.long))[0]
    assert out.shape == (B,) and torch.all(torch.isfinite(out))
    T = batch["vslt"].shape[2]
    assert calls == [((B * T, 19, 64), None)] * 2 + [
        ((B, T + 1, 64), (B, T + 1))] * 2
