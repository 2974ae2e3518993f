"""The port at the model widths the JAX package runs beside BASELINE's
d_model 256 with 4 heads: 128 with 4 heads (d_head 32), 512 with 4 heads
(d_head 128, the FFN's split route on the card) and 256 with 2 heads
(d_head 128). tri_mbt_vsltcls on vslt+txt (2 layers, short TIE, fp32,
dropout 0) against the JAX package from the same weights (the bridge):
the eval step's probabilities and loss, and one train step's loss,
parameters, Adam moments (the step's gradients) and BatchNorm statistics;
and each kernel wrapper takes these widths as far as the device check
(the CPU holds no card), while the widths still refused raise by name."""
import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.kernels import (attention, attn_block,
                                                       ffn, rowmm, umse)
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import \
    from_jax_variables
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
from test_torch_train import (B, MOMENT_RTOL, SMALL, _batch,
                              compare_train_state)

# (d_model, heads): d_head 32, 128, 128
WIDTHS = [(128, 4), (512, 4), (256, 2)]


def _argv(d, h):
    argv = list(SMALL)
    argv[argv.index("--transformer-dim") + 1] = str(d)
    argv[argv.index("--transformer-num-head") + 1] = str(h)
    return argv + ["--dropout", "0"]


@pytest.mark.parametrize("d,h", WIDTHS)
def test_vsltcls_at_other_widths_matches_jax(d, h):
    """From the JAX Trainer's weights (BatchNorm statistics made
    non-trivial): the eval step's probabilities and loss within 1e-5 (fp32
    on both sides, the same math summed in another order, as the tri-modal
    eval parity), then one adamw step on another batch: the loss within
    1e-5 and the parameters, moments and statistics as
    tests/test_torch_train.py::compare_train_state bounds them, the first
    moments (the step's gradients) within MOMENT_RTOL of their tensor's
    largest entry and the second moments, which square them, within
    twice that (measured at d 128: the head's fc_list.0 weight at 2.2e-3
    in its second moment, its first within bound; the head's BatchNorm
    over 4 samples amplifies the summation-order noise)."""
    argv = _argv(d, h)
    cfg, jcfg = parse_config(argv), jax_parse(argv)
    assert cfg.transformer_dim == d and cfg.transformer_num_head == h
    batches = [_batch(cfg, seed=s) for s in (3, 4)]
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batches[0])
        variables = jax.device_get({"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
        model = get_model(cfg)
        model.load_state_dict(from_jax_variables(cfg, variables),
                              strict=True)
        tr = Trainer(cfg, model, "cpu", eval_only=False)
        probs, loss, _ = tr.eval_step(batches[1])
        want_probs, want_loss, _ = jt.eval_step(batches[1])
        assert probs.shape == (B,) and np.all(np.isfinite(probs))
        np.testing.assert_allclose(probs, np.asarray(want_probs), atol=1e-5)
        assert loss == pytest.approx(float(want_loss), abs=1e-5)
        lr = tr.current_lr()
        assert lr == pytest.approx(jt.current_lr(), rel=1e-6)
        loss = tr.train_step(batches[0])
        assert loss == pytest.approx(float(jt.train_step(batches[0])),
                                     abs=1e-5)
        compare_train_state(cfg, jt, tr, lr, sq_rtol=2 * MOMENT_RTOL)
    finally:
        jax_ops.configure(False)


def _umse_args(D):
    x = torch.zeros(2, 9, 3)
    vecs = [torch.zeros(1, D)] + [torch.zeros(D)] * 3
    return [x, *vecs, *vecs, torch.zeros(20, D)]


def _calls(C, H, dt=torch.bfloat16):
    """Each wrapper at model width C with H heads, on CPU tensors."""
    x = torch.zeros(2, 70, C, dtype=dt)
    g, b = torch.ones(C), torch.zeros(C)
    dh = C // H if H and C % H == 0 else 0
    q = torch.zeros(2, 9, H or 1, max(dh, 1), dtype=dt)
    return {
        "umse": lambda: umse.cuda_umse(*_umse_args(C), dt),
        "attn_block": lambda: attn_block.cuda_attn_block(
            x, g, b, torch.zeros(C, 3 * C), torch.zeros(3 * C), None, 4.0,
            H),
        "ffn": lambda: ffn.cuda_ffn(
            x.reshape(-1, C), g, b, torch.zeros(C, 4 * C, dtype=dt),
            torch.zeros(4 * C, dtype=dt), torch.zeros(4 * C, C, dtype=dt),
            torch.zeros(C, dtype=dt)),
        "rowmm": lambda: rowmm.cuda_rowskip_ln_affine(
            x, g, b, torch.zeros(C, 3 * C), torch.zeros(3 * C)),
        "attention": lambda: attention.cuda_masked_attention(q, q, q, None,
                                                             4.0),
    }


@pytest.mark.parametrize("C,H", WIDTHS + [(64, 2), (256, 4)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_wrappers_take_the_model_widths(C, H, dt):
    """Every kernel wrapper passes its checks at the taken widths, in both
    dtypes, and stops only at the device: no width is refused on the way,
    none falls back to the plain version."""
    for name, call in _calls(C, H, dt).items():
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("C,H,refused", [
    (128, 8, ("attn_block", "attention")),      # d_head 16
    (512, 2, ("attn_block", "attention")),      # d_head 256
    (384, 4, ("attn_block", "ffn", "rowmm", "umse")),
    (768, 12, ("attn_block", "ffn", "rowmm", "umse")),
    (192, 3, ("attn_block", "ffn", "rowmm", "umse"))])
def test_other_widths_raise_by_name(C, H, refused):
    """d_head 16 and 256, and C outside 64/128/256/512, raise ValueError
    naming the set of widths taken, before any device work."""
    calls = _calls(C, H)
    for name in refused:
        with pytest.raises(ValueError, match=r"(d_head\)?|C|D|Cin) in \("):
            calls[name]()
