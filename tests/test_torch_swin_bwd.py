"""The trainable Swin trunk's backward kernels' closed forms on the CPU:
``torch_window_attention_bwd`` and ``torch_swin_mlp_bwd`` (the kernels'
oracles on the card, rounded where they round) against the JAX package's
custom-VJP backwards (``jax.vjp`` of ``xla_window_attention`` and
``xla_swin_mlp``) and against autograd of the port's plain forwards, in
fp32: C 64 with 2 heads and C 96 with 3, 8 windows with the shift mask
of a 14 x 14 map (M 4) and without; MLP rows 70 (no multiple of a tile).
Tolerances, of the largest reference magnitude per tensor: GRAD_RTOL
1e-4 against JAX (its erf polynomial, sums in another order), 1e-5
against autograd (the same math in another order). Also the checks the
backward wrappers make before the card, and the Functions' CPU route
(autograd of the plain version, counted in ``ops.recomputes``)."""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.swin_attention import \
    xla_window_attention
from medical_tri_modal_pilot_tpu.kernels.swin_mlp import xla_swin_mlp
from medical_tri_modal_pilot_tpu.models import swin as jswin
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.kernels import swin_attention as ksa
from medical_tri_modal_pilot_tpu_torch.kernels import swin_mlp as ksm
from medical_tri_modal_pilot_tpu_torch.kernels import wgrad
from test_torch_swin import _mlp_args, _np, _wa_args
from test_torch_swin_train import _jax_vjp

torch.set_num_threads(1)

GRAD_RTOL = 1e-4
PLAIN_RTOL = 1e-5


def _close(got, want, rtol):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rtol * np.abs(w).max()


def _autograd(fn, args, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    return torch.autograd.grad(fn(*leaves), leaves, torch.from_numpy(cot))


def _attention_case(C, nh, shifted, seed):
    args = _wa_args(8, C, nh, seed=seed)
    smask = jswin._shift_attn_mask(14, 14, 7, 3) if shifted else None
    cot = np.random.default_rng(seed + 1).standard_normal(
        args[0].shape).astype(np.float32)
    return args, smask, cot


@pytest.mark.parametrize("C,nh", [(64, 2), (96, 3)])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_bwd_matches_jax(C, nh, shifted):
    """dx, dW_qkv, db_qkv, dW_proj, db_proj and the bias cotangent."""
    args, smask, cot = _attention_case(C, nh, shifted, seed=20)
    tmask = None if smask is None else torch.from_numpy(smask)
    got = ksa.torch_window_attention_bwd(*map(torch.from_numpy, args), tmask,
                                         nh, torch.from_numpy(cot))
    jm = None if smask is None else np.asarray(smask)
    _, want = _jax_vjp(lambda *a: xla_window_attention(*a, jm, nh), args,
                       cot)
    assert len(got) == len(want) == 6
    _close(got, want, GRAD_RTOL)


@pytest.mark.parametrize("C,nh", [(64, 2), (96, 3)])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_bwd_matches_autograd(C, nh, shifted):
    args, smask, cot = _attention_case(C, nh, shifted, seed=22)
    tmask = None if smask is None else torch.from_numpy(smask)
    got = ksa.torch_window_attention_bwd(*map(torch.from_numpy, args), tmask,
                                         nh, torch.from_numpy(cot))
    want = _autograd(lambda *t: ksa.torch_window_attention(*t, tmask, nh),
                     args, cot)
    _close(got, want, PLAIN_RTOL)
    for g, a in zip(got, args):
        assert g.dtype == torch.float32 and tuple(g.shape) == a.shape


def test_window_attention_bwd_masked_keys_take_no_bias_gradient():
    """A shift-masked (query, key) pair gets no bias cotangent from that
    window: with every window masked alike (M 1, one shift mask), the
    pair's dbias is exactly 0."""
    args = _wa_args(4, 64, 2, seed=24)
    smask = jswin._shift_attn_mask(14, 14, 7, 3)[3:4]
    assert smask.any()
    cot = np.random.default_rng(25).standard_normal(
        args[0].shape).astype(np.float32)
    dbias = ksa.torch_window_attention_bwd(
        *map(torch.from_numpy, args), torch.from_numpy(smask), 2,
        torch.from_numpy(cot))[-1]
    m = torch.from_numpy(smask[0])
    assert torch.all(dbias[:, m] == 0)
    assert torch.all(dbias[:, ~m] != 0)


@pytest.mark.parametrize("C", [64, 96])
def test_swin_mlp_bwd_matches_jax(C):
    """dx, dscale, dbias, dW1, db1, dW2 and db2 over 70 rows."""
    args = _mlp_args(70, C, seed=26)
    cot = np.random.default_rng(27).standard_normal(
        args[0].shape).astype(np.float32)
    got = ksm.torch_swin_mlp_bwd(*map(torch.from_numpy, args),
                                 torch.from_numpy(cot))
    _, want = _jax_vjp(xla_swin_mlp, args, cot)
    assert len(got) == len(want) == 7
    _close(got, want, GRAD_RTOL)


@pytest.mark.parametrize("C", [64, 96])
def test_swin_mlp_bwd_matches_autograd(C):
    args = _mlp_args(70, C, seed=28)
    cot = np.random.default_rng(29).standard_normal(
        args[0].shape).astype(np.float32)
    got = ksm.torch_swin_mlp_bwd(*map(torch.from_numpy, args),
                                 torch.from_numpy(cot))
    want = _autograd(ksm.torch_swin_mlp, args, cot)
    _close(got, want, PLAIN_RTOL)
    for g, a in zip(got, args):
        assert g.dtype == torch.float32 and tuple(g.shape) == a.shape


def test_gelu_grad_matches_autograd():
    h = torch.linspace(-6.0, 6.0, 1201, dtype=torch.float64)
    leaf = h.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(torch.nn.functional.gelu(leaf).sum(), leaf)
    torch.testing.assert_close(ksm.gelu_grad(h), want, rtol=1e-12,
                               atol=1e-12)


def test_swin_mlp_bwd_bf16_rounds_where_autograd_does():
    """In bf16 the closed form keeps autograd's rounding points (dg, g,
    dln, dx and the weight gradients to bf16; h and the LN backward in
    fp32) and adds one, dh to bf16: the two stay within a few bf16 units
    of each gradient's largest entry."""
    args = _mlp_args(70, 96, seed=30)
    cot = np.random.default_rng(31).standard_normal(
        args[0].shape).astype(np.float32)
    ts = [torch.from_numpy(a) for a in args]
    ts[0] = ts[0].bfloat16()
    dy = torch.from_numpy(cot).bfloat16()
    got = ksm.torch_swin_mlp_bwd(*ts, dy)
    leaves = [t.clone().requires_grad_(True) for t in ts]
    want = torch.autograd.grad(ksm.torch_swin_mlp(*leaves), leaves, dy)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        err = (g.float() - w.float()).abs().max()
        assert err <= 2 ** -5 * w.float().abs().max()


def test_backward_wrappers_refuse_before_the_card():
    """CPU tensors, widths no kernel takes and weight sums over widths
    that are not whole 32-column groups are refused by name."""
    args = [torch.from_numpy(a) for a in _wa_args(2, 64, 2)]
    dout = torch.zeros(2, 49, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ksa.cuda_window_attention_bwd(*args, None, 2, dout)
    with pytest.raises(ValueError, match="32-wide heads"):
        ksa.cuda_window_attention_bwd(*args, None, 4, dout)
    mlp = [torch.from_numpy(a) for a in _mlp_args(70, 64)]
    with pytest.raises(ValueError, match="CUDA"):
        ksm.cuda_swin_mlp_bwd(*mlp, torch.zeros(70, 64))
    odd = [torch.from_numpy(a) for a in _mlp_args(70, 48)]
    with pytest.raises(ValueError, match="C % 32"):
        ksm.cuda_swin_mlp_bwd(*odd, torch.zeros(70, 48))
    a = torch.zeros(300, 48, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 32"):
        wgrad.wgrad(a, torch.zeros(300, 96, dtype=torch.bfloat16))


@pytest.mark.parametrize("R,Ka,Nb", [(200704, 96, 384), (200704, 384, 96),
                                     (50176, 192, 768), (3136, 768, 3072)])
def test_wgrad_slices_at_swin_widths(R, Ka, Nb):
    """The weight sums' slicing at the Swin MLP's widths (96 and 192 are
    no multiple of the 64-column tile): whole chunks covering the rows
    once, about TARGET_BLOCKS blocks."""
    rows, slices = wgrad.slicing(R, Ka, Nb)
    assert rows % wgrad.CHUNK_ROWS == 0
    assert (slices - 1) * rows < R <= slices * rows
    tiles = -(-Ka // 64) * -(-Nb // 64)
    assert slices == 1 or tiles * (slices - 1) < wgrad.TARGET_BLOCKS


def test_functions_recompute_on_the_cpu():
    """On CPU tensors the Functions' backward is autograd of the plain
    version (counted in ops.recomputes, no launch), bit for bit; the
    launch counters hold the two backward kernels."""
    assert {"swin_attention_bwd", "swin_mlp_bwd"} <= set(ops.KERNELS)
    args = [torch.from_numpy(a) for a in _mlp_args(70, 64, seed=32)]
    cot = torch.from_numpy(np.random.default_rng(33).standard_normal(
        (70, 64)).astype(np.float32))
    leaves = [a.clone().requires_grad_(True) for a in args]
    ctx = type("Ctx", (), {})()
    ctx.saved_tensors = leaves
    ctx.needs_input_grad = (True,) * 8
    ops.reset_launches()
    got = ksm._SwinMlp.backward(ctx, cot)
    assert ops.recomputes["swin_mlp_bwd"] == 1
    assert ops.launches["swin_mlp_bwd"] == 0
    want = _autograd(ksm.torch_swin_mlp, [a.numpy() for a in args],
                     cot.numpy())
    for g, w in zip(got[:7], want):
        assert torch.equal(g, w)
    assert got[7] is None
