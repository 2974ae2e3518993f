"""The port's plain masked attention (kernels/attention.py::
torch_masked_attention, the CPU path and the CUDA kernel's oracle) against
the JAX package: its Pallas kernel ``pallas_masked_attention`` run in
interpret mode with its custom VJP, and the XLA ``masked_softmax_attention``
it replaces. The cases are the JAX kernel tests' (tests/test_kernels.py):
tail and non-contiguous key masks, no mask, block masks, all-masked
samples, self-attention with dead q blocks compared on live rows, plus the
cross-modal layers' Lq != Lk both ways. The wrapper's refusals on the CPU.

fp32 throughout. Forward within 2e-5 and gradients within 5e-4 (relative
and absolute), the JAX kernel tests' own tolerances: the same math summed
in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.attention import \
    pallas_masked_attention
from medical_tri_modal_pilot_tpu.models.modules import \
    masked_softmax_attention
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.kernels.attention import (
    cuda_masked_attention, torch_masked_attention)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-4)
SCALE = 8.0


def _mask(kind, B, Lq, Lk, rng):
    """The mask of a case, numpy bool (True = masked), or None."""
    if kind == "none":
        return None
    if kind == "tail":
        lengths = np.linspace(1, Lk, B).astype(np.int64)
        return np.arange(Lk)[None, :] >= lengths[:, None]
    if kind == "noncontig":
        return rng.integers(0, 2, (B, Lk)).astype(bool)
    if kind == "all_masked":
        m = np.arange(Lk)[None, :] >= np.linspace(0, Lk, B).astype(
            np.int64)[:, None]
        m[0] = True
        return m
    if kind == "block":
        m = rng.integers(0, 2, (B, Lq, Lk)).astype(bool)
        m[:, :, 0] = False  # a live key per row
        m[0, 3] = True      # and one row with every key masked
        return m
    raise ValueError(kind)


# (B, H, Lq, Lk, D, mask kind, is_self): the JAX kernel tests' shapes and
# masks, the cross-modal layers' [24] x [128] and [128] x [24], and the
# edge shapes Lq < 16 and Lk < 16
CASES = [
    (3, 2, 54, 54, 32, "tail", False),
    (2, 4, 130, 130, 64, "tail", False),
    (3, 2, 130, 130, 32, "noncontig", False),
    (2, 2, 54, 54, 32, "none", False),
    (2, 2, 54, 54, 32, "block", False),
    (2, 2, 130, 130, 32, "block", False),
    (3, 2, 64, 64, 32, "all_masked", False),
    (3, 2, 300, 300, 64, "tail", True),
    (3, 2, 300, 300, 32, "all_masked", True),
    (3, 4, 24, 128, 64, "tail", False),
    (3, 4, 128, 24, 64, "tail", False),
    (2, 2, 24, 128, 32, "noncontig", False),
    # the tile loop's edges: fewer queries than a warp's 16 rows, and fewer
    # keys than 16, each under a key mask and a block mask
    (3, 2, 5, 300, 32, "tail", False),
    (3, 2, 5, 300, 32, "block", False),
    (3, 2, 130, 7, 32, "tail", False),
    (3, 2, 130, 7, 32, "block", False),
]


def _inputs(B, H, Lq, Lk, D, kind, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Lq, H, D)).astype(np.float32)
    k = rng.normal(0, 1, (B, Lk, H, D)).astype(np.float32)
    v = rng.normal(0, 1, (B, Lk, H, D)).astype(np.float32)
    cot = rng.normal(0, 1, (B, Lq, H, D)).astype(np.float32)
    return q, k, v, _mask(kind, B, Lq, Lk, rng), cot


def _live_rows(mask, is_self, B, Lq):
    """bool [B, Lq]: every row, or under is_self the rows up to each
    sample's last valid key (all of them for an all-masked sample)."""
    if not is_self:
        return np.ones((B, Lq), bool)
    valid = ~mask
    last = np.where(valid.any(1), Lq - 1 - np.argmax(valid[:, ::-1], 1),
                    Lq - 1)
    return np.arange(Lq)[None, :] <= last[:, None]


def _torch_run(q, k, v, mask, cot, is_self):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tm = None if mask is None else torch.from_numpy(mask)
    out = torch_masked_attention(*leaves, tm, SCALE, is_self)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_run(fn, q, k, v, mask, cot):
    """fn's output and its VJP of ``cot``, jitted as one program (the
    interpret-mode kernels run three times faster so than op by op)."""
    @jax.jit
    def run(q, k, v, jm, cot):
        out, vjp = jax.vjp(lambda *a: fn(*a, jm), q, k, v)
        return out, vjp(cot)

    jm = None if mask is None else jnp.asarray(mask)
    out, grads = run(*map(jnp.asarray, (q, k, v)), jm, jnp.asarray(cot))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind,is_self", CASES)
def test_plain_attention_matches_jax(B, H, Lq, Lk, D, kind, is_self):
    """Forward and dq, dk, dv against the Pallas kernel (interpret mode)
    and the XLA path, on live rows; under is_self the cotangent is zero on
    dead rows, as in the models."""
    q, k, v, mask, cot = _inputs(B, H, Lq, Lk, D, kind, seed=Lq + Lk + B)
    live = _live_rows(mask, is_self, B, Lq)
    cot = cot * live[:, :, None, None]
    out, grads = _torch_run(q, k, v, mask, cot, is_self)
    pallas = lambda *a: pallas_masked_attention(*a, SCALE, is_self=is_self)
    xla = lambda *a: masked_softmax_attention(*a, SCALE)
    for fn in (pallas, xla):
        want, want_grads = _jax_run(fn, q, k, v, mask, cot)
        np.testing.assert_allclose(out[live], want[live], **FWD_TOL)
        for g, w, name in zip(grads, want_grads, "qkv"):
            np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD_TOL)


def test_all_masked_sample_attends_uniformly():
    """Every key masked: the uniform average of v over the Lk keys, and dv
    takes the uniform probabilities (tests/test_kernels.py:43-53)."""
    q, k, v, _, cot = _inputs(2, 2, 24, 40, 32, "none", seed=5)
    mask = np.ones((2, 40), bool)
    out, (dq, dk, dv) = _torch_run(q, k, v, mask, cot, False)
    np.testing.assert_allclose(
        out, np.broadcast_to(v.mean(1, keepdims=True), out.shape), **FWD_TOL)
    np.testing.assert_allclose(
        dv, np.broadcast_to(cot.sum(1, keepdims=True) / 40, dv.shape),
        **FWD_TOL)
    assert not dq.any() and not dk.any()


def test_ops_attention_takes_the_plain_version_on_the_cpu():
    q, k, v, mask, _ = _inputs(2, 2, 24, 128, 32, "tail", seed=6)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    tm = torch.from_numpy(mask)
    ops.reset_launches()
    assert torch.equal(ops.attention(*args, tm, SCALE),
                       torch_masked_attention(*args, tm, SCALE))
    assert not any(ops.launches.values())


@pytest.mark.parametrize("requires_grad", [False, True])
def test_cuda_wrapper_refuses_cpu_tensors(requires_grad):
    q, k, v, mask, _ = _inputs(2, 2, 24, 128, 32, "tail", seed=7)
    args = [torch.from_numpy(a).requires_grad_(requires_grad)
            for a in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_masked_attention(*args, torch.from_numpy(mask), SCALE)
