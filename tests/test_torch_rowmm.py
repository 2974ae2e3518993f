"""The plain row-skipping projections of the port (kernels/rowmm.py)
against the JAX package's Pallas kernels in interpret mode
(``pallas_rowskip_affine`` and ``pallas_rowskip_ln_affine`` through their
custom VJPs), forward and every gradient, in fp32 and bf16, at the shape
cases of tests/test_rowmm_kernel.py: every row valid, a ragged row count,
dead 256-row blocks, and the LN-fused form. Compared on live rows, with
cotangents zero on dead blocks (the model's case: nothing reads a padding
row). Tolerances relative to each tensor's largest entry: fp32 1e-5 (the
same math summed in another order), bf16 2e-2 (a bf16 rounding, 2^-8, of
an intermediate flipping between the two)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.rowmm import (
    pallas_rowskip_affine, pallas_rowskip_ln_affine)
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import (
    BLOCK_R, block_flags, torch_rowskip_affine, torch_rowskip_ln_affine)

RTOL = {"fp32": 1e-5, "bf16": 2e-2}
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# (B, L, lengths or None): the cases of tests/test_rowmm_kernel.py
CASES = {"all_valid": (2, 512, None), "ragged": (1, 130, None),
         "block_skip": (4, 512, (100, 512, 300, 10)),
         "ln_fused": (2, 512, (200, 512))}


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max(initial=0.0)
    bound = rtol * np.abs(want).max(initial=0.0) + 1e-30
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def _inputs(case, ln, seed=0, Cin=64, Cout=192):
    B, L, lengths = CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *shape, m=0.0, s=1.0: rng.normal(m, s, shape).astype(
        np.float32)
    args = [f(B, L, Cin)]
    if ln:
        args += [f(Cin, m=1.0, s=.1), f(Cin, s=.1)]
    args += [f(Cin, Cout, s=.05), f(Cout, s=.01)]
    alive = np.ones((B, L), bool)
    flags = None
    if lengths is not None:
        alive = np.arange(L)[None] < np.asarray(lengths)[:, None]
        flags = alive.reshape(B, L // BLOCK_R, BLOCK_R).any(-1)
    cot = f(B, L, Cout) * alive[:, :, None]
    return args, flags, alive, cot


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
@pytest.mark.parametrize("case,ln", [("all_valid", False), ("ragged", False),
                                     ("block_skip", False),
                                     ("ragged", True), ("block_skip", True),
                                     ("ln_fused", True)])
def test_plain_rowmm_matches_the_jax_kernel(case, ln, prec):
    """Forward on live rows and the gradients of sum(out * cot) for every
    input. x, w and b in the compute dtype; gamma and beta fp32 (as the
    model hands them)."""
    args, flags, alive, cot = _inputs(case, ln)
    jdt, tdt = DT[prec]
    params = {0, 3, 4} if ln else {0, 1, 2}   # cast to the compute dtype
    jargs = [jnp.asarray(a, jdt if i in params else jnp.float32)
             for i, a in enumerate(args)]
    targs = [torch.tensor(a, dtype=tdt if i in params else torch.float32,
                          requires_grad=True) for i, a in enumerate(args)]
    jflags = None if flags is None else jnp.asarray(flags, jnp.int32)
    tflags = None if flags is None else torch.from_numpy(flags)

    def jfn(*a):
        if ln:
            return jnp.concatenate(pallas_rowskip_ln_affine(*a, jflags), -1)
        return pallas_rowskip_affine(*a, jflags)

    def tfn(*a):
        if ln:
            return torch.cat(torch_rowskip_ln_affine(*a, tflags), -1)
        return torch_rowskip_affine(*a, tflags)

    want, vjp = jax.vjp(jfn, *jargs)
    want_grads = vjp(jnp.asarray(cot, want.dtype))
    got = tfn(*targs)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    rtol = RTOL[prec]
    _close(got.detach().float().numpy()[alive],
           np.asarray(want.astype(jnp.float32))[alive], rtol, "out")
    names = (["x", "gamma", "beta", "w", "b"] if ln else ["x", "w", "b"])
    for t, g, name in zip(targs, want_grads, names):
        _close(t.grad.float().numpy(), np.asarray(g.astype(jnp.float32)),
               rtol, f"d{name}")
    if flags is not None and not flags.all():
        # the kernel's dead blocks are zeros; the plain version computes
        # them (they are never read)
        dead = ~np.repeat(flags, BLOCK_R, axis=1)
        assert np.all(np.asarray(want.astype(jnp.float32))[dead] == 0.0)


def test_block_flags_follow_the_jax_helper():
    """One flag per 256 rows: all live without flags (a ragged tail
    included), the given flags padded with dead blocks otherwise."""
    dev = torch.device("cpu")
    assert block_flags(130, None, dev).tolist() == [1]
    assert block_flags(513, None, dev).tolist() == [1, 1, 1]
    flags = torch.tensor([[True, False], [False, True]])
    assert block_flags(1024, flags, dev).tolist() == [1, 0, 0, 1]
    assert block_flags(1200, flags, dev).tolist() == [1, 0, 0, 1, 0]
    with pytest.raises(ValueError, match="flags"):
        block_flags(256, flags, dev)


def test_ops_take_the_plain_versions_on_the_cpu():
    """On CPU tensors ops.rowskip_* are the plain versions, launching
    nothing."""
    args, flags, _, _ = _inputs("block_skip", ln=True)
    t = [torch.from_numpy(a) for a in args]
    tf = torch.from_numpy(flags)
    ops.reset_launches()
    for got, want in zip(ops.rowskip_ln_affine(*t, tf),
                         torch_rowskip_ln_affine(*t, tf)):
        assert torch.equal(got, want)
    assert torch.equal(ops.rowskip_affine(t[0], t[3], t[4], tf),
                       torch_rowskip_affine(t[0], t[3], t[4]))
    assert all(v == 0 for v in ops.launches.values())
