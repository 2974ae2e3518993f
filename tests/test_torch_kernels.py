"""The port's plain kernel versions (torch_umse, torch_attn_block,
torch_ffn) against the JAX package's oracles (xla_*) and its Pallas
kernels (interpret mode on the CPU), on the same numpy inputs, plus the
dispatch and build plumbing the CPU reaches; the umse backward's closed
form (torch_umse_bwd) against jax.vjp of the Pallas kernel and autograd
of torch_umse. The CUDA kernels themselves are held against these plain
versions on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.attention import _block_sizes
from medical_tri_modal_pilot_tpu.kernels.attn_block import (
    pallas_attn_block, xla_attn_block)
from medical_tri_modal_pilot_tpu.kernels.ffn import pallas_ffn, xla_ffn
from medical_tri_modal_pilot_tpu.kernels.umse import pallas_umse, xla_umse
import medical_tri_modal_pilot_tpu_torch
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.kernels import _build
from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
    cuda_attn_block, key_ends, torch_attn_block)
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import cuda_ffn, torch_ffn
from medical_tri_modal_pilot_tpu_torch.kernels.umse import (
    cuda_umse, torch_umse, torch_umse_bwd)

JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}
# fp32: the same math summed in another order, 1e-5 on O(1) values.
# bf16: both sides round to bf16 at the same points, so most elements agree
# exactly; a different summation order can move one rounding by a unit in
# the last place, 2**-8 relative (2**-6 absolute below 4).
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
       "bf16": dict(atol=2 ** -6, rtol=2 ** -7)}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------- umse

def _umse_args(B=3, L=77, D=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-24, 0, (B, L)), rng.uniform(0, 1, (B, L)),
                  rng.integers(0, 20, (B, L))], axis=-1).astype(np.float32)
    vec = lambda s, m=0.0: (m + s * rng.standard_normal(D)).astype(np.float32)
    return (x, vec(1.0)[None], vec(.1), vec(.1, 1.0), vec(.1),
            vec(1.0)[None], vec(.1), vec(.1, 1.0), vec(.1),
            rng.standard_normal((20, D)).astype(np.float32))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_umse_plain_matches_jax(prec):
    """Odd L: the Pallas kernel pads rows to its 1024-row block."""
    args = _umse_args()
    want = _f32(xla_umse(*map(jnp.asarray, args), JDT[prec]))
    kern = _f32(pallas_umse(*map(jnp.asarray, args), JDT[prec]))
    got = _f32(torch_umse(*map(torch.from_numpy, args), TDT[prec]))
    np.testing.assert_allclose(got, want, **TOL[prec])
    np.testing.assert_allclose(got, kern, **TOL[prec])


def _umse_grad_args(prec, seed=0):
    """Odd L (the Pallas kernel pads rows to its 1024-row block), ids 20 and
    23 past the table's end (they embed as zeros, and JAX's gather VJP drops
    them as torch's one-hot product does) and a cotangent in the dtype."""
    args = list(_umse_args(seed=seed))
    x = args[0].copy()
    x[0, 5, 2], x[2, 70, 2] = 20, 23
    dout = np.random.default_rng(seed + 1).standard_normal(
        x.shape[:2] + (args[1].shape[1],)).astype(np.float32)
    dout = _f32(torch.from_numpy(dout).to(TDT[prec]))
    return [x] + args[1:], dout


# The umse gradients, sums over the 231 rows of values of O(1): fp32 and
# the bf16 scale, bias and table gradients (fp32 sums of fp32 terms on
# every side) elementwise at TOL. bf16 dW and db (indices 0, 1, 4, 5): JAX
# and autograd of torch_umse round each dh * x product and the row sum to
# bf16 (JAX on the CPU also accumulates in bf16: 1.2 % of db's largest
# entry here), where torch_umse_bwd, like the kernel, sums in fp32. Those
# are held per tensor by |got - want|_F / |want|_F, as chip_smoke.py holds
# bf16 gradients, within 2**-5 (measured: 1.1e-2 against JAX, 2.2e-3
# against autograd).
UMSE_AFFINE = (0, 1, 4, 5)
UMSE_AFFINE_FRO = 2 ** -5


def _assert_umse_grads(got, want, prec):
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        g, w = _f32(g), _f32(w)
        if prec == "bf16" and i in UMSE_AFFINE:
            ratio = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert ratio <= UMSE_AFFINE_FRO, (i, ratio)
        else:
            np.testing.assert_allclose(g, w, **TOL[prec])


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_umse_bwd_matches_jax(prec):
    """torch_umse_bwd against jax.vjp of pallas_umse (interpret mode; its
    custom VJP differentiates xla_umse) for the nine parameters."""
    args, dout = _umse_grad_args(prec)
    jx, *jparams = map(jnp.asarray, args)
    _, vjp = jax.vjp(lambda *p: pallas_umse(jx, *p, JDT[prec]), *jparams)
    want = vjp(jnp.asarray(dout, JDT[prec]))
    got = torch_umse_bwd(*map(torch.from_numpy, args),
                         torch.from_numpy(dout).to(TDT[prec]), TDT[prec])
    _assert_umse_grads(got, want, prec)


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_umse_bwd_matches_autograd(prec):
    """torch_umse_bwd against autograd of torch_umse, the CPU path's
    gradient, on the same inputs."""
    args, dout = _umse_grad_args(prec, seed=3)
    x, *params = map(torch.from_numpy, args)
    leaves = [p.clone().requires_grad_(True) for p in params]
    cot = torch.from_numpy(dout).to(TDT[prec])
    want = torch.autograd.grad(torch_umse(x, *leaves, TDT[prec]), leaves,
                               cot)
    _assert_umse_grads(torch_umse_bwd(x, *params, cot, TDT[prec]), want,
                       prec)


# ---------------------------------------------------------- attn_block

def _attn_args(B, L, C, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    gamma = (1 + .1 * rng.standard_normal(C)).astype(np.float32)
    beta = (.1 * rng.standard_normal(C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    b = (.1 * rng.standard_normal(3 * C)).astype(np.float32)
    # sample 0 has every key masked (the txt length==3 -> 0 rule)
    lengths = np.linspace(0, L, B).astype(np.int32)
    mask = np.arange(L)[None, :] >= lengths[:, None]
    return x, gamma, beta, w, b, mask, lengths


def _pallas_live_rows(lengths, L):
    """Rows inside the Pallas kernel's live q blocks; it emits the pure
    residual past them. An all-masked sample keeps every block."""
    bq, _ = _block_sizes(L, L)
    live = np.zeros((len(lengths), L), bool)
    for i, n in enumerate(lengths):
        live[i, :L if n == 0 else min(L, ((n - 1) // bq + 1) * bq)] = True
    return live


# single-block streams (txt geometry) at two head counts, H*D == C
@pytest.mark.parametrize("B,L,C,H", [(3, 54, 64, 2), (3, 130, 64, 4)])
@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_attn_block_plain_matches_jax(B, L, C, H, prec):
    x, gamma, beta, w, b, mask, lengths = _attn_args(B, L, C)
    scale = float(np.sqrt(C // H))
    jx = jnp.asarray(x, JDT[prec])
    jw, jb = jnp.asarray(w, JDT[prec]), jnp.asarray(b, JDT[prec])
    jm = jnp.asarray(mask)
    want = _f32(xla_attn_block(jx, gamma, beta, jw, jb, jm, scale, H))
    kern = _f32(pallas_attn_block(jx, gamma, beta, jw, jb, jm, scale, H))
    t = lambda a: torch.from_numpy(_f32(a))
    got = _f32(torch_attn_block(
        t(jx).to(TDT[prec]), torch.from_numpy(gamma),
        torch.from_numpy(beta), t(jw).to(TDT[prec]), t(jb).to(TDT[prec]),
        torch.from_numpy(mask), scale, H))
    np.testing.assert_allclose(got, want, **TOL[prec])
    live = _pallas_live_rows(lengths, L)
    np.testing.assert_allclose(got[live], kern[live], **TOL[prec])


def test_attn_block_plain_no_mask():
    x, gamma, beta, w, b, _, _ = _attn_args(2, 40, 64, seed=1)
    want = _f32(xla_attn_block(*map(jnp.asarray, (x, gamma, beta, w, b)),
                               None, 4.0, 4))
    got = _f32(torch_attn_block(*map(torch.from_numpy,
                                     (x, gamma, beta, w, b)), None, 4.0, 4))
    np.testing.assert_allclose(got, want, **TOL["fp32"])


def test_key_ends():
    mask = torch.tensor([[1, 1, 1, 1], [0, 0, 1, 1], [0, 1, 0, 1],
                         [0, 0, 0, 0]], dtype=torch.bool)
    assert key_ends(mask).tolist() == [4, 2, 3, 4]


# ----------------------------------------------------------------- ffn

def _ffn_args(R=70, C=64, F=256, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda s, *shape: (s * rng.standard_normal(shape)).astype(np.float32)
    return (n(1, 2, R, C), (1 + n(.1, C)).astype(np.float32), n(.1, C),
            n(.05, C, F), n(.01, F), n(.05, F, C), n(.01, C))


@pytest.mark.parametrize("prec", ["fp32", "bf16"])
def test_ffn_plain_matches_jax(prec):
    x, *ws = _ffn_args()
    jx = jnp.asarray(x, JDT[prec])
    jws = [jnp.asarray(a) for a in ws]
    want = _f32(xla_ffn(jx, *jws, p=0.1, deterministic=True, seed=None))
    kern = _f32(pallas_ffn(jx, *jws, p=0.1, deterministic=True, seed=None))
    got = _f32(torch_ffn(torch.from_numpy(_f32(jx)).to(TDT[prec]),
                         *map(torch.from_numpy, ws)))
    np.testing.assert_allclose(got, want, **TOL[prec])
    np.testing.assert_allclose(got, kern, **TOL[prec])


def test_ffn_plain_matches_row_skipping_kernel():
    """Against the Pallas kernel with the JAX package's 256-row skip flags
    (sample 0 fully masked keeps every block), on the rows it computes;
    skipped blocks hold the residual there."""
    from medical_tri_modal_pilot_tpu.models.modules import _ffn_row_blocks
    x, *ws = _ffn_args(R=512)
    x = np.concatenate([x, x[:1]])                       # [3, 512, 64]
    mask = np.arange(512)[None, :] >= np.array([0, 100, 300])[:, None]
    flags = _ffn_row_blocks(jnp.asarray(x), jnp.asarray(mask))
    assert np.asarray(flags).tolist() == [[True, True], [True, False],
                                          [True, True]]
    kern = _f32(pallas_ffn(jnp.asarray(x), *map(jnp.asarray, ws), p=0.1,
                           deterministic=True, seed=None, block_valid=flags))
    got = _f32(torch_ffn(*map(torch.from_numpy, (x, *ws))))
    live = np.repeat(np.asarray(flags), 256, axis=1)
    np.testing.assert_allclose(got[live], kern[live], **TOL["fp32"])
    np.testing.assert_array_equal(kern[~live], x[~live])


# ------------------------------------------------------------ dispatch

def test_cpu_tensors_take_the_plain_versions():
    ops.reset_launches()
    args = [torch.from_numpy(a) for a in _umse_args(2, 9, 32)]
    assert torch.equal(ops.umse(*args, torch.float32),
                       torch_umse(*args, torch.float32))
    x, gamma, beta, w, b, mask, _ = map(torch.as_tensor, _attn_args(2, 20, 64))
    assert torch.equal(ops.attn_block(x, gamma, beta, w, b, mask, 4.0, 4),
                       torch_attn_block(x, gamma, beta, w, b, mask, 4.0, 4))
    fargs = [torch.from_numpy(a) for a in _ffn_args(R=8)]
    assert torch.equal(ops.ffn(*fargs), torch_ffn(*fargs))
    assert tuple(ops.launches) == ops.KERNELS
    assert not any(ops.launches.values())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA or raises; it never computes on the CPU."""
    x, gamma, beta, w, b, mask, _ = map(torch.as_tensor, _attn_args(2, 20, 64))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attn_block(x, gamma, beta, w, b, mask, 4.0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ffn(*[torch.from_numpy(a) for a in _ffn_args(R=8)])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_umse(*[torch.from_numpy(a) for a in _umse_args(2, 9, 32)],
                  torch.float32)


def test_kernel_wrappers_are_forward_only():
    """No kernel is forward only now: the wrappers take inputs that need a
    gradient (through their autograd Functions; the Swin kernels' for the
    trainable trunk) and still refuse CPU tensors."""
    x, gamma, beta, w, b, mask, _ = map(torch.as_tensor, _attn_args(2, 20, 64))
    x.requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attn_block(x, gamma, beta, w, b, mask, 4.0, 4)
    fargs = [torch.from_numpy(a) for a in _ffn_args(R=8)]
    fargs[0].requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_ffn(*fargs)
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import \
        cuda_swin_mlp
    with pytest.raises(ValueError, match="CUDA"):
        cuda_swin_mlp(x.reshape(-1, 64), gamma, beta, w[:, :256], b[:256],
                      w[:, :256].t(), gamma)


def test_unknown_device_raises():
    x = torch.empty(2, 4, 64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.ffn(x, *(torch.empty(1) for _ in range(6)))


def test_reference_path_is_scoped():
    assert not ops._reference
    with pytest.raises(KeyError):
        with ops.reference_path():
            assert ops._reference
            raise KeyError("leave the block")
    assert not ops._reference


def test_build_directory_follows_the_package_not_the_cwd():
    """tests/conftest.py runs every test in a tmpdir; the kernel library
    must still resolve under the checkout."""
    root = Path(medical_tri_modal_pilot_tpu_torch.__file__).resolve().parent
    path = _build.library_path()
    assert path.parent == root.parent / "build" / "torch_kernels"
    assert path.name.startswith("libmtp_kernels-") and path.suffix == ".so"
    assert path == _build.library_path()       # content hash is stable
