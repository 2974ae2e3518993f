"""Row-block-skipped projections: ``x @ W + b`` and its LN-fused form
``StdLN(x) @ [Wq|Wk|Wv] + b`` split into its three projections, each
skipping the 256-row blocks that are all padding: the plain PyTorch versions
and the CUDA kernels (``csrc/rowmm.cu``), forward and backward, in two
routes (``rowmm_route``): bf16 on the tensor cores (``rowmm_tc_kernel``,
``rowmm_bwd_tc_kernel``, on the projection tile loops of
``csrc/proj_tc.cuh`` that the attention block runs too), fp32 (the checking
dtype) on FMA loops (``rowmm_kernel``, ``rowmm_bwd_kernel``).

Counterpart of medical_tri_modal_pilot_tpu/kernels/rowmm.py
(``pallas_rowskip_affine``, ``pallas_rowskip_ln_affine`` and their XLA
oracles). Weights in the JAX layout: w [Cin, Cout], b [Cout].
``block_valid``: int flags over BLOCK_R-row blocks of x flattened to
[R, Cin] in row order (any leading shape; None: every block live). On the
kernel path a dead block's outputs are zeros and it adds nothing to dW and
db; the plain versions compute every row, as the XLA oracles do. The two
agree on live rows, and on the gradients when the cotangent of the dead
rows is zero, as in the model (nothing reads a padding row).

The LN-fused form is the attention pre-norm and q|k|v projection of the
TIE stream under tensor parallelism (models/modules.py), where the fused
attention block is off.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._util import count, dtype_code, needs_grad, stream
from .ffn import ln_f32
from .wgrad import col_sum, wgrad

# rows per skip flag, as the TPU kernel's blocks (and the JAX package's
# FFN row blocks, modules.py:387-405); kBlockR in csrc/common.cuh
BLOCK_R = 256
# the input widths the kernels are built for
WIDTHS = (64, 256)
# the tensor-core kernels in the order of the C entry rowmm_tc_smem
TC_KERNELS = ("rowmm_tc_kernel", "rowmm_bwd_tc_kernel (LN)",
              "rowmm_bwd_tc_kernel (plain)")


def rowmm_route(dtype: torch.dtype, Cin: int) -> str:
    """The kernel route for x of this dtype and input width: bf16 takes the
    tensor cores ("tc"); fp32, the checking dtype, keeps the FMA kernels
    ("fma"), whose products stay in full fp32. Raises for a width or dtype
    no kernel is built for."""
    if Cin not in WIDTHS:
        raise ValueError(f"the rowmm kernels take Cin in {WIDTHS}; got "
                         f"Cin={Cin}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rowmm takes fp32 or bf16, got {dtype}")
    return "tc" if dtype == torch.bfloat16 else "fma"


def rowmm_tc_smem(Cin: int) -> dict:
    """Shared memory of each tensor-core kernel at input width Cin, as
    csrc/proj_tc.cuh reckons it (bf16 tiles of pitch width + 8): the
    forward's x [64][Cin] and a three-stage W ring [64][128] (each output
    chunk staged in the stage it has consumed); the backward's three-stage
    ring of a cotangent chunk [64][32] and a W chunk [Cin][32], plus, in
    the LN form, x [64][Cin] and the fp32 StdLN stats [4][64]."""
    def tile(rows, width):
        return 2 * rows * (width + 8)
    ring = 3 * (tile(64, 32) + tile(Cin, 32))
    return {TC_KERNELS[0]: tile(64, Cin) + 3 * tile(64, 128),
            TC_KERNELS[1]: tile(64, Cin) + ring + 4 * 4 * 64,
            TC_KERNELS[2]: ring}


def block_flags(R: int, block_valid: Optional[torch.Tensor],
                device) -> torch.Tensor:
    """int8 flags, one per BLOCK_R rows of R (rowmm.py _block_flags):
    ``block_valid`` flattened and padded with dead blocks, or every block
    live."""
    nb = -(-R // BLOCK_R)
    if block_valid is None:
        return torch.ones(nb, dtype=torch.int8, device=device)
    bv = block_valid.reshape(-1).to(device=device, dtype=torch.int8)
    if bv.numel() > nb:
        raise ValueError(f"block_valid has {bv.numel()} flags for {nb} "
                         f"blocks of {BLOCK_R} rows")
    if bv.numel() == nb:
        return bv
    return torch.cat([bv, bv.new_zeros(nb - bv.numel())])


def torch_rowskip_affine(x, w, b, block_valid=None) -> torch.Tensor:
    """x @ w + b in x's dtype over every row (xla_rowskip_affine;
    ``block_valid`` is accepted and ignored)."""
    del block_valid
    dt = x.dtype
    return x @ w.to(dt) + b.to(dt)


def torch_rowskip_ln_affine(x, gamma, beta, w, b, block_valid=None
                            ) -> Tuple[torch.Tensor, ...]:
    """(StdLN(x) @ w + b) split into thirds over every row
    (xla_rowskip_ln_affine): StdLN in fp32 rounded to x's dtype, the
    product and the bias in that dtype."""
    del block_valid
    dt = x.dtype
    ln = ln_f32(x.float(), gamma.float(), beta.float()).to(dt)
    y = ln @ w.to(dt) + b.to(dt)
    C = w.shape[1] // 3
    return y[..., :C], y[..., C:2 * C], y[..., 2 * C:]


def _check(x, w, ln: bool):
    """x flattened to [R, Cin]; raises on what the kernels do not take:
    dtype and shapes first (on any device), then the device."""
    Cin = x.shape[-1]
    rowmm_route(x.dtype, Cin)
    Cout = w.shape[-1]
    cs = Cout // 3 if ln else Cout
    if w.dim() != 2 or w.shape[0] != Cin:
        raise ValueError(f"rowmm takes Cin in {WIDTHS} and w [Cin, Cout]; "
                         f"got x {tuple(x.shape)}, w {tuple(w.shape)}")
    if Cout % 64 or (ln and (Cout % 3 or cs % 64)):
        raise ValueError(f"rowmm takes output widths that are multiples of "
                         f"64 (each third, in the LN form); got {Cout}")
    if x.device.type != "cuda":
        raise ValueError(f"the rowmm kernels need CUDA tensors, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("rowmm needs a contiguous x")
    return x.reshape(-1, Cin), cs


def _operands(x2, gamma, beta, w, b):
    dt = x2.dtype
    w, b = w.to(dt).contiguous(), b.to(dt).contiguous()
    if gamma is not None:
        gamma = gamma.to(torch.float32).contiguous()
        beta = beta.to(torch.float32).contiguous()
    for t in (w, b, gamma, beta):
        if t is not None and t.device != x2.device:
            raise ValueError(f"rowmm operands on {t.device}, x on "
                             f"{x2.device}")
    return gamma, beta, w, b


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(x2, gamma, beta, w, b, valid, cs: int):
    """The forward launch: three [R, cs] outputs in the LN form (gamma
    given), one [R, Cout] otherwise."""
    ln = gamma is not None
    R, Cin = x2.shape
    Cout = w.shape[1]
    gamma, beta, w, b = _operands(x2, gamma, beta, w, b)
    outs = [torch.empty(R, cs, dtype=x2.dtype, device=x2.device)
            for _ in range(3 if ln else 1)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    rc = _build.library().rowmm_fwd(
        x2.data_ptr(), _ptr(gamma), _ptr(beta), w.data_ptr(), b.data_ptr(),
        valid.data_ptr(), *ptrs, R, Cin, Cout, cs, int(ln),
        dtype_code(x2.dtype), stream(x2))
    name = "rowmm_ln" if ln else "rowmm"
    _build.check(rc, name)
    count(name)
    return outs


def cuda_rowmm_bwd(x2, gamma, beta, w, b, valid, dys):
    """The backward kernels on [R, Cin] x and the cotangents ``dys`` (q, k
    and v's in the LN form, gamma given; y's otherwise): (dx, dgamma,
    dbeta, dw, db) in the LN form, (dx, dw, db) otherwise. dW and db are
    summed in fp32 over the live rows, in one wgrad launch over every
    cotangent; dw is returned in w's dtype and db rounded to x's dtype
    (rowmm.py:321, :339), then to b's."""
    ln = gamma is not None
    R, Cin = x2.shape
    Cout = w.shape[1]
    cs = dys[0].shape[-1]
    dt = x2.dtype
    g_, be_, w_, _ = _operands(x2, gamma, beta, w, b)
    dys = [d.to(dt).contiguous() for d in dys]
    dev = x2.device
    dx = torch.empty_like(x2)
    ln_o = torch.empty_like(x2) if ln else None
    gpart = (torch.empty(-(-R // 64), 2 * Cin, dtype=torch.float32,
                         device=dev) if ln else None)
    ptrs = [d.data_ptr() for d in dys] + [None] * (3 - len(dys))
    rc = _build.library().rowmm_bwd(
        x2.data_ptr(), _ptr(g_), _ptr(be_), w_.data_ptr(), valid.data_ptr(),
        *ptrs, dx.data_ptr(), _ptr(ln_o), _ptr(gpart), R, Cin, Cout, cs,
        int(ln), dtype_code(dt), stream(x2))
    name = "rowmm_ln_bwd" if ln else "rowmm_bwd"
    _build.check(rc, name)
    dw, db = wgrad(ln_o if ln else x2, dys, valid, BLOCK_R)
    dw, db = dw.to(w.dtype), db.to(dt).to(b.dtype)
    count(name)
    if not ln:
        return dx, dw, db
    g = col_sum(gpart)
    return dx, g[:Cin].to(gamma.dtype), g[Cin:].to(beta.dtype), dw, db


class _RowmmLN(torch.autograd.Function):
    """The LN-fused forward kernel; the backward kernel as its gradient.
    Saves x and the parameters, not the StdLN rows (recomputed)."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w, b, valid, cs):
        ctx.save_for_backward(x2, gamma, beta, w, b, valid)
        return tuple(_launch_fwd(x2, gamma, beta, w, b, valid, cs))

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x2, gamma, beta, w, b, valid = ctx.saved_tensors
        grads = cuda_rowmm_bwd(x2, gamma, beta, w, b, valid, (dq, dk, dv))
        return (*grads, None, None)


class _Rowmm(torch.autograd.Function):
    """The plain forward kernel; the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x2, w, b, valid):
        ctx.save_for_backward(x2, w, b, valid)
        return _launch_fwd(x2, None, None, w, b, valid, w.shape[1])[0]

    @staticmethod
    def backward(ctx, dy):
        x2, w, b, valid = ctx.saved_tensors
        dx, dw, db = cuda_rowmm_bwd(x2, None, None, w, b, valid, (dy,))
        return dx, dw, db, None


def cuda_rowskip_ln_affine(x, gamma, beta, w, b,
                           block_valid: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, ...]:
    """Launch the LN-fused kernel on CUDA tensors, through the autograd
    Function when a gradient is needed: (q, k, v), each [..., Cout / 3],
    zeros in dead blocks."""
    x2, cs = _check(x, w, ln=True)
    valid = block_flags(x2.shape[0], block_valid, x.device)
    if needs_grad(x, gamma, beta, w, b):
        outs = _RowmmLN.apply(x2, gamma, beta, w, b, valid, cs)
    else:
        outs = _launch_fwd(x2, gamma, beta, w, b, valid, cs)
    return tuple(o.reshape(x.shape[:-1] + (cs,)) for o in outs)


def cuda_rowskip_affine(x, w, b, block_valid: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Launch the plain kernel on CUDA tensors, through the autograd
    Function when a gradient is needed: x @ w + b, zeros in dead blocks."""
    x2, cs = _check(x, w, ln=False)
    valid = block_flags(x2.shape[0], block_valid, x.device)
    if needs_grad(x, w, b):
        y = _Rowmm.apply(x2, w, b, valid)
    else:
        y = _launch_fwd(x2, None, None, w, b, valid, cs)[0]
    return y.reshape(x.shape[:-1] + (cs,))
