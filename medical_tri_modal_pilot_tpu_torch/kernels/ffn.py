"""Fused pre-norm FFN block, ``x + drop(W2 drop(relu(W1 StdLN(x) + b1)) +
b2)``: the plain PyTorch version and the CUDA kernels (``csrc/ffn.cu``):
the forward with in-kernel dropout, its backward (a tile pass, then the
weight sums of ``csrc/wgrad.cu`` over the live tiles' rows), and the
dropout masks (``csrc/dropout.cu``). Forward and tile pass take one of
two routes (``ffn_route``): bf16 on the tensor cores (the forward on the
tile loop of ``csrc/mlp_tc.cuh``), fp32 (the checking dtype) on FMA
loops. At C = 512, past what the fused tiles hold, each dtype takes its
split route (``csrc/ffn_split.cu``: StdLN, fc1, fc2 as separate launches
through [R, C] and [R, F] scratches; the backward's tile pass likewise),
with the same Philox masks and roundings.

Counterpart of medical_tri_modal_pilot_tpu/kernels/ffn.py (``xla_ffn``,
``pallas_ffn`` and ``dropout_masks``). Weights are in the JAX layout: w1
[C, F], w2 [F, C].

Dropout keeps an element with the Philox4x32-10 draw keyed by the seed and
the element's (row, column) in the flattened [R, F] hidden and [R, C]
output (``plain_dropout_masks``, the kernels' ``dropout_keep``). The TPU
kernel's masks come from the TPU's own generator and cannot be matched.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._util import count, dtype_code, needs_grad, stream
from .wgrad import col_sum, wgrad

LN_EPS = 1e-6
VAR_FLOOR = 1e-24
# rows per row flag: the granularity of ``block_valid`` (the FMA kernels'
# tile and the backward's)
BLOCK_R = 64
# the widths the kernels are built for: the fused routes up to 256, the
# split routes (csrc/ffn_split.cu) at SPLIT_WIDTH
WIDTHS = (64, 128, 256, 512)
SPLIT_WIDTH = 512
# the kernels of the split route's LN backward in the order of the C
# entry ffn_split_smem
SPLIT_KERNELS = ("ffn_ln_bwd_tc_kernel", "ffn_ln_bwd_kernel")
# rows per tile of the tensor-core forward (csrc/mlp_tc.cuh kMlpRows)
TC_ROWS = 128

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def ln_f32(xf, gamma, beta):
    """StdLayerNorm as the TPU kernels compute it (kernels/ffn.py _ln_f32):
    Bessel variance, eps added to the std, multiply by its reciprocal."""
    n = xf.shape[-1]
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).sum(dim=-1, keepdim=True) / (n - 1)
    c = 1.0 / (torch.sqrt(var.clamp_min(VAR_FLOOR)) + LN_EPS)
    return (xf - mu) * c * gamma + beta


def keep_threshold(p: float) -> int:
    """Keep when the 32-bit draw is below floor(q * 2^32), q = 1 - p (the
    TPU kernel's rule, kernels/ffn.py _keep_mask)."""
    return min(int((1.0 - p) * 4294967296.0), 4294967295)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for int64 tensors a < 2^32 and a
    32-bit constant m, without leaving int64."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16)
    s = (u & 0xFFFF) * 65536 + t
    return (u >> 16) + (s >> 32), s & _MASK32


def philox4x32_10(c0, c1, c2, seed: int):
    """The four words of Philox4x32-10 at counters (c0, c1, c2, 0) (int64
    tensors holding 32-bit values) under the key (seed low, seed high)."""
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    c = [c0, c1, c2, torch.zeros_like(c0)]
    for _ in range(10):
        hi0, lo0 = _mulhilo(c[0], _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c[2], _PHILOX_M[1])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
        k0 = (k0 + _PHILOX_W[0]) & _MASK32
        k1 = (k1 + _PHILOX_W[1]) & _MASK32
    return c


def _keep(R: int, N: int, m: int, seed: int, thr: int, device,
          col0: int = 0):
    lo, hi = col0 // 4, -(-(col0 + N) // 4)
    c0 = torch.arange(lo, hi, dtype=torch.int64, device=device)[None, :]
    c1 = torch.arange(R, dtype=torch.int64, device=device)[:, None]
    c0, c1 = torch.broadcast_tensors(c0, c1)
    words = philox4x32_10(c0, c1, torch.full_like(c0, m), seed)
    bits = torch.stack(words, dim=-1).reshape(R, 4 * (hi - lo))
    return bits[:, col0 - 4 * lo:col0 - 4 * lo + N] < thr


def plain_dropout_masks(R: int, F: int, C: int, seed: int, p: float,
                        device=None, col0: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keep masks (bool [R, F] hidden, [R, C] output) that the kernels
    draw for ``seed``: element (r, c) of mask m is word c % 4 of Philox at
    counter (c // 4, r, m, 0), kept below ``keep_threshold(p)``. ``col0``:
    the hidden mask holds columns col0 .. col0 + F of the whole one (a
    rank's share of d_ff under tensor parallelism; 0 for the kernels')."""
    thr = keep_threshold(p)
    return (_keep(R, F, 0, seed, thr, device, col0),
            _keep(R, C, 1, seed, thr, device))


def ffn_route(dtype: torch.dtype, C: int) -> str:
    """The kernel route for x of this dtype and width: bf16 takes the
    tensor cores ("tc"); fp32, the checking dtype, keeps the FMA kernels
    ("fma"), whose products stay in full fp32; at SPLIT_WIDTH the dtype's
    split route ("tc_split", "fma_split"). Raises for a width no kernel is
    built for."""
    if C not in WIDTHS:
        raise ValueError(f"the CUDA ffn kernels take C in {WIDTHS}, got "
                         f"C={C}")
    route = "tc" if dtype == torch.bfloat16 else "fma"
    return route + "_split" if C == SPLIT_WIDTH else route


def _tile(rows, width):
    return 2 * rows * (width + 8)


def tc_smem_bytes(C: int) -> int:
    """Shared memory of the fused tensor-core forward at width C, as
    csrc/mlp_tc.cuh::MlpTc reckons it: bf16 tiles of pitch width + 8, the
    normalised rows [128][C] and a two-stage ring of a W1 chunk [C][64]
    and a W2 chunk [64][C] (a stage at least [128][C]: it takes the
    tile's x for the epilogue), then b2 in fp32."""
    stage = max(_tile(C, 64) + _tile(64, C), _tile(TC_ROWS, C))
    return _tile(TC_ROWS, C) + 2 * stage + 4 * C


def bwd_tc_smem_bytes(C: int) -> int:
    """Shared memory of the fused tensor-core tile pass at width C
    (csrc/ffn.cu FfnBwdTc): LN and dz [64][C], a two-stage ring of a W1
    chunk [C][64] and a W2 chunk [64][C], dh and h_d chunks [64][64], the
    StdLN stats fp32 [4][64]."""
    ring = 2 * (_tile(C, 64) + _tile(64, C))
    return 2 * _tile(64, C) + ring + 2 * _tile(64, 64) + 4 * 4 * 64


def split_smem_bytes() -> dict:
    """Shared memory of the split route's LN backward at SPLIT_WIDTH, the
    route's only kernels with more than the static 48 KB: the tensor
    cores' (csrc/proj_tc.cuh proj_bwd_tile: x [64][C], a three-stage ring
    of a dh chunk [64][32] and a W1 chunk [C][32], fp32 stats [4][64]) and
    the FMAs' (fp32: the StdLN rows [64][C + 1], a dh slice [64][33], a W1
    slice [32][C], the stats)."""
    C = SPLIT_WIDTH
    tc = _tile(64, C) + 3 * (_tile(64, 32) + _tile(C, 32)) + 4 * 4 * 64
    fma = 4 * (64 * (C + 1) + 64 * 33 + 32 * C + 4 * 64)
    return dict(zip(SPLIT_KERNELS, (tc, fma)))


def tc_min_blocks(C: int) -> dict:
    """Blocks an SM that the bf16 kernels' launch bounds ask for at width
    C: the fused forward two up to C = 96 (csrc/ffn.cu: C <= 96 ? 2 : 1),
    the fused tile pass one; the split route's LN backward one (csrc/
    proj_tc.cuh proj_bwd_min_blocks at 512), its GEMMs none (1). The card
    tests hold this to the C entries ffn_tc_min_blocks and
    ffn_split_min_blocks."""
    if C == SPLIT_WIDTH:
        return {"gemm_bf16_kernel": 1, "ffn_ln_bwd_tc_kernel": 1}
    return {"ffn_fwd_tc_kernel": 2 if C <= 96 else 1,
            "ffn_bwd_tc_kernel": 1}


def torch_ffn(x, gamma, beta, w1, b1, w2, b2,
              block_valid: Optional[torch.Tensor] = None,
              keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              p: float = 0.0) -> torch.Tensor:
    """Every row computed (``block_valid`` is accepted and ignored, as in
    xla_ffn); products accumulate in fp32 and round to ``x.dtype`` where
    the TPU kernel rounds. ``keep``: the two keep masks ([R, F], [R, C],
    R = rows of x) for dropout at rate ``p``; kept values are divided by
    q = 1 - p in ``x.dtype``."""
    del block_valid
    dt = x.dtype
    ln = ln_f32(x.float(), gamma.float(), beta.float()).to(dt)
    h = torch.relu(ln @ w1.to(dt) + b1.to(dt))
    if keep is not None:
        q = torch.tensor(1.0 - p, dtype=dt, device=x.device)
        h = torch.where(keep[0].reshape(h.shape), h / q, 0.0)
    z = h @ w2.to(dt) + b2.to(dt)
    if keep is not None:
        z = torch.where(keep[1].reshape(z.shape), z / q, 0.0)
    return x + z


def _check(x, w1, w2, block_valid):
    """Refuses, before anything reaches the card, what the kernels do not
    take: dtype, width (``ffn_route``), d_ff, weight shapes, flag count,
    then a device that is not CUDA."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ffn takes fp32 or bf16, got {x.dtype}")
    C = x.shape[-1]
    F = w1.shape[-1]
    R = x.numel() // C
    ffn_route(x.dtype, C)
    if F <= 0 or F % 64 != 0:
        raise ValueError(f"ffn takes d_ff % 64 == 0, got d_ff={F}")
    if tuple(w1.shape) != (C, F) or tuple(w2.shape) != (F, C):
        raise ValueError(f"ffn weights must be [{C}, {F}] and [{F}, {C}], "
                         f"got {tuple(w1.shape)}, {tuple(w2.shape)}")
    n_tiles = -(-R // BLOCK_R)
    if block_valid is not None and block_valid.numel() != n_tiles:
        raise ValueError(f"block_valid has {block_valid.numel()} flags "
                         f"for {n_tiles} tiles of {BLOCK_R} rows")
    if x.device.type != "cuda":
        raise ValueError(f"cuda_ffn needs CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("ffn needs a contiguous x")
    valid = None
    if block_valid is not None:
        valid = block_valid.reshape(-1).to(device=x.device,
                                           dtype=torch.int8).contiguous()
    return R, C, F, valid


def _operands(x, gamma, beta, *ws):
    dt = x.dtype
    ws = [t.to(dt).contiguous() for t in ws]
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    for t in (*ws, gamma, beta):
        if t.device != x.device:
            raise ValueError(f"ffn operands on {t.device}, x on {x.device}")
    return gamma, beta, ws


def _dropout_args(p: float, seed: Optional[int], dt):
    """(seed, thr, q in dt, q in fp32, on) for the C entry points."""
    if p <= 0.0:
        return 0, 0, 1.0, 1.0, 0
    if seed is None:
        raise ValueError("ffn dropout needs a seed")
    q = 1.0 - p
    q_t = float(torch.tensor(q, dtype=dt).float())
    q_f = float(torch.tensor(q, dtype=torch.float32))
    return int(seed) & (2 ** 64 - 1), keep_threshold(p), q_t, q_f, 1


def _launch_fwd(x, gamma, beta, w1, b1, w2, b2, block_valid, p, seed):
    R, C, F, valid = _check(x, w1, w2, block_valid)
    gamma, beta, (w1, b1, w2, b2) = _operands(x, gamma, beta, w1, b1, w2, b2)
    s, thr, q_t, _, on = _dropout_args(p, seed, x.dtype)
    y = torch.empty_like(x)
    args = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if valid is None else valid.data_ptr())
    tail = (R, C, F, s, thr, q_t, on, dtype_code(x.dtype), stream(x))
    if C == SPLIT_WIDTH:
        # the split route's scratches: the StdLN rows and the hidden layer
        ln = torch.empty(R, C, dtype=x.dtype, device=x.device)
        hidden = torch.empty(R, F, dtype=x.dtype, device=x.device)
        rc = _build.library().ffn_split_fwd(
            *args, ln.data_ptr(), hidden.data_ptr(), y.data_ptr(), *tail)
    else:
        rc = _build.library().ffn_fwd(*args, y.data_ptr(), *tail)
    _build.check(rc, "ffn")
    count("ffn")
    return y


def ffn_bwd_tiles(x, gamma, beta, w1, b1, w2, block_valid, p, seed, dy):
    """The backward's tile pass (fp32 FMAs, or the tensor cores for bf16;
    at SPLIT_WIDTH the split route's launches): (dx, ln, dz, hd, dh,
    gpart, valid). ln, dz [R, C] and hd, dh [R, F] are
    the weight sums' operands, written on the rows of live tiles only;
    gpart fp32 [tiles, 2C] the tiles' dgamma | dbeta sums; valid the int8
    tile flags (None: every tile live)."""
    R, C, F, valid = _check(x, w1, w2, block_valid)
    dt = x.dtype
    gamma, beta, (w1, b1, w2) = _operands(x, gamma, beta, w1, b1, w2)
    s, thr, q_t, q_f, on = _dropout_args(p, seed, dt)
    dy = dy.to(dt).contiguous()
    dev = x.device
    dx = torch.empty_like(x)
    ln, dz = (torch.empty(R, C, dtype=dt, device=dev) for _ in range(2))
    hd, dh = (torch.empty(R, F, dtype=dt, device=dev) for _ in range(2))
    gpart = torch.empty(-(-R // BLOCK_R), 2 * C, dtype=torch.float32,
                        device=dev)
    lib = _build.library()
    entry = lib.ffn_split_bwd if C == SPLIT_WIDTH else lib.ffn_bwd
    rc = entry(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(),
        None if valid is None else valid.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ln.data_ptr(), dz.data_ptr(), hd.data_ptr(),
        dh.data_ptr(), gpart.data_ptr(), R, C, F, s, thr, q_t, q_f, on,
        dtype_code(dt), stream(x))
    _build.check(rc, "ffn_bwd")
    return dx, ln, dz, hd, dh, gpart, valid


def ffn_weight_sums(ln, dz, hd, dh, valid):
    """(dw1, db1, dw2, db2) in fp32 from the tile pass's operands, over the
    rows of live tiles (the tile flags cover BLOCK_R rows each)."""
    dw1, db1 = wgrad(ln, dh, valid, BLOCK_R)
    dw2, db2 = wgrad(hd, dz, valid, BLOCK_R)
    return dw1, db1, dw2, db2


def cuda_ffn_bwd(x, gamma, beta, w1, b1, w2, b2, block_valid, p, seed, dy):
    """The backward kernel: (dx, dgamma, dbeta, dw1, db1, dw2, db2), each
    parameter gradient in its parameter's dtype, summed in fp32 over the
    rows of live tiles. Recomputes StdLN and the hidden layer and
    regenerates the masks; a skipped tile gives dx = dy and adds
    nothing."""
    dx, ln, dz, hd, dh, gpart, valid = ffn_bwd_tiles(
        x, gamma, beta, w1, b1, w2, block_valid, p, seed, dy)
    dw1, db1, dw2, db2 = ffn_weight_sums(ln, dz, hd, dh, valid)
    C = x.shape[-1]
    g = col_sum(gpart)
    count("ffn_bwd")
    return (dx, g[:C].to(gamma.dtype), g[C:].to(beta.dtype),
            dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


class _FFN(torch.autograd.Function):
    """Forward kernel; the backward kernel as its gradient. Saves x and the
    seed, not the hidden layer."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, block_valid, p, seed):
        ctx.save_for_backward(x, gamma, beta, w1, b1, w2, b2)
        ctx.block_valid, ctx.p, ctx.seed = block_valid, p, seed
        return _launch_fwd(x, gamma, beta, w1, b1, w2, b2, block_valid, p,
                           seed)

    @staticmethod
    def backward(ctx, dy):
        grads = cuda_ffn_bwd(*ctx.saved_tensors, ctx.block_valid, ctx.p,
                             ctx.seed, dy)
        return (*grads, None, None, None)


def cuda_ffn(x, gamma, beta, w1, b1, w2, b2,
             block_valid: Optional[torch.Tensor] = None, p: float = 0.0,
             seed: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors, through the autograd Function
    when a gradient is needed. ``block_valid``: optional flags, one per
    BLOCK_R consecutive rows of x flattened to [R, C] (any leading shape,
    row order); a 0 tile passes x through unchanged. ``p`` > 0: dropout on
    both masks drawn for ``seed``."""
    if needs_grad(x, gamma, beta, w1, b1, w2, b2):
        return _FFN.apply(x, gamma, beta, w1, b1, w2, b2, block_valid, p,
                          seed)
    return _launch_fwd(x, gamma, beta, w1, b1, w2, b2, block_valid, p, seed)


def cuda_dropout_masks(R: int, F: int, C: int, seed: int, p: float,
                       device, col0: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' keep masks for ``seed``, drawn on the card in one launch
    straight into bool [R, F] and [R, C] (``csrc/dropout.cu``); the hidden
    one from column ``col0`` on, as plain_dropout_masks."""
    device = torch.device(device)
    if min(R, F, C, col0) < 0:
        raise ValueError(f"dropout_masks takes sizes and an offset >= 0, "
                         f"got R={R} F={F} C={C} col0={col0}")
    if device.type != "cuda":
        raise ValueError(f"cuda_dropout_masks needs a CUDA device, got "
                         f"{device}")
    k1 = torch.empty(R, F, dtype=torch.bool, device=device)
    k2 = torch.empty(R, C, dtype=torch.bool, device=device)
    if R * (F + C) == 0:
        return k1, k2
    rc = _build.library().dropout_masks(
        k1.data_ptr(), k2.data_ptr(), R, F, C, int(col0),
        int(seed) & (2 ** 64 - 1), keep_threshold(p), stream(k1))
    _build.check(rc, "dropout_masks")
    count("dropout_masks")
    return k1, k2
