"""Fused pre-norm attention block, ``x + MHA(StdLN(x))``: the plain PyTorch
version and the CUDA kernels (``csrc/attn_block.cu``, the lean and training
forwards; ``csrc/attn_block_bwd.cu``, the backward), in two routes
(``attn_block_route``): bf16 on the tensor cores, fp32 (the checking dtype)
on FMA loops.

Counterpart of medical_tri_modal_pilot_tpu/kernels/attn_block.py
(``xla_attn_block`` and ``pallas_attn_block``). ``w``/``b`` are the
concatenated q|k|v projection weights [C, 3C] / [3C] in the JAX layout
([in, out]); ``scale`` is the score divisor sqrt(d_head).

The mask is None, a key mask [B, L] or a block mask [B, L, L] (the
multitoken MBT streams), True = masked; the kernels count the block form
apart (``attn_block_3d``, ``attn_block_3d_bwd``). A bool, int8 or uint8
mask on x's device is read as it is, one byte per entry (an int8 view, no
copy), which matters for the block form: the vslt stream's mask is
64 x 1016 x 1016 bytes, read by every layer. A block mask takes no
per-sample skipping of rows: every q tile and every key is live, as in the
TPU kernel (attn_block.py:219-227, :558-566). The bf16 route instead
skips the 64 x 64 (query, key) tiles whose every pair is masked and reads
no mask bytes in tiles with none masked, by a tile map built on the card
in each call (``block_tile_map``; the autograd Function keeps it for the
backward); the results are those of reading every tile.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._util import count, dtype_code, needs_grad, stream
from .attention import _BYTE_MASKS, HEAD_DIMS
from .attention import tc_min_blocks as flash_min_blocks
from .attention import tc_smem_bytes as flash_smem_bytes
from .rowmm import tc_min_blocks as proj_min_blocks
from .wgrad import col_sum, wgrad

# the model widths the kernels are built for, forward and backward
WIDTHS = (64, 128, 256, 512)
# a block mask's tile classes (csrc/flash_tc.cuh kTileDead, kTileFull,
# kTileMixed): every pair of the 64 x 64 tile masked, none, some
TILE_DEAD, TILE_FULL, TILE_MIXED = 0, 1, 2
# the C entry points' kernel numbers of the tensor-core route
# (attn_block_tc_smem)
TC_KERNELS = ("block_qkv_tc_kernel", "block_attn_tc_kernel",
              "block_dkv_tc_kernel", "block_dq_tc_kernel",
              "block_ln_bwd_tc_kernel")


def attn_block_route(dtype: torch.dtype, C: int, H: int) -> str:
    """The kernel route for x of this dtype, width C and H heads: bf16
    takes the tensor cores ("tc"); fp32, the checking dtype, keeps the FMA
    kernels ("fma"), whose products stay in full fp32. Raises for a width
    or head width no kernel is built for."""
    if C not in WIDTHS or H <= 0 or C % H or C // H not in HEAD_DIMS:
        raise ValueError(f"the CUDA attn_block kernels take C in {WIDTHS} "
                         f"and d_head in {HEAD_DIMS}; got C={C}, heads={H}")
    return "tc" if dtype == torch.bfloat16 else "fma"


def tc_smem_bytes(C: int, d_head: int) -> dict:
    """Shared memory of each tensor-core kernel at width C and head width
    d_head, as csrc/proj_tc.cuh reckons the projections': bf16
    tiles of pitch width + 8, 64-row tiles. The projection: x / StdLN(x)
    [64][C] and a three-stage W ring [64][128]; the projection backward:
    x [64][C], a three-stage ring of a dq|dk|dv chunk [64][32] and a W
    chunk [C][32], fp32 stats [4][64]. The attention forward, dK/dV and
    dQ run the flash loops of csrc/flash_tc.cuh, whose bytes
    attention.tc_smem_bytes reckons."""
    def tile(rows, width):
        return 2 * rows * (width + 8)
    flash = flash_smem_bytes(d_head)
    return {
        "block_qkv_tc_kernel": tile(64, C) + 3 * tile(64, 128),
        "block_attn_tc_kernel": flash["attention_fwd_tc_kernel"],
        "block_dkv_tc_kernel": flash["attention_dkv_tc_kernel"],
        "block_dq_tc_kernel": flash["attention_dq_tc_kernel"],
        "block_ln_bwd_tc_kernel": tile(64, C) + 3 * (tile(64, 32)
                                                    + tile(C, 32))
        + 4 * 4 * 64,
    }


def tc_min_blocks(C: int, d_head: int) -> dict:
    """Blocks an SM that each tensor-core kernel's launch bounds ask for
    at width C and head width d_head: the projections' as rowmm's
    (rowmm.tc_min_blocks), the flash loops' as the masked attention's
    (attention.tc_min_blocks); the forward's attention kernel asks for
    none (1). The card tests hold this to the C entry
    attn_block_tc_min_blocks."""
    proj = proj_min_blocks(C)["rowmm_tc_kernel"]
    flash = flash_min_blocks(d_head)
    return {"block_qkv_tc_kernel": proj, "block_attn_tc_kernel": 1,
            "block_dkv_tc_kernel": flash["attention_dkv_tc_kernel"],
            "block_dq_tc_kernel": flash["attention_dq_tc_kernel"],
            "block_ln_bwd_tc_kernel": proj}


def torch_attn_block(x, gamma, beta, w, b, key_mask: Optional[torch.Tensor],
                     scale: float, num_heads: int) -> torch.Tensor:
    """The unfused composition (stdln_apply + projections +
    torch_masked_attention + residual), rounding where xla_attn_block
    rounds: LN and the projections in ``x.dtype``, scores and softmax in
    fp32, probabilities cast to the value dtype."""
    from ..models.modules import stdln_apply
    from .attention import torch_masked_attention
    B, L, C = x.shape
    H = num_heads
    dt = x.dtype
    ln = stdln_apply(x, gamma, beta, dt)
    y = ln @ w.to(dt) + b.to(dt)
    q, k, v = torch.split(y, C, dim=-1)
    ctx = torch_masked_attention(
        q.reshape(B, L, H, C // H), k.reshape(B, L, H, C // H),
        v.reshape(B, L, H, C // H), key_mask, scale)
    return x + ctx.reshape(B, L, C)


def block_tile_map(mask: torch.Tensor) -> torch.Tensor:
    """int8 [B, ceil(Lq/64), ceil(Lk/64)]: the class of each 64 x 64
    (query, key) tile of a block mask [B, Lq, Lk] (nonzero = masked) over
    the pairs inside the array: TILE_DEAD when every pair is masked,
    TILE_FULL when none is, else TILE_MIXED; a query tile holding a row
    whose every key is masked (that row attends uniformly over all keys)
    has no dead tile. The plain version of csrc/attn_block.cu::
    block_tile_map_kernel."""
    B, Lq, Lk = mask.shape
    nq, nk = -(-Lq // 64), -(-Lk // 64)
    m = mask != 0
    masked = torch.zeros(B, nq * 64, nk * 64, dtype=torch.bool,
                         device=mask.device)
    live = torch.zeros_like(masked)
    masked[:, :Lq, :Lk] = m
    live[:, :Lq, :Lk] = ~m
    any_live = live.reshape(B, nq, 64, nk, 64).any(dim=4).any(dim=2)
    any_masked = masked.reshape(B, nq, 64, nk, 64).any(dim=4).any(dim=2)
    cls = torch.where(~any_live, TILE_DEAD,
                      torch.where(~any_masked, TILE_FULL, TILE_MIXED))
    dead_rows = torch.zeros(B, nq * 64, dtype=torch.bool, device=mask.device)
    dead_rows[:, :Lq] = m.all(dim=2)
    has_dead_row = dead_rows.reshape(B, nq, 64).any(dim=2)
    cls = torch.where(has_dead_row[:, :, None] & (cls == TILE_DEAD),
                      TILE_MIXED, cls)
    return cls.to(torch.int8)


def cuda_block_tile_map(mask: torch.Tensor) -> torch.Tensor:
    """block_tile_map on the card, one launch (csrc/attn_block.cu::
    block_tile_map_kernel), from the int8 mask the kernels read."""
    B, Lq, Lk = mask.shape
    tmap = torch.empty(B, -(-Lq // 64), -(-Lk // 64), dtype=torch.int8,
                       device=mask.device)
    rc = _build.library().attn_block_tile_map(mask.data_ptr(),
                                               tmap.data_ptr(), B, Lq, Lk,
                                               stream(mask))
    _build.check(rc, "attn_block_tile_map")
    return tmap


def key_ends(mask: torch.Tensor) -> torch.Tensor:
    """int32 [B]: one past each sample's last unmasked key, or L when every
    key is masked (such a sample attends uniformly over all L keys).
    mask: [B, L], nonzero = masked."""
    L = mask.shape[1]
    idx = torch.arange(L, device=mask.device, dtype=torch.int32)
    last = torch.where(mask == 0, idx, -1).amax(dim=1)
    return torch.where(last < 0, L, last + 1).to(torch.int32)


def _check(x, w, b, key_mask, num_heads):
    """The wrapper's checks, shapes and mask first (they hold on any
    device), then the device; returns the int8 mask on x's device
    ([B, L] or [B, L, L]), kend int32 [B] (``key_ends``, or L for every
    sample under a block mask) and whether the mask is a block mask."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_block takes fp32 or bf16, got {x.dtype}")
    B, L, C = x.shape
    H = num_heads
    attn_block_route(x.dtype, C, H)
    if tuple(w.shape) != (C, 3 * C) or tuple(b.shape) != (3 * C,):
        raise ValueError(f"qkv weights must be [{C}, {3 * C}] and "
                         f"[{3 * C}], got {tuple(w.shape)}, {tuple(b.shape)}")
    block = key_mask is not None and key_mask.dim() == 3
    want = (B, L, L) if block else (B, L)
    if key_mask is not None and tuple(key_mask.shape) != want:
        raise ValueError(f"key mask must be [{B}, {L}] or [{B}, {L}, {L}], "
                         f"got {tuple(key_mask.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"cuda_attn_block needs CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("attn_block needs a contiguous x")
    if key_mask is None:
        mask = torch.zeros(B, L, dtype=torch.int8, device=x.device)
    elif (key_mask.dtype in _BYTE_MASKS and key_mask.device == x.device
          and key_mask.is_contiguous()):
        mask = key_mask.view(torch.int8)
    else:
        mask = key_mask.to(device=x.device, dtype=torch.int8).contiguous()
    kend = (torch.full((B,), L, dtype=torch.int32, device=x.device) if block
            else key_ends(mask))
    return mask, kend, block


def _operands(x, gamma, beta, w, b):
    dt = x.dtype
    w = w.to(dt).contiguous()
    b = b.to(dt).contiguous()
    gamma = gamma.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()
    for t in (w, b, gamma, beta):
        if t.device != x.device:
            raise ValueError(f"attn_block operands on {t.device}, x on "
                             f"{x.device}")
    return gamma, beta, w, b


def _tile_map(x, mask, block, num_heads):
    """The tile map the tensor-core route reads under a block mask, built
    on the card (``mask`` as the kernels read it): None for a key mask,
    for the FMA route (which reads every pair) and for a mask of one key
    tile (nothing to skip)."""
    if (not block or mask.shape[-1] <= 64
            or attn_block_route(x.dtype, x.shape[-1], num_heads) != "tc"):
        return None
    return cuda_block_tile_map(mask)


def _launch_fwd(x, gamma, beta, w, b, mask, tmap, kend, block, scale,
                num_heads, train):
    """The two launches; ``train`` adds the pre-residual attention output
    and the (m, l) stats [B, H, L, 2] of the live rows. The scratch holds
    q|k|v. ``tmap``: the block mask's tile map, or None."""
    B, L, C = x.shape
    H = num_heads
    gamma, beta, w, b = _operands(x, gamma, beta, w, b)
    qkv = torch.empty(B, L, 3 * C, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    attn = stats = None
    if train:
        attn = torch.empty_like(x)
        stats = torch.empty(B, H, L, 2, dtype=torch.float32, device=x.device)
    rc = _build.library().attn_block_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        b.data_ptr(), mask.data_ptr(),
        None if tmap is None else tmap.data_ptr(), kend.data_ptr(),
        qkv.data_ptr(),
        out.data_ptr(), None if attn is None else attn.data_ptr(),
        None if stats is None else stats.data_ptr(), B, L, C, H, int(block),
        1.0 / scale, dtype_code(x.dtype), stream(x))
    _build.check(rc, "attn_block")
    count("attn_block_3d" if block else "attn_block")
    return out, attn, stats


def cuda_attn_block_bwd(x, gamma, beta, w, b, mask, attn, stats,
                        scale: float, num_heads: int, dy, tmap=None):
    """The backward kernels: (dx, dgamma, dbeta, dw, db), dw and db in the
    dtype of the ``w`` and ``b`` given (as the TPU kernel returns them),
    dgamma and dbeta in theirs; parameter gradients summed in fp32. Under a
    key mask, q tiles that start past a sample's last valid key give
    dx = dy and add nothing (their rows carry no cotangent in the model);
    where whole tiles tile each sample (L % 64 == 0) the weight sums skip
    their rows. Under a block mask every row is live; ``tmap``, its tile
    map (built here when None), lets the tensor cores skip dead tiles."""
    mask, kend, block = _check(x, w, b, mask, num_heads)
    if tmap is None:
        tmap = _tile_map(x, mask, block, num_heads)
    B, L, C = x.shape
    H = num_heads
    dt = x.dtype
    gamma_, beta_, w_, b_ = _operands(x, gamma, beta, w, b)
    dy = dy.to(dt).contiguous()
    lib = _build.library()
    qkv = torch.empty(B, L, 3 * C, dtype=dt, device=x.device)
    rc = lib.attn_block_qkv(
        x.data_ptr(), gamma_.data_ptr(), beta_.data_ptr(), w_.data_ptr(),
        b_.data_ptr(), kend.data_ptr(), qkv.data_ptr(), B, L, C,
        dtype_code(dt), stream(x))
    _build.check(rc, "attn_block_qkv")
    # delta = rowsum(dO * O) per row and head: the tensor cores' pre-pass
    delta = (torch.empty(B, H, L, dtype=torch.float32, device=x.device)
             if attn_block_route(dt, C, H) == "tc" else None)
    dqkv = torch.empty_like(qkv)
    ln = torch.empty_like(x)
    dx = torch.empty_like(x)
    gpart = torch.empty(B * -(-L // 64), 2 * C, dtype=torch.float32,
                        device=x.device)
    rc = lib.attn_block_bwd(
        x.data_ptr(), gamma_.data_ptr(), beta_.data_ptr(), w_.data_ptr(),
        mask.data_ptr(), None if tmap is None else tmap.data_ptr(),
        kend.data_ptr(), attn.data_ptr(), stats.data_ptr(),
        dy.data_ptr(), qkv.data_ptr(),
        None if delta is None else delta.data_ptr(), dqkv.data_ptr(),
        ln.data_ptr(), dx.data_ptr(), gpart.data_ptr(), B, L, C, H,
        int(block), 1.0 / scale, dtype_code(dt), stream(x))
    _build.check(rc, "attn_block_bwd")
    flags = None
    if L % 64 == 0 and not block:
        starts = torch.arange(0, L, 64, device=x.device, dtype=torch.int32)
        flags = (starts[None, :] < kend[:, None]).to(torch.int8).reshape(-1)
    dw, db = wgrad(ln.reshape(B * L, C), dqkv.reshape(B * L, 3 * C), flags,
                   None if flags is None else 64)
    g = col_sum(gpart)
    count("attn_block_3d_bwd" if block else "attn_block_bwd")
    return (dx, g[:C].to(gamma.dtype), g[C:].to(beta.dtype), dw.to(w.dtype),
            db.to(b.dtype))


class _AttnBlock(torch.autograd.Function):
    """The training forward; the backward kernels as its gradient. Saves
    x, the pre-residual attention output, the row stats and a block
    mask's tile map."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, mask, tmap, kend, block, scale,
                num_heads):
        out, attn, stats = _launch_fwd(x, gamma, beta, w, b, mask, tmap,
                                       kend, block, scale, num_heads,
                                       train=True)
        ctx.save_for_backward(x, gamma, beta, w, b, mask, attn, stats)
        ctx.tmap, ctx.scale, ctx.num_heads = tmap, scale, num_heads
        return out

    @staticmethod
    def backward(ctx, dy):
        grads = cuda_attn_block_bwd(*ctx.saved_tensors, ctx.scale,
                                    ctx.num_heads, dy, ctx.tmap)
        return (*grads, None, None, None, None, None, None)


def cuda_attn_block(x, gamma, beta, w, b, key_mask: Optional[torch.Tensor],
                    scale: float, num_heads: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: the lean form, or the training
    form through the autograd Function when a gradient is needed. Under a
    key mask, rows past a sample's last valid key, in q tiles that start
    past it, hold the pure residual."""
    mask, kend, block = _check(x, w, b, key_mask, num_heads)
    tmap = _tile_map(x, mask, block, num_heads)
    if needs_grad(x, gamma, beta, w, b):
        return _AttnBlock.apply(x, gamma, beta, w, b, mask, tmap, kend,
                                block, scale, num_heads)
    return _launch_fwd(x, gamma, beta, w, b, mask, tmap, kend, block, scale,
                       num_heads, train=False)[0]
