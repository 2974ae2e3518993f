"""Masked multi-head attention over projected q, k, v: the plain PyTorch
version and the CUDA kernels (``csrc/attention.cu``: the lean and training
forwards and the backward), in two routes (``attention_route``): bf16 on
the tensor cores through the flash loops the attention block also runs
(``csrc/flash_tc.cuh``), fp32 (the checking dtype) on FMA loops.

Counterpart of medical_tri_modal_pilot_tpu/kernels/attention.py
(``pallas_masked_attention``) and of the XLA path it replaces,
``models/modules.py::masked_softmax_attention``. q is [B, Lq, H, Dh], k and
v [B, Lk, H, Dh], the head axis next to the feature axis as the
projections leave it; ``scale`` is the score divisor sqrt(Dh). The mask is
None, a key mask [B, Lk] or a block mask [B, Lq, Lk], True = masked. A
bool or int8 mask on the operands' device is read by the kernels as it
is, one byte per entry; each block finds its sample's last valid key in
the mask row itself, so a call launches only its kernels and allocates
only its outputs (and, in the training form, the row stats).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..constants import MASK_FILL_VALUE
from . import _build
from ._util import count, dtype_code, needs_grad, stream

MODE_NONE, MODE_KEYS, MODE_BLOCK = 0, 1, 2
# the head widths the kernels (and the attention block's, which run the
# same flash loops) are built for
HEAD_DIMS = (32, 64, 128)
# the tensor-core kernels in the order of the C entry attention_tc_smem
TC_KERNELS = ("attention_fwd_tc_kernel", "attention_dkv_tc_kernel",
              "attention_dq_tc_kernel")
# mask dtypes the kernels read as they are, one byte per entry
_BYTE_MASKS = (torch.bool, torch.int8, torch.uint8)


def attention_route(dtype: torch.dtype, d_head: int) -> str:
    """The kernel route for operands of this dtype and head width: bf16
    takes the tensor cores ("tc"); fp32, the checking dtype, keeps the FMA
    kernels ("fma"), whose products stay in full fp32. Raises for a head
    width no kernel is built for."""
    if d_head not in HEAD_DIMS:
        raise ValueError(f"attention takes a head width (d_head) in "
                         f"{HEAD_DIMS}, got {d_head}")
    return "tc" if dtype == torch.bfloat16 else "fma"


def tc_smem_bytes(d_head: int) -> dict:
    """Shared memory of each tensor-core kernel at head width d_head, as
    csrc/flash_tc.cuh reckons its flash loops (the attention block's
    kernels run the same ones: attn_block.tc_smem_bytes): bf16 tiles
    [64][d_head] of pitch d_head + 8. The forward: q and a two-stage ring
    of k and v; dK/dV: k, v and a two-stage ring of q and dO with the
    rows' fp32 m, 1/l and delta; dQ: q, dO and a ring of k and v."""
    tile = 2 * 64 * (d_head + 8)
    return {"attention_fwd_tc_kernel": 5 * tile,
            "attention_dkv_tc_kernel": 6 * tile + 4 * 2 * 3 * 64,
            "attention_dq_tc_kernel": 6 * tile}


def tc_min_blocks(d_head: int) -> dict:
    """Blocks an SM that each tensor-core kernel's launch bounds ask for
    (csrc/flash_tc.cuh flash_min_blocks; the C entry
    attention_tc_min_blocks, which the card tests hold this to): 4, 3, 4
    up to d_head 64; 2 at
    128, where a thread's fp32 accumulators (64 forward, 128 for dK and
    dV) need more than 128 registers and the tiles 85-104 KB a block."""
    blocks = (4, 3, 4) if d_head <= 64 else (2, 2, 2)
    return dict(zip(TC_KERNELS, blocks))


def torch_masked_attention(q, k, v, key_mask: Optional[torch.Tensor],
                           scale: float, is_self: bool = False
                           ) -> torch.Tensor:
    """Scores and softmax in fp32, a masked score replaced by -65504 (so a
    query whose keys are all masked attends uniformly), probabilities cast
    to the value dtype before the product, as masked_softmax_attention.
    ``is_self`` changes nothing here: the kernel zeroes rows that this
    version computes, rows no caller reads."""
    del is_self
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / scale
    if key_mask is not None:
        m = (key_mask[:, None, None, :] if key_mask.dim() == 2
             else key_mask[:, None, :, :])
        scores = scores.masked_fill(m, MASK_FILL_VALUE)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def _check(q, k, v, key_mask):
    """The mask mode and the byte mask (or None); raises on what the
    kernels do not take: dtypes, shapes and the head width first (on any
    device), then the device. A mask of another dtype or device, or not
    contiguous, is converted (a copy per call: the models pass bool masks
    on the card)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attention takes fp32 or bf16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Lq, H, Dh] and k, v [B, Lk, H, Dh]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lq, H, Dh = q.shape
    Lk = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, Dh):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head width")
    tc = attention_route(q.dtype, Dh) == "tc"
    if min(B, Lq, Lk) == 0:
        raise ValueError(f"attention needs nonempty q and k: {tuple(q.shape)}"
                         f", {tuple(k.shape)}")
    if q.device.type != "cuda":
        raise ValueError(f"cuda_masked_attention needs CUDA tensors, got "
                         f"{q.device}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"attention operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("attention needs contiguous q, k and v")
        if tc and t.data_ptr() % 16:
            raise ValueError("the tensor-core attention kernels need q, k "
                             "and v at 16-byte aligned addresses")
    if key_mask is None:
        return MODE_NONE, None
    if key_mask.dim() == 2 and tuple(key_mask.shape) == (B, Lk):
        mode = MODE_KEYS
    elif key_mask.dim() == 3 and tuple(key_mask.shape) == (B, Lq, Lk):
        mode = MODE_BLOCK
    else:
        raise ValueError(f"the mask must be [{B}, {Lk}] or [{B}, {Lq}, {Lk}]"
                         f", got {tuple(key_mask.shape)}")
    if (key_mask.dtype not in _BYTE_MASKS or key_mask.device != q.device
            or not key_mask.is_contiguous()):
        key_mask = key_mask.to(device=q.device, dtype=torch.int8).contiguous()
    return mode, key_mask


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, mode, mask, scale, is_self, train):
    """The forward launch; ``train`` adds the (m, l) stats [B, H, Lq, 2]."""
    B, Lq, H, Dh = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty(B, H, Lq, 2, dtype=torch.float32, device=q.device)
             if train else None)
    rc = _build.library().attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
        out.data_ptr(), _ptr(stats), B, Lq, k.shape[1], H, Dh, mode,
        int(is_self), 1.0 / scale, dtype_code(q.dtype), stream(q))
    _build.check(rc, "attention")
    count("attention")
    return out, stats


def cuda_masked_attention_bwd(q, k, v, out, stats, dout, mode, mask,
                              scale: float, is_self: bool):
    """The backward kernels: (dq, dk, dv) in the input dtype, summed in
    fp32; on the tensor cores after a pre-pass of delta = rowsum(dO * O)
    into an fp32 scratch [B, H, Lq]. A masked pair has a zero score
    gradient; dead q tiles of a self-attention add nothing."""
    B, Lq, H, Dh = q.shape
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = (torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
             if attention_route(q.dtype, Dh) == "tc" else None)
    rc = _build.library().attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats.data_ptr(), dout.data_ptr(), _ptr(mask), _ptr(delta),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq, k.shape[1], H,
        Dh, mode, int(is_self), 1.0 / scale, dtype_code(q.dtype), stream(q))
    _build.check(rc, "attention_bwd")
    count("attention_bwd")
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The training forward; the backward kernels as its gradient. Saves
    q, k, v, the output, the row stats and the mask."""

    @staticmethod
    def forward(ctx, q, k, v, mode, mask, scale, is_self):
        out, stats = _launch_fwd(q, k, v, mode, mask, scale, is_self,
                                 train=True)
        ctx.save_for_backward(q, k, v, out, stats, mask)
        ctx.mode, ctx.scale, ctx.is_self = mode, scale, is_self
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats, mask = ctx.saved_tensors
        dq, dk, dv = cuda_masked_attention_bwd(
            q, k, v, out, stats, dout, ctx.mode, mask, ctx.scale,
            ctx.is_self)
        return dq, dk, dv, None, None, None, None


def cuda_masked_attention(q, k, v, key_mask: Optional[torch.Tensor],
                          scale: float, is_self: bool = False
                          ) -> torch.Tensor:
    """Launch the kernels of the dtype's route on CUDA tensors: the lean
    form, or the training form through the autograd Function when a
    gradient is needed. ``is_self`` (q and k from one stream) applies with
    a key mask and Lq == Lk: rows in q tiles that start past a sample's
    last valid key come back as zeros."""
    mode, mask = _check(q, k, v, key_mask)
    is_self = bool(is_self) and mode == MODE_KEYS and q.shape[1] == k.shape[1]
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v, mode, mask, scale, is_self)
    return _launch_fwd(q, k, v, mode, mask, scale, is_self, train=False)[0]
