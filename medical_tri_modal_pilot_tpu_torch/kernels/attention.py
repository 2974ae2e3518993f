"""Masked multi-head attention over projected q, k, v: the plain PyTorch
version and the CUDA kernels (``csrc/attention.cu``: the lean and training
forwards and the backward).

Counterpart of medical_tri_modal_pilot_tpu/kernels/attention.py
(``pallas_masked_attention``) and of the XLA path it replaces,
``models/modules.py::masked_softmax_attention``. q is [B, Lq, H, Dh], k and
v [B, Lk, H, Dh], the head axis next to the feature axis as the
projections leave it; ``scale`` is the score divisor sqrt(Dh). The mask is
None, a key mask [B, Lk] or a block mask [B, Lq, Lk], True = masked.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..constants import MASK_FILL_VALUE
from . import _build
from ._util import count, dtype_code, needs_grad, stream
from .attn_block import key_ends

MODE_NONE, MODE_KEYS, MODE_BLOCK = 0, 1, 2


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
    """The mask mode, the int8 mask (or None) and the key ends (or None);
    raises on what the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"cuda_masked_attention needs CUDA tensors, got "
                         f"{q.device}")
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
    if Dh not in (32, 64):
        raise ValueError(f"attention takes a head width of 32 or 64, got {Dh}")
    if min(B, Lq, Lk) == 0:
        raise ValueError(f"attention needs nonempty q and k: {tuple(q.shape)}"
                         f", {tuple(k.shape)}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"attention operands on {t.device} and "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError("attention needs contiguous q, k and v")
    if key_mask is None:
        return MODE_NONE, None, None
    mask = key_mask.to(device=q.device, dtype=torch.int8).contiguous()
    if key_mask.dim() == 2 and tuple(key_mask.shape) == (B, Lk):
        return MODE_KEYS, mask, key_ends(mask)
    if key_mask.dim() == 3 and tuple(key_mask.shape) == (B, Lq, Lk):
        return MODE_BLOCK, mask, None
    raise ValueError(f"the mask must be [{B}, {Lk}] or [{B}, {Lq}, {Lk}], "
                     f"got {tuple(key_mask.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, mode, mask, kend, scale, is_self, train):
    """The forward launch; ``train`` adds the (m, l) stats [B, H, Lq, 2]."""
    B, Lq, H, Dh = q.shape
    out = torch.empty_like(q)
    stats = (torch.empty(B, H, Lq, 2, dtype=torch.float32, device=q.device)
             if train else None)
    rc = _build.library().attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(kend),
        out.data_ptr(), _ptr(stats), B, Lq, k.shape[1], H, Dh, mode,
        int(is_self), 1.0 / scale, dtype_code(q.dtype), stream(q))
    _build.check(rc, "attention")
    count("attention")
    return out, stats


def cuda_masked_attention_bwd(q, k, v, out, stats, dout, mode, mask, kend,
                              scale: float, is_self: bool):
    """The backward kernels: (dq, dk, dv) in the input dtype, summed in
    fp32. A masked pair has a zero score gradient; dead q tiles of a
    self-attention add nothing."""
    B, Lq, H, Dh = q.shape
    dout = dout.to(q.dtype).contiguous()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    rc = _build.library().attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        stats.data_ptr(), dout.data_ptr(), _ptr(mask), _ptr(kend),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq, k.shape[1], H,
        Dh, mode, int(is_self), 1.0 / scale, dtype_code(q.dtype), stream(q))
    _build.check(rc, "attention_bwd")
    count("attention_bwd")
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """The training forward; the backward kernels as its gradient. Saves
    q, k, v, the output and the row stats."""

    @staticmethod
    def forward(ctx, q, k, v, mode, mask, kend, scale, is_self):
        out, stats = _launch_fwd(q, k, v, mode, mask, kend, scale, is_self,
                                 train=True)
        ctx.save_for_backward(q, k, v, out, stats, mask, kend)
        ctx.mode, ctx.scale, ctx.is_self = mode, scale, is_self
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats, mask, kend = ctx.saved_tensors
        dq, dk, dv = cuda_masked_attention_bwd(
            q, k, v, out, stats, dout, ctx.mode, mask, kend, ctx.scale,
            ctx.is_self)
        return dq, dk, dv, None, None, None, None, None


def cuda_masked_attention(q, k, v, key_mask: Optional[torch.Tensor],
                          scale: float, is_self: bool = False
                          ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: the lean form, or the training
    form through the autograd Function when a gradient is needed.
    ``is_self`` (q and k from one stream) applies with a key mask and
    Lq == Lk: rows in q tiles that start past a sample's last valid key
    come back as zeros."""
    mode, mask, kend = _check(q, k, v, key_mask)
    is_self = bool(is_self) and mode == MODE_KEYS and q.shape[1] == k.shape[1]
    if needs_grad(q, k, v):
        return _Attention.apply(q, k, v, mode, mask, kend, scale, is_self)
    return _launch_fwd(q, k, v, mode, mask, kend, scale, is_self,
                       train=False)[0]
