"""Fused pre-norm attention block, ``x + MHA(StdLN(x))``: the plain PyTorch
version and the CUDA kernels (``csrc/attn_block.cu``, the lean and training
forwards; ``csrc/attn_block_bwd.cu``, the backward).

Counterpart of medical_tri_modal_pilot_tpu/kernels/attn_block.py
(``xla_attn_block`` and ``pallas_attn_block``). ``w``/``b`` are the
concatenated q|k|v projection weights [C, 3C] / [3C] in the JAX layout
([in, out]); ``scale`` is the score divisor sqrt(d_head).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._util import count, dtype_code, needs_grad, stream
from .wgrad import col_sum, wgrad


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


def key_ends(mask: torch.Tensor) -> torch.Tensor:
    """int32 [B]: one past each sample's last unmasked key, or L when every
    key is masked (such a sample attends uniformly over all L keys).
    mask: [B, L], nonzero = masked."""
    L = mask.shape[1]
    idx = torch.arange(L, device=mask.device, dtype=torch.int32)
    last = torch.where(mask == 0, idx, -1).amax(dim=1)
    return torch.where(last < 0, L, last + 1).to(torch.int32)


def _check(x, w, b, key_mask, num_heads):
    if x.device.type != "cuda":
        raise ValueError(f"cuda_attn_block needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_block takes fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("attn_block needs a contiguous x")
    B, L, C = x.shape
    H = num_heads
    if C % 64 != 0 or C % H != 0 or C // H not in (32, 64):
        raise ValueError(f"attn_block takes C % 64 == 0 and d_head in "
                         f"(32, 64); got C={C}, heads={H}")
    if tuple(w.shape) != (C, 3 * C) or tuple(b.shape) != (3 * C,):
        raise ValueError(f"qkv weights must be [{C}, {3 * C}] and "
                         f"[{3 * C}], got {tuple(w.shape)}, {tuple(b.shape)}")
    if key_mask is None:
        return torch.zeros(B, L, dtype=torch.int8, device=x.device)
    if key_mask.dim() == 3:
        raise NotImplementedError(
            "3-D block masks (multitoken MBT) have no CUDA attn_block "
            "yet (ROADMAP Queue 1 item 6)")
    if tuple(key_mask.shape) != (B, L):
        raise ValueError(f"key mask must be [{B}, {L}], got "
                         f"{tuple(key_mask.shape)}")
    return key_mask.to(device=x.device, dtype=torch.int8).contiguous()


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


def _launch_fwd(x, gamma, beta, w, b, mask, scale, num_heads, train):
    """The two launches; ``train`` adds the pre-residual attention output
    and the (m, l) stats [B, H, L, 2] of the live rows."""
    B, L, C = x.shape
    H = num_heads
    gamma, beta, w, b = _operands(x, gamma, beta, w, b)
    kend = key_ends(mask)
    kv = torch.empty(B, L, 2 * C, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    attn = stats = None
    if train:
        attn = torch.empty_like(x)
        stats = torch.empty(B, H, L, 2, dtype=torch.float32, device=x.device)
    rc = _build.library().attn_block_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
        b.data_ptr(), mask.data_ptr(), kend.data_ptr(), kv.data_ptr(),
        out.data_ptr(), None if attn is None else attn.data_ptr(),
        None if stats is None else stats.data_ptr(), B, L, C, H,
        1.0 / scale, dtype_code(x.dtype), stream(x))
    _build.check(rc, "attn_block")
    count("attn_block")
    return out, attn, stats


def cuda_attn_block_bwd(x, gamma, beta, w, b, mask, attn, stats,
                        scale: float, num_heads: int, dy):
    """The backward kernels: (dx, dgamma, dbeta, dw, db), dw and db in the
    dtype of the ``w`` and ``b`` given (as the TPU kernel returns them),
    dgamma and dbeta in theirs; parameter gradients summed in fp32. q tiles
    that start past a sample's last valid key give dx = dy and add
    nothing (their rows carry no cotangent in the model)."""
    mask = _check(x, w, b, mask, num_heads)
    B, L, C = x.shape
    dt = x.dtype
    gamma_, beta_, w_, b_ = _operands(x, gamma, beta, w, b)
    kend = key_ends(mask)
    dy = dy.to(dt).contiguous()
    lib = _build.library()
    qkv = torch.empty(B, L, 3 * C, dtype=dt, device=x.device)
    rc = lib.attn_block_qkv(
        x.data_ptr(), gamma_.data_ptr(), beta_.data_ptr(), w_.data_ptr(),
        b_.data_ptr(), kend.data_ptr(), qkv.data_ptr(), B, L, C,
        dtype_code(dt), stream(x))
    _build.check(rc, "attn_block_qkv")
    dqkv = torch.empty_like(qkv)
    ln = torch.empty_like(x)
    dx = torch.empty_like(x)
    gpart = torch.empty(B * -(-L // 64), 2 * C, dtype=torch.float32,
                        device=x.device)
    rc = lib.attn_block_bwd(
        x.data_ptr(), gamma_.data_ptr(), beta_.data_ptr(), w_.data_ptr(),
        mask.data_ptr(), kend.data_ptr(), attn.data_ptr(), stats.data_ptr(),
        dy.data_ptr(), qkv.data_ptr(), dqkv.data_ptr(), ln.data_ptr(),
        dx.data_ptr(), gpart.data_ptr(), B, L, C, num_heads, 1.0 / scale,
        dtype_code(dt), stream(x))
    _build.check(rc, "attn_block_bwd")
    dw, db = wgrad(ln.reshape(B * L, C), dqkv.reshape(B * L, 3 * C))
    g = col_sum(gpart)
    count("attn_block_bwd")
    return (dx, g[:C].to(gamma.dtype), g[C:].to(beta.dtype), dw.to(w.dtype),
            db.to(b.dtype))


class _AttnBlock(torch.autograd.Function):
    """The training forward; the backward kernels as its gradient. Saves
    x, the pre-residual attention output and the row stats."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, mask, scale, num_heads):
        out, attn, stats = _launch_fwd(x, gamma, beta, w, b, mask, scale,
                                       num_heads, train=True)
        ctx.save_for_backward(x, gamma, beta, w, b, mask, attn, stats)
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, dy):
        grads = cuda_attn_block_bwd(*ctx.saved_tensors, ctx.scale,
                                    ctx.num_heads, dy)
        return (*grads, None, None, None)


def cuda_attn_block(x, gamma, beta, w, b, key_mask: Optional[torch.Tensor],
                    scale: float, num_heads: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: the lean form, or the training
    form through the autograd Function when a gradient is needed. Rows past
    a sample's last valid key, in q tiles that start past it, hold the pure
    residual."""
    mask = _check(x, w, b, key_mask, num_heads)
    if needs_grad(x, gamma, beta, w, b):
        return _AttnBlock.apply(x, gamma, beta, w, b, mask, scale, num_heads)
    return _launch_fwd(x, gamma, beta, w, b, mask, scale, num_heads,
                       train=False)[0]
