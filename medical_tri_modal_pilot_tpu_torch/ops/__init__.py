"""Kernel dispatch for one device (counterpart of
medical_tri_modal_pilot_tpu/ops/__init__.py:261-325): the kernels of the
flagship's train and eval steps, the masked attention of the cross-modal
layers, and the row-skipping q|k|v projections of tensor parallelism.

Each wrapper picks its implementation by the device of its input: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (or the launch raises; nothing falls back). Inside
``reference_path()`` CUDA tensors take the plain versions too, which is how
the tests and ``chip_smoke.py`` build their oracle on the card. On the
plain path the gradients are autograd of the plain versions; on the kernel
path ``umse``, ``attn_block``, ``ffn``, ``attention`` and the two
``rowskip`` projections are autograd Functions whose backward launches the
backward kernels (``umse``'s differentiates its plain version, as in the
JAX package).

``launches`` counts, per kernel, the wrapper calls that launched it
(kernels/_util.py); the backward kernels count as ``attn_block_bwd``,
``ffn_bwd``, ``attention_bwd``, ``rowmm_ln_bwd`` and ``rowmm_bwd``.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..kernels import attention as _attention
from ..kernels import attn_block as _attn_block
from ..kernels import ffn as _ffn
from ..kernels import rowmm as _rowmm
from ..kernels import swin_attention as _swin_attention
from ..kernels import swin_mlp as _swin_mlp
from ..kernels import umse as _umse
from ..kernels._util import KERNELS, launches

__all__ = ["KERNELS", "launches", "reset_launches", "reference_path",
           "umse", "attn_block", "ffn", "dropout_masks", "swin_attention",
           "swin_mlp", "attention", "rowskip_ln_affine", "rowskip_affine"]

_reference = False


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


@contextlib.contextmanager
def reference_path() -> Iterator[None]:
    """Route CUDA tensors through the plain PyTorch versions."""
    global _reference
    prev, _reference = _reference, True
    try:
        yield
    finally:
        _reference = prev


def _launches_kernel(device: torch.device) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {device}")
    return not _reference


def umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """TIE-token embedding, [B, L, 3] -> [B, L, D] in ``dtype``."""
    if not _launches_kernel(x.device):
        return _umse.torch_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table,
                                dtype)
    return _umse.triton_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table,
                             dtype)


def attn_block(x, gamma, beta, w, b, key_mask: Optional[torch.Tensor],
               scale: float, num_heads: int):
    """x + MHA(StdLN(x)) with q|k|v weights [C, 3C] / [3C]."""
    if not _launches_kernel(x.device):
        return _attn_block.torch_attn_block(x, gamma, beta, w, b, key_mask,
                                            scale, num_heads)
    return _attn_block.cuda_attn_block(x, gamma, beta, w, b, key_mask, scale,
                                       num_heads)


def attention(q, k, v, key_mask: Optional[torch.Tensor], scale: float,
              is_self: bool = False):
    """softmax(mask(q k^T / scale)) v over [B, L, H, Dh] operands; the mask
    None, [B, Lk] or [B, Lq, Lk]. ``is_self``: q and k are one stream."""
    if not _launches_kernel(q.device):
        return _attention.torch_masked_attention(q, k, v, key_mask, scale,
                                                 is_self)
    return _attention.cuda_masked_attention(q, k, v, key_mask, scale,
                                            is_self)


def dropout_masks(R: int, F: int, C: int, seed: int, p: float, device,
                  col0: int = 0):
    """The FFN kernels' keep masks for ``seed`` (bool [R, F], [R, C]), the
    hidden one holding columns ``col0`` .. col0 + F of the whole mask."""
    device = torch.device(device)
    if not _launches_kernel(device):
        return _ffn.plain_dropout_masks(R, F, C, seed, p, device, col0)
    return _ffn.cuda_dropout_masks(R, F, C, seed, p, device, col0)


def ffn(x, gamma, beta, w1, b1, w2, b2,
        block_valid: Optional[torch.Tensor] = None, p: float = 0.0,
        training: bool = False, seed: Optional[int] = None):
    """x + drop(W2 drop(relu(W1 StdLN(x) + b1)) + b2); dropout at rate
    ``p`` when ``training``, its masks drawn for ``seed``."""
    p = p if training else 0.0
    if not _launches_kernel(x.device):
        keep = None
        if p > 0.0:
            C, F = x.shape[-1], w1.shape[-1]
            keep = _ffn.plain_dropout_masks(x.numel() // C, F, C, seed, p,
                                            x.device)
        return _ffn.torch_ffn(x, gamma, beta, w1, b1, w2, b2, block_valid,
                              keep, p)
    return _ffn.cuda_ffn(x, gamma, beta, w1, b1, w2, b2, block_valid, p,
                         seed)


def swin_attention(xw, wqkv, bqkv, wproj, bproj, bias,
                   smask: Optional[torch.Tensor], num_heads: int):
    """Swin window attention over [I, 49, C] windows, output [I, 49, C]."""
    if not _launches_kernel(xw.device):
        return _swin_attention.torch_window_attention(
            xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)
    return _swin_attention.cuda_window_attention(
        xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)


def swin_mlp(x, scale, bias, w1, b1, w2, b2):
    """x + fc2(gelu(fc1(LN(x)))) over [R, C] rows."""
    if not _launches_kernel(x.device):
        return _swin_mlp.torch_swin_mlp(x, scale, bias, w1, b1, w2, b2)
    return _swin_mlp.cuda_swin_mlp(x, scale, bias, w1, b1, w2, b2)


def rowskip_ln_affine(x, gamma, beta, w, b,
                      block_valid: Optional[torch.Tensor] = None):
    """(q, k, v) = thirds of StdLN(x) @ w + b, skipping the 256-row blocks
    whose flag is 0 (zeros there on the kernel path)."""
    if not _launches_kernel(x.device):
        return _rowmm.torch_rowskip_ln_affine(x, gamma, beta, w, b,
                                              block_valid)
    return _rowmm.cuda_rowskip_ln_affine(x, gamma, beta, w, b, block_valid)


def rowskip_affine(x, w, b, block_valid: Optional[torch.Tensor] = None):
    """x @ w + b, skipping the 256-row blocks whose flag is 0."""
    if not _launches_kernel(x.device):
        return _rowmm.torch_rowskip_affine(x, w, b, block_valid)
    return _rowmm.cuda_rowskip_affine(x, w, b, block_valid)
