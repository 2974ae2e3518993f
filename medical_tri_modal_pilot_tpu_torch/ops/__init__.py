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
path ``umse``, ``attn_block``, ``ffn``, ``attention``, the two
``rowskip`` projections and ``swin_attention`` and ``swin_mlp`` (the
trainable trunk) are autograd Functions whose backward launches the
backward kernels.

``launches`` counts, per kernel, the wrapper calls that launched it
(kernels/_util.py); the backward kernels count as ``umse_bwd``,
``attn_block_bwd``, ``ffn_bwd``, ``attention_bwd``, ``rowmm_ln_bwd``,
``rowmm_bwd``, ``swin_attention_bwd`` and ``swin_mlp_bwd``, the attention
block under a 3-D block mask as ``attn_block_3d`` and
``attn_block_3d_bwd``. ``recomputes`` counts the Swin backward passes
that recompute the plain version under autograd instead: those of the
Functions on CPU tensors (the tests' stand-in for the forward kernel); on
the card it stays 0.
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
from ..kernels._util import KERNELS, RECOMPUTES, launches, recomputes

__all__ = ["KERNELS", "RECOMPUTES", "launches", "recomputes",
           "reset_launches", "reference_path",
           "umse", "attn_block", "ffn", "dropout_masks", "swin_attention",
           "swin_mlp", "attention", "rowskip_ln_affine", "rowskip_affine"]

# the wrappers that route CUDA tensors to their plain versions: every one
# (True) or those named
_reference = frozenset()


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    for name in RECOMPUTES:
        recomputes[name] = 0


@contextlib.contextmanager
def reference_path(*names: str) -> Iterator[None]:
    """Route CUDA tensors through the plain PyTorch versions: those of
    every wrapper, or of the wrappers named (``ops`` function names, as
    ``"attn_block"``), the others still launching their kernels."""
    global _reference
    unknown = set(names) - set(__all__)
    if unknown:
        raise ValueError(f"no ops wrapper named {sorted(unknown)}")
    prev = _reference
    _reference = True if not names else frozenset(names)
    try:
        yield
    finally:
        _reference = prev


def _launches_kernel(device: torch.device, name: str) -> bool:
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {device}")
    return not (_reference is True or name in _reference)


def umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """TIE-token embedding, [B, L, 3] -> [B, L, D] in ``dtype``."""
    if not _launches_kernel(x.device, "umse"):
        return _umse.torch_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table,
                                dtype)
    return _umse.cuda_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table,
                           dtype)


def attn_block(x, gamma, beta, w, b, key_mask: Optional[torch.Tensor],
               scale: float, num_heads: int):
    """x + MHA(StdLN(x)) with q|k|v weights [C, 3C] / [3C]; the mask None,
    [B, L] or [B, L, L], True = masked."""
    if not _launches_kernel(x.device, "attn_block"):
        return _attn_block.torch_attn_block(x, gamma, beta, w, b, key_mask,
                                            scale, num_heads)
    return _attn_block.cuda_attn_block(x, gamma, beta, w, b, key_mask, scale,
                                       num_heads)


def attention(q, k, v, key_mask: Optional[torch.Tensor], scale: float,
              is_self: bool = False):
    """softmax(mask(q k^T / scale)) v over [B, L, H, Dh] operands; the mask
    None, [B, Lk] or [B, Lq, Lk]. ``is_self``: q and k are one stream."""
    if not _launches_kernel(q.device, "attention"):
        return _attention.torch_masked_attention(q, k, v, key_mask, scale,
                                                 is_self)
    return _attention.cuda_masked_attention(q, k, v, key_mask, scale,
                                            is_self)


def dropout_masks(R: int, F: int, C: int, seed: int, p: float, device,
                  col0: int = 0, row0: int = 0):
    """The FFN kernels' keep masks for ``seed`` (bool [R, F], [R, C]), the
    hidden one holding columns ``col0`` .. col0 + F of the whole mask, both
    rows ``row0`` .. row0 + R; one launch on the card, both masks written
    as bool."""
    device = torch.device(device)
    if not _launches_kernel(device, "dropout_masks"):
        return _ffn.plain_dropout_masks(R, F, C, seed, p, device, col0, row0)
    return _ffn.cuda_dropout_masks(R, F, C, seed, p, device, col0, row0)


def ffn(x, gamma, beta, w1, b1, w2, b2,
        block_valid: Optional[torch.Tensor] = None, p: float = 0.0,
        training: bool = False, seed: Optional[int] = None, row0: int = 0):
    """x + drop(W2 drop(relu(W1 StdLN(x) + b1)) + b2); dropout at rate
    ``p`` when ``training``, its masks drawn for ``seed``, x's rows at rows
    ``row0`` onwards of them."""
    p = p if training else 0.0
    if not _launches_kernel(x.device, "ffn"):
        keep = None
        if p > 0.0:
            C, F = x.shape[-1], w1.shape[-1]
            keep = _ffn.plain_dropout_masks(x.numel() // C, F, C, seed, p,
                                            x.device, row0=row0)
        return _ffn.torch_ffn(x, gamma, beta, w1, b1, w2, b2, block_valid,
                              keep, p)
    return _ffn.cuda_ffn(x, gamma, beta, w1, b1, w2, b2, block_valid, p,
                         seed, row0)


def swin_attention(xw, wqkv, bqkv, wproj, bproj, bias,
                   smask: Optional[torch.Tensor], num_heads: int):
    """Swin window attention over [I, 49, C] windows, output [I, 49, C]."""
    if not _launches_kernel(xw.device, "swin_attention"):
        return _swin_attention.torch_window_attention(
            xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)
    return _swin_attention.cuda_window_attention(
        xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)


def swin_mlp(x, scale, bias, w1, b1, w2, b2):
    """x + fc2(gelu(fc1(LN(x)))) over [R, C] rows."""
    if not _launches_kernel(x.device, "swin_mlp"):
        return _swin_mlp.torch_swin_mlp(x, scale, bias, w1, b1, w2, b2)
    return _swin_mlp.cuda_swin_mlp(x, scale, bias, w1, b1, w2, b2)


def rowskip_ln_affine(x, gamma, beta, w, b,
                      block_valid: Optional[torch.Tensor] = None):
    """(q, k, v) = thirds of StdLN(x) @ w + b, skipping the 256-row blocks
    whose flag is 0 (zeros there on the kernel path)."""
    if not _launches_kernel(x.device, "rowskip_ln_affine"):
        return _rowmm.torch_rowskip_ln_affine(x, gamma, beta, w, b,
                                              block_valid)
    return _rowmm.cuda_rowskip_ln_affine(x, gamma, beta, w, b, block_valid)


def rowskip_affine(x, w, b, block_valid: Optional[torch.Tensor] = None):
    """x @ w + b, skipping the 256-row blocks whose flag is 0."""
    if not _launches_kernel(x.device, "rowskip_affine"):
        return _rowmm.torch_rowskip_affine(x, w, b, block_valid)
    return _rowmm.cuda_rowskip_affine(x, w, b, block_valid)
