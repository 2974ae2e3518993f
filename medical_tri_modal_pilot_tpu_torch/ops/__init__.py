"""Kernel dispatch for one device (counterpart of
medical_tri_modal_pilot_tpu/ops/__init__.py:261-325): the five kernels of the
flagship's eval step.

Each wrapper picks its implementation by the device of its input: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (or the launch raises; nothing falls back). Inside
``reference_path()`` CUDA tensors take the plain versions too, which is how
the tests and ``chip_smoke.py`` build their oracle on the card.

``launches`` counts, per kernel, the wrapper calls that launched it.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

from ..kernels import attn_block as _attn_block
from ..kernels import ffn as _ffn
from ..kernels import swin_attention as _swin_attention
from ..kernels import swin_mlp as _swin_mlp
from ..kernels import umse as _umse

KERNELS = ("umse", "attn_block", "ffn", "swin_attention", "swin_mlp")
launches = {name: 0 for name in KERNELS}

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


def _launches_kernel(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain version for device {x.device}")
    return not _reference


def umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """TIE-token embedding, [B, L, 3] -> [B, L, D] in ``dtype``."""
    if not _launches_kernel(x):
        return _umse.torch_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table,
                                dtype)
    out = _umse.triton_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table,
                            dtype)
    launches["umse"] += 1
    return out


def attn_block(x, gamma, beta, w, b, key_mask: Optional[torch.Tensor],
               scale: float, num_heads: int):
    """x + MHA(StdLN(x)) with q|k|v weights [C, 3C] / [3C]."""
    if not _launches_kernel(x):
        return _attn_block.torch_attn_block(x, gamma, beta, w, b, key_mask,
                                            scale, num_heads)
    out = _attn_block.cuda_attn_block(x, gamma, beta, w, b, key_mask, scale,
                                      num_heads)
    launches["attn_block"] += 1
    return out


def ffn(x, gamma, beta, w1, b1, w2, b2,
        block_valid: Optional[torch.Tensor] = None):
    """x + W2 relu(W1 StdLN(x) + b1) + b2, forward and deterministic."""
    if not _launches_kernel(x):
        return _ffn.torch_ffn(x, gamma, beta, w1, b1, w2, b2, block_valid)
    out = _ffn.cuda_ffn(x, gamma, beta, w1, b1, w2, b2, block_valid)
    launches["ffn"] += 1
    return out


def swin_attention(xw, wqkv, bqkv, wproj, bproj, bias,
                   smask: Optional[torch.Tensor], num_heads: int):
    """Swin window attention over [I, 49, C] windows, output [I, 49, C]."""
    if not _launches_kernel(xw):
        return _swin_attention.torch_window_attention(
            xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)
    out = _swin_attention.cuda_window_attention(
        xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)
    launches["swin_attention"] += 1
    return out


def swin_mlp(x, scale, bias, w1, b1, w2, b2):
    """x + fc2(gelu(fc1(LN(x)))) over [R, C] rows."""
    if not _launches_kernel(x):
        return _swin_mlp.torch_swin_mlp(x, scale, bias, w1, b1, w2, b2)
    out = _swin_mlp.cuda_swin_mlp(x, scale, bias, w1, b1, w2, b2)
    launches["swin_mlp"] += 1
    return out
