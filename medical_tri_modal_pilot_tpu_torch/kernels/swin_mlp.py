"""Fused LayerNorm -> MLP -> residual of the Swin blocks,
``x + fc2(gelu(fc1(LN(x))))``: the plain PyTorch version and the CUDA
kernel (``csrc/swin_mlp.cu``). Forward only: the trunk is frozen.

Counterpart of medical_tri_modal_pilot_tpu/kernels/swin_mlp.py
(``xla_swin_mlp`` and ``pallas_swin_mlp``). Weights are in the JAX layout:
w1 [C, 4C], w2 [4C, C]; x is [R, C].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._util import count, forward_only

LN_EPS = 1e-5


def torch_swin_mlp(x, scale, bias, w1, b1, w2, b2) -> torch.Tensor:
    """Rounds where xla_swin_mlp rounds: LN (fp32 statistics) to the
    compute dtype; fc1 accumulated in fp32 plus b1 in fp32; exact GELU in
    fp32, then to the compute dtype; fc2 accumulated in fp32 plus b2; x
    added in fp32, then the result cast. The products run on fp32 copies of
    the compute-dtype operands, which is fp32 accumulation of the same
    terms. JAX's kernel uses a polynomial erf (error < 1.5e-7); this is the
    real one."""
    dt = x.dtype
    xf = x.float()
    h = F.layer_norm(xf, (x.shape[-1],), scale.float(), bias.float(),
                     LN_EPS).to(dt)
    h = h.float() @ w1.to(dt).float() + b1.float()
    h = F.gelu(h).to(dt)
    o = h.float() @ w2.to(dt).float() + b2.float()
    return (xf + o).to(dt)


def cuda_swin_mlp(x, scale, bias, w1, b1, w2, b2,
                  split: bool | None = None) -> torch.Tensor:
    """Launch the kernel on a CUDA x [R, C] (fp32 or bf16). It runs fused
    in one launch where the kernel library fuses the width
    (``swin_mlp_fuses``), else as LN, fc1 + GELU and fc2 + residual
    through scratches; ``split=True`` forces the latter at any width."""
    forward_only("swin_mlp", x, scale, bias, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"cuda_swin_mlp needs CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swin_mlp takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("swin_mlp needs a contiguous [R, C] x")
    R, C = x.shape
    Fh = w1.shape[-1]
    if C % 32 != 0 or Fh % 64 != 0:
        raise ValueError(f"swin_mlp takes C % 32 == 0 and a hidden width "
                         f"that is a multiple of 64; got C={C}, hidden={Fh}")
    if tuple(w1.shape) != (C, Fh) or tuple(w2.shape) != (Fh, C):
        raise ValueError(f"swin_mlp weights must be [{C}, {Fh}] and "
                         f"[{Fh}, {C}], got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    dt = x.dtype
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    vecs = [t.to(torch.float32).contiguous() for t in (scale, bias, b1, b2)]
    for t in (w1, w2, *vecs):
        if t.device != x.device:
            raise ValueError(f"swin_mlp operands on {t.device}, x on "
                             f"{x.device}")
    scale, bias, b1, b2 = vecs
    y = torch.empty_like(x)
    if R == 0:
        return y
    lib = _build.library()
    if split is None:
        split = not lib.swin_mlp_fuses(C)
    ln = hidden = None
    if split:
        ln = torch.empty_like(x)
        hidden = torch.empty(R, Fh, dtype=dt, device=x.device)
    rc = lib.swin_mlp_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if ln is None else ln.data_ptr(),
        None if hidden is None else hidden.data_ptr(), y.data_ptr(), R, C,
        Fh, 0 if dt == torch.float32 else 1,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "swin_mlp")
    count("swin_mlp")
    return y
