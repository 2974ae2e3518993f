"""UMSE TIE-token embedding, per token

    relu(LN(value*Wv + bv)) + relu(LN(time*Wt + bt)) + table[feat_id],

as a plain PyTorch version and a Triton kernel (``umse_triton.py``). The
kernel's gradient is autograd of the plain version, recomputed in the
backward: the JAX package's own design (kernels/umse.py:127-137).

Counterpart of medical_tri_modal_pilot_tpu/kernels/umse.py (``xla_umse`` and
``pallas_umse``): the affines run in the compute dtype, the LayerNorm
statistics (biased variance, eps 1e-5) in fp32, the table row is added in
fp32 and the sum is cast to the compute dtype once.
"""
from __future__ import annotations

import torch

from ._util import count, needs_grad

LN_EPS = 1e-5    # torch nn.LayerNorm default (the reference stems)
ROWS_PER_PROGRAM = 32


def stem(x_col, w, b, scale, bias, dtype):
    """relu(LN(x*w + b)) for a column of scalars x_col [R, 1]; w [1, D]."""
    h = x_col.to(dtype) * w.to(dtype)[0][None, :] + b.to(dtype)[None, :]
    h32 = h.float()
    mu = h32.mean(dim=-1, keepdim=True)
    var = ((h32 * h32).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (h32 - mu) * torch.rsqrt(var + LN_EPS)
    y = y * scale.float()[None, :] + bias.float()[None, :]
    return y.clamp_min(0.0)


def torch_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """x: [B, L, 3] (time, value, feat_id) fp32 -> [B, L, D] in ``dtype``."""
    B, L, _ = x.shape
    D = wv.shape[1]
    t = x[:, :, 0].reshape(B * L, 1)
    v = x[:, :, 1].reshape(B * L, 1)
    fid = x[:, :, 2].to(torch.int64).reshape(B * L)
    ev = stem(v, wv, bv, sv, bbv, dtype)
    et = stem(t, wt, bt, st, bbt, dtype)
    # the table row as a one-hot product, as the TPU kernel computes it:
    # exact in fp32, zeros for an id outside the table, and a backward that
    # is one product (the gather's index backward serialises the 64000
    # rows that share 20 ids)
    onehot = (fid[:, None] == torch.arange(table.shape[0],
                                           device=fid.device)).float()
    ef = onehot @ table.float()
    return (ev + et + ef).to(dtype).reshape(B, L, D)


class _UMSE(torch.autograd.Function):
    """The Triton forward; the backward differentiates torch_umse."""

    @staticmethod
    def forward(ctx, x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
        ctx.save_for_backward(x, wv, bv, sv, bbv, wt, bt, st, bbt, table)
        ctx.dtype = dtype
        return _launch(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = torch_umse(*inputs, ctx.dtype)
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, dout))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None)


def triton_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """Launch the Triton kernel on CUDA tensors, through the autograd
    Function when a gradient is needed. A feature id outside the table
    embeds as zeros, as the TPU kernel's one-hot product does."""
    args = (x, wv, bv, sv, bbv, wt, bt, st, bbt, table)
    if needs_grad(*args):
        return _UMSE.apply(*args, dtype)
    return _launch(*args, dtype)


def _launch(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    if x.device.type != "cuda":
        raise ValueError(f"triton_umse needs CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 3:
        raise ValueError(f"umse takes fp32 [B, L, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"umse emits fp32 or bf16, got {dtype}")
    B, L, _ = x.shape
    D = wv.shape[1]
    if D & (D - 1) or D < 16:
        raise ValueError(f"umse needs a power-of-two width >= 16, got {D}")
    params = [p.to(torch.float32).reshape(-1).contiguous()
              for p in (wv, bv, sv, bbv, wt, bt, st, bbt)]
    table = table.to(torch.float32).contiguous()
    for p in params + [table]:
        if p.device != x.device:
            raise ValueError(f"umse operands on {p.device}, x on {x.device}")
    if any(p.numel() != D for p in params):
        raise ValueError(f"umse stem parameters must hold {D} values")
    if table.dim() != 2 or table.shape[1] != D:
        raise ValueError(f"umse table must be [n_ids, {D}], got "
                         f"{tuple(table.shape)}")
    x = x.contiguous()
    out = torch.empty(B, L, D, dtype=dtype, device=x.device)
    from .umse_triton import launch
    launch(x, *params, table, out, ROWS_PER_PROGRAM)
    count("umse")
    return out
