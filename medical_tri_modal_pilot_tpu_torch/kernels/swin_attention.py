"""Window attention of the Swin blocks, per 7x7 window: qkv projection,
per-head scores + relative-position bias + shifted-window mask, softmax,
@v, output projection. The plain PyTorch version and the CUDA kernels
(``csrc/swin_attention.cu``), in three routes (``swin_attention_route``).

Counterpart of medical_tri_modal_pilot_tpu/kernels/swin_attention.py
(``xla_window_attention`` and ``pallas_window_attention``), with its
public layout: xw [I, N, C] pre-windowed tokens (image-major, so window i
of an image with M windows uses shift mask i % M), wqkv [C, 3C],
bqkv [3C], wproj [C, C], bproj [C], bias [nh, N, N] fp32, smask [M, N, N]
bool (True = masked) or None.

Training (the trainable trunk, ``--img-pretrain No``): a call that needs
a gradient goes through ``_SwinAttention``, whose forward is the kernel
and whose backward, on the card, is the backward kernel
(``csrc/swin_attention_bwd.cu``: the window core per window and head;
the four dense products around it by torch.matmul), from the saved
inputs, as the JAX package's custom VJP takes ``jax.vjp`` of
``xla_window_attention`` (its ``_fused_bwd``; no ``pallas_call``).
``torch_window_attention_bwd`` is that backward's closed form, rounded
where the kernel rounds; on the CPU the gradient stays autograd of the
plain version. The ``bias`` cotangent flows back to the
relative-position table through the caller's gather.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..constants import MASK_FILL_VALUE
from . import _build
from ._util import (count, dtype_code, needs_grad, recompute_grads,
                    recomputes, stream)
from .wgrad import TARGET_BLOCKS, col_sum

# the kernel's geometry: 7x7 windows, 32-wide heads
WINDOW_TOKENS = 49
HEAD_DIM = 32
# the C entry point's routes: fp32 FMA loops in three launches (fp32); one
# fused tensor-core launch (bf16, Swin-T's stage-1 width); three
# tensor-core launches (bf16)
ROUTES = {"fma": 0, "fused": 1, "split": 2}
# the one width the fused kernel is built for
FUSED_WIDTH = 96


def fused_smem_bytes(C: int = FUSED_WIDTH) -> int:
    """Shared memory of the fused route (swin_fused_kernel's layout,
    csrc/swin_attention.cu Fused) at width C: bf16 tiles of pitch width +
    8, w_qkv [C][3C], w_proj [C][C], x [2 windows][64][C] and q|k|v
    [2 windows][64][3C], then the bias fp32 [C/32][49][49]."""
    wide, narrow = 3 * C + 8, C + 8
    tiles = C * wide + C * narrow + 2 * 64 * narrow + 2 * 64 * wide
    return 2 * tiles + 4 * (C // HEAD_DIM) * WINDOW_TOKENS ** 2


def swin_attention_route(dtype: torch.dtype, C: int) -> str:
    """The kernel route for xw of this dtype and width: fp32 (the checking
    dtype) keeps the FMA kernels, whose products stay in full fp32; bf16
    takes the tensor cores, in one fused launch at Swin-T's stage-1 width
    (C = 96, where the weights and two windows fit in shared memory), else
    in three launches."""
    if dtype != torch.bfloat16:
        return "fma"
    return "fused" if C == FUSED_WIDTH else "split"


def torch_window_attention(xw, wqkv, bqkv, wproj, bproj, bias,
                           smask: Optional[torch.Tensor],
                           num_heads: int) -> torch.Tensor:
    """Rounds where xla_window_attention rounds: qkv and its bias in the
    compute dtype; scores in fp32, divided by sqrt(d_head), plus the bias;
    shift-masked scores set to -65504; softmax probabilities cast to the
    value dtype; @v and the output projection in the compute dtype."""
    I, N, C = xw.shape
    dh = C // num_heads
    dt = xw.dtype
    qkv = xw @ wqkv.to(dt) + bqkv.to(dt)
    q, k, v = (t.reshape(I, N, num_heads, dh).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    s = q.float() @ k.float().transpose(-1, -2)
    s = s / math.sqrt(dh) + bias[None].float()
    if smask is not None:
        sm = smask.repeat(I // smask.shape[0], 1, 1)
        s = s.masked_fill(sm[:, None], MASK_FILL_VALUE)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = (p @ v).transpose(1, 2).reshape(I, N, C)
    return o @ wproj.to(dt) + bproj.to(dt)


def _heads(t, num_heads: int) -> torch.Tensor:
    """[I, N, C] -> [I, nh, N, C / nh]."""
    I, N, C = t.shape
    return t.reshape(I, N, num_heads, C // num_heads).transpose(1, 2)


def _merge(t) -> torch.Tensor:
    """[I, nh, N, dh] -> [I, N, nh * dh]."""
    I, nh, N, dh = t.shape
    return t.transpose(1, 2).reshape(I, N, nh * dh)


def _dense_bwd(xw, wqkv, bqkv, wproj, bproj, dout, dqkv, o):
    """The four dense products' gradients around the window core, from
    the cotangent of q|k|v (dqkv [I, N, 3C]) and the heads' output o
    [I, N, C], in the compute dtype as autograd of the plain version takes
    them (each bias's sum over rows rounded once), then in each input's
    dtype: (dxw, dwqkv, dbqkv, dwproj, dbproj)."""
    dt = xw.dtype
    rows = lambda t: t.reshape(-1, t.shape[-1])
    dxw = dqkv @ wqkv.to(dt).t()
    dwqkv = rows(xw).t() @ rows(dqkv)
    dbqkv = rows(dqkv).sum(0, dtype=torch.float32).to(dt)
    dwproj = rows(o).t() @ rows(dout)
    dbproj = rows(dout).sum(0, dtype=torch.float32).to(dt)
    return (dxw, dwqkv.to(wqkv.dtype), dbqkv.to(bqkv.dtype),
            dwproj.to(wproj.dtype), dbproj.to(bproj.dtype))


def torch_window_attention_bwd(xw, wqkv, bqkv, wproj, bproj, bias,
                               smask: Optional[torch.Tensor],
                               num_heads: int, dout) -> tuple:
    """The gradients of torch_window_attention's output for the cotangent
    ``dout`` [I, N, C] with respect to (xw, wqkv, bqkv, wproj, bproj,
    bias), each in its input's dtype: the closed form the backward kernel
    computes, rounded where it rounds (and where autograd of the plain
    version rounds). q|k|v recomputed; do = dout wproj^T; per window and
    head S and P = softmax(S) in fp32 as the forward, Pc = P cast to the
    value dtype, o = Pc v; dP = do v^T in the compute dtype, then fp32;
    dS = P (dP - rowsum(dP P)), 0 at masked keys; dbias = the sum of dS
    over the windows; dv = Pc^T do, dq = (dS / sqrt(dh)) k and dk =
    (dS / sqrt(dh))^T q in fp32, then cast; the projections' gradients
    from dq|dk|dv and o (``_dense_bwd``)."""
    I, N, C = xw.shape
    dh = C // num_heads
    dt = xw.dtype
    qkv = xw @ wqkv.to(dt) + bqkv.to(dt)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(C, dim=-1))
    s = q.float() @ k.float().transpose(-1, -2)
    s = s / math.sqrt(dh) + bias[None].float()
    sm = None
    if smask is not None:
        sm = smask.repeat(I // smask.shape[0], 1, 1)[:, None]
        s = s.masked_fill(sm, MASK_FILL_VALUE)
    p = torch.softmax(s, dim=-1)
    pc = p.to(v.dtype)
    o = _merge(pc @ v)
    do = _heads(dout @ wproj.to(dt).t(), num_heads)
    dp = (do @ v.transpose(-1, -2)).float()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    if sm is not None:
        ds = ds.masked_fill(sm, 0.0)
    dbias = ds.sum(0)
    ds = ds / math.sqrt(dh)
    dq = (ds @ k.float()).to(dt)
    dk = (ds.transpose(-1, -2) @ q.float()).to(dt)
    dv = pc.transpose(-1, -2) @ do
    dqkv = torch.cat([_merge(t) for t in (dq, dk, dv)], -1)
    return (*_dense_bwd(xw, wqkv, bqkv, wproj, bproj, dout, dqkv, o),
            dbias.to(bias.dtype))


def cuda_window_attention(xw, wqkv, bqkv, wproj, bproj, bias,
                          smask: Optional[torch.Tensor], num_heads: int,
                          route: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors (fp32 or bf16 xw), by ``route``
    (default ``swin_attention_route``; "fma" takes fp32, "fused" and
    "split" bf16, "fused" at FUSED_WIDTH only), through ``_SwinAttention``
    when a gradient is needed."""
    args = (xw, wqkv, bqkv, wproj, bproj, bias)
    if needs_grad(*args):
        return _SwinAttention.apply(*args, smask, num_heads, route)
    return _launch_fwd(*args, smask, num_heads, route)


def cuda_window_attention_bwd(xw, wqkv, bqkv, wproj, bproj, bias,
                              smask: Optional[torch.Tensor], num_heads: int,
                              dout) -> tuple:
    """The backward kernel on CUDA tensors: torch_window_attention_bwd's
    gradients (dxw, dwqkv, dbqkv, dwproj, dbproj, dbias)."""
    _launch_fwd_checks(xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)
    return _launch_bwd(xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads,
                       dout)


class _SwinAttention(torch.autograd.Function):
    """The forward kernel; the backward kernel on the card. On the CPU
    (the tests' stand-in for the forward kernel) the backward recomputes
    torch_window_attention under autograd, counted in ``recomputes``."""

    @staticmethod
    def forward(ctx, xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads,
                route):
        ctx.save_for_backward(xw, wqkv, bqkv, wproj, bproj, bias)
        ctx.smask, ctx.num_heads = smask, num_heads
        return _launch_fwd(xw, wqkv, bqkv, wproj, bproj, bias, smask,
                           num_heads, route)

    @staticmethod
    def backward(ctx, dout):
        needs = ctx.needs_input_grad[:6]
        if dout.device.type == "cuda":
            grads = _launch_bwd(*ctx.saved_tensors, ctx.smask, ctx.num_heads,
                                dout)
            grads = [g if n else None for g, n in zip(grads, needs)]
        else:
            grads = recompute_grads(torch_window_attention,
                                    ctx.saved_tensors, needs,
                                    (ctx.smask, ctx.num_heads), dout)
            recomputes["swin_attention_bwd"] += 1
        return (*grads, None, None, None)


def _launch_fwd_checks(xw, wqkv, bqkv, wproj, bproj, bias,
                       smask: Optional[torch.Tensor], num_heads: int) -> None:
    """The checks both kernels make: dtype, geometry and operand shapes
    first, on any device, then CUDA tensors."""
    if xw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swin_attention takes fp32 or bf16, got {xw.dtype}")
    if xw.dim() != 3 or not xw.is_contiguous():
        raise ValueError("swin_attention needs a contiguous [I, N, C] xw")
    I, N, C = xw.shape
    if N != WINDOW_TOKENS or C != num_heads * HEAD_DIM:
        raise ValueError(f"swin_attention takes {WINDOW_TOKENS} tokens per "
                         f"window and {HEAD_DIM}-wide heads; got N={N}, "
                         f"C={C}, heads={num_heads}")
    shapes = {"wqkv": (wqkv, (C, 3 * C)), "bqkv": (bqkv, (3 * C,)),
              "wproj": (wproj, (C, C)), "bproj": (bproj, (C,)),
              "bias": (bias, (num_heads, N, N))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if smask is not None:
        M = smask.shape[0]
        if tuple(smask.shape) != (M, N, N) or I % M != 0:
            raise ValueError(f"smask must be [M, {N}, {N}] with M dividing "
                             f"{I}, got {list(smask.shape)}")
    if xw.device.type != "cuda":
        raise ValueError(f"cuda_window_attention needs CUDA tensors, got "
                         f"{xw.device}")


def _mask_arg(smask: Optional[torch.Tensor], device) -> tuple:
    """(M, the mask as the kernels read it: int8 [M, 49, 49] on
    ``device``, or None)."""
    if smask is None:
        return 0, None
    return (smask.shape[0],
            smask.to(device=device, dtype=torch.int8).contiguous())


def _launch_fwd(xw, wqkv, bqkv, wproj, bproj, bias,
                smask: Optional[torch.Tensor], num_heads: int,
                route: Optional[str] = None) -> torch.Tensor:
    """The checks and the kernel's launch."""
    _launch_fwd_checks(xw, wqkv, bqkv, wproj, bproj, bias, smask, num_heads)
    I, N, C = xw.shape
    M, mask = _mask_arg(smask, xw.device)
    dt = xw.dtype
    route = route or swin_attention_route(dt, C)
    if route not in ROUTES or (route == "fma") != (dt == torch.float32) or (
            route == "fused" and C != FUSED_WIDTH):
        raise ValueError(f"swin_attention route {route!r} does not take "
                         f"{dt} at C={C}")
    wqkv, bqkv, wproj, bproj = (t.to(dt).contiguous()
                                for t in (wqkv, bqkv, wproj, bproj))
    bias = bias.to(torch.float32).contiguous()
    for t in (wqkv, bqkv, wproj, bproj, bias):
        if t.device != xw.device:
            raise ValueError(f"swin_attention operands on {t.device}, xw on "
                             f"{xw.device}")
    out = torch.empty_like(xw)
    if I == 0:
        return out
    # the three-launch routes' scratch: q|k|v of every token, then the
    # heads' outputs
    qkv = heads = None
    if route != "fused":
        qkv = torch.empty(I, N, 3 * C, dtype=dt, device=xw.device)
        heads = torch.empty_like(xw)
    rc = _build.library().swin_attention_fwd(
        xw.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wproj.data_ptr(),
        bproj.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if qkv is None else qkv.data_ptr(),
        None if heads is None else heads.data_ptr(), out.data_ptr(), I, C, M,
        float(math.sqrt(HEAD_DIM)), 0 if dt == torch.float32 else 1,
        ROUTES[route], torch.cuda.current_stream(xw.device).cuda_stream)
    _build.check(rc, "swin_attention")
    count("swin_attention")
    return out


def _launch_bwd(xw, wqkv, bqkv, wproj, bproj, bias,
                smask: Optional[torch.Tensor], num_heads: int,
                dout) -> tuple:
    """The backward on the card: x wqkv and do = dout wproj^T by
    torch.matmul, the window core's kernel (q|k|v with their bias, o,
    dq|dk|dv and the bias cotangent's partial sums, added in order by
    col_sum), then the projections' gradients (``_dense_bwd``)."""
    I, N, C = xw.shape
    dt = xw.dtype
    if tuple(dout.shape) != (I, N, C) or dout.device != xw.device:
        raise ValueError(f"swin_attention cotangent must be [{I}, {N}, {C}] "
                         f"on {xw.device}, got {list(dout.shape)} on "
                         f"{dout.device}")
    if I == 0:
        return tuple(torch.zeros_like(t)
                     for t in (xw, wqkv, bqkv, wproj, bproj, bias))
    dout = dout.to(dt).contiguous()
    nh = num_heads
    M, mask = _mask_arg(smask, xw.device)
    # x.w_qkv, its bias added by the kernel as it stages q|k|v
    xq = (xw @ wqkv.to(dt)).contiguous()
    bq = bqkv.to(dt).contiguous()
    do = (dout @ wproj.to(dt).t()).contiguous()
    bias32 = bias.to(torch.float32).contiguous()
    heads = torch.empty_like(xw)
    dqkv = torch.empty_like(xq)
    # the windows split among groups of blocks, one partial each: enough
    # blocks (groups x heads) to fill the card about TARGET_BLOCKS deep
    groups = max(1, min(I, -(-TARGET_BLOCKS // nh)))
    part = torch.empty(groups, nh * N * N, dtype=torch.float32,
                       device=xw.device)
    rc = _build.library().swin_attention_bwd(
        xq.data_ptr(), bq.data_ptr(), do.data_ptr(), bias32.data_ptr(),
        None if mask is None else mask.data_ptr(), heads.data_ptr(),
        dqkv.data_ptr(), part.data_ptr(), I, C, M, groups,
        float(math.sqrt(HEAD_DIM)), dtype_code(dt), stream(xw))
    _build.check(rc, "swin_attention_bwd")
    count("swin_attention_bwd")
    dbias = col_sum(part).view(nh, N, N).to(bias.dtype)
    return (*_dense_bwd(xw, wqkv, bqkv, wproj, bproj, dout, dqkv, heads),
            dbias)
