"""Fused LayerNorm -> MLP -> residual of the Swin blocks,
``x + fc2(gelu(fc1(LN(x))))``: the plain PyTorch version and the CUDA
kernels (``csrc/swin_mlp.cu``), in four routes (``swin_mlp_route``).

Counterpart of medical_tri_modal_pilot_tpu/kernels/swin_mlp.py
(``xla_swin_mlp`` and ``pallas_swin_mlp``). Weights are in the JAX layout:
w1 [C, 4C], w2 [4C, C]; x is [R, C].

Training (the trainable trunk): a call that needs a gradient goes
through ``_SwinMlp``, whose forward is the kernel and whose backward, on
the card, is the backward kernels (``csrc/swin_mlp_bwd.cu``, the weight
sums on ``csrc/wgrad.cu``), as the JAX package's custom VJP takes
``jax.vjp`` of ``xla_swin_mlp`` (its ``_fused_bwd``). ``torch_swin_mlp_bwd``
is that backward's closed form, rounded where the kernels round; on the
CPU the gradient stays autograd of the plain version.
``torch_mlp_branch`` is the branch without the residual, which the
blocks under stochastic depth run instead of the fused op (JAX
``mlp_branch``, plain XLA there too).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._util import (count, dtype_code, needs_grad, recompute_grads,
                    recomputes, stream)
from .wgrad import col_sum, wgrad

LN_EPS = 1e-5
# the backward's LayerNorm pass: blocks to aim for (about eight per SM of
# an H100's 132), each at least 64 rows; one partial sum a block
BWD_LN_BLOCKS, BWD_LN_MIN_ROWS = 1024, 64
# the C entry point's routes: bf16 on the tensor cores, fused in one launch
# (the tile loop of csrc/mlp_tc.cuh) or split in two (LN-fused fc1 + GELU
# into a [R, 4C] scratch, then fc2 + residual); fp32 (the checking dtype)
# on FMA loops, fused at Swin-T's stage-1 width or split in three (LN, fc1
# + GELU, fc2 + residual)
ROUTES = {"fma_fused": 0, "fma_split": 1, "tc_fused": 2, "tc_split": 3}
# the one width the fp32 fused kernel is built for; the widest the bf16
# fused kernel takes (its accumulator, 16 x C fp32 a warp, in registers)
FMA_FUSED_WIDTH = 96
TC_FUSED_MAX = 256
# rows per tile of the fused tensor-core kernel (csrc/mlp_tc.cuh
# kMlpRows); the split form's fc1: W1 rows and columns per cp.async stage,
# stages in its ring
TC_ROWS = 128
FC1_DEPTH, FC1_COLS, FC1_STAGES = 32, 128, 3
SMEM_LIMIT = 232448


def tc_smem_bytes(C: int) -> int:
    """Shared memory of the bf16 route's LN-fused kernel at width C, as
    csrc/swin_mlp.cu reckons it (bf16 tiles of pitch width + 8): at C <=
    256 swin_mlp_tc_kernel, the LN rows [128][C] and a two-stage ring of
    a W1 chunk [C][64] and a W2 chunk [64][C] (a stage at least [128][C]:
    it takes the tile's x for the epilogue), then b2 in fp32; above,
    swin_fc1_tc_kernel, the LN rows [64][C] and a three-stage ring of W1
    slices [32][128]."""
    def tile(rows, width):
        return 2 * rows * (width + 8)
    if C <= TC_FUSED_MAX:
        stage = max(tile(C, 64) + tile(64, C), tile(TC_ROWS, C))
        return tile(TC_ROWS, C) + 2 * stage + 4 * C
    return tile(64, C) + FC1_STAGES * tile(FC1_DEPTH, FC1_COLS)


def swin_mlp_route(dtype: torch.dtype, C: int, split: bool = False) -> str:
    """The kernel route for x of this dtype and width: bf16 takes the
    tensor cores, fused at C <= 256 (Swin-T's stages 1 and 2) and split in
    two launches above (stages 3 and 4); fp32 keeps the FMA kernels, fused
    at C = 96 and split elsewhere. ``split``: the dtype's split route at
    any width. Raises for a width no kernel takes (C % 32 != 0; for bf16,
    an LN tile beyond a block's shared memory)."""
    if C <= 0 or C % 32 != 0 or (dtype == torch.bfloat16
                                 and tc_smem_bytes(C) > SMEM_LIMIT):
        raise ValueError(f"swin_mlp takes C % 32 == 0 (bf16: up to its "
                         f"shared memory); got C={C}")
    if dtype == torch.bfloat16:
        fused = C <= TC_FUSED_MAX and not split
        return "tc_fused" if fused else "tc_split"
    return ("fma_fused" if C == FMA_FUSED_WIDTH and not split
            else "fma_split")


def _branch(x, scale, bias, w1, b1, w2, b2) -> torch.Tensor:
    """fc2(gelu(fc1(LN(x)))) in fp32, no residual (JAX ``_branch``)."""
    dt = x.dtype
    h = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     LN_EPS).to(dt)
    h = h.float() @ w1.to(dt).float() + b1.float()
    h = F.gelu(h).to(dt)
    return h.float() @ w2.to(dt).float() + b2.float()


def torch_swin_mlp(x, scale, bias, w1, b1, w2, b2) -> torch.Tensor:
    """Rounds where xla_swin_mlp rounds: LN (fp32 statistics) to the
    compute dtype; fc1 accumulated in fp32 plus b1 in fp32; exact GELU in
    fp32, then to the compute dtype; fc2 accumulated in fp32 plus b2; x
    added in fp32, then the result cast. The products run on fp32 copies of
    the compute-dtype operands, which is fp32 accumulation of the same
    terms. JAX's kernel uses a polynomial erf (error < 1.5e-7); this is the
    real one."""
    return (x.float() + _branch(x, scale, bias, w1, b1, w2, b2)).to(x.dtype)


def torch_mlp_branch(x, scale, bias, w1, b1, w2, b2) -> torch.Tensor:
    """The branch alone, cast to x's dtype (JAX ``mlp_branch``): the
    stochastic-depth blocks scale it before they add it back."""
    return _branch(x, scale, bias, w1, b1, w2, b2).to(x.dtype)


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """GELU's derivative (exact erf form), as torch's GeluBackward:
    Phi(h) + h phi(h)."""
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    return cdf + h * torch.exp(-0.5 * h * h) * 0.3989422804014327


def torch_swin_mlp_bwd(x, scale, bias, w1, b1, w2, b2, dy) -> tuple:
    """The gradients of torch_swin_mlp's output for the cotangent ``dy``
    [R, C] with respect to (x, scale, bias, w1, b1, w2, b2), each in its
    input's dtype: the closed form the backward kernels compute, rounded
    where they round (T the compute dtype, x's): ln = T(LN(x)), the
    statistics in fp32 (biased variance); dg = T(dy w2^T); h = ln w1 + b1
    in fp32, g = T(gelu(h)), dh = T(dg gelu'(h)); dln = T(dh w1^T); the
    LayerNorm backward in fp32, dx = T(dy + T(dx_ln)); dscale = sum dln n,
    dbias = sum dln; dw1 = T(ln^T dh), db1 = sum dh, dw2 = T(g^T dy), db2 =
    sum dy, summed in fp32. Autograd of the plain version rounds at the
    same points but keeps dh in fp32 (the kernels' weight sums read it in
    T)."""
    dt = x.dtype
    f32 = lambda t: t.to(dt).float()
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + LN_EPS)
    n = (xf - mu) * inv
    ln = f32(n * scale.float() + bias.float())
    dyf = dy.float()
    dg = f32(dyf @ f32(w2).t())
    h = ln @ f32(w1) + b1.float()
    g = f32(F.gelu(h))
    dh = f32(dg * gelu_grad(h))
    dln = f32(dh @ f32(w1).t())
    dn = dln * scale.float()
    dx_ln = inv * (dn - dn.mean(-1, keepdim=True)
                   - n * (dn * n).mean(-1, keepdim=True))
    dx = (dyf + f32(dx_ln)).to(dt)
    return (dx, (dln * n).sum(0).to(scale.dtype), dln.sum(0).to(bias.dtype),
            f32(ln.t() @ dh).to(w1.dtype), dh.sum(0).to(b1.dtype),
            f32(g.t() @ dyf).to(w2.dtype), dyf.sum(0).to(b2.dtype))


def cuda_swin_mlp(x, scale, bias, w1, b1, w2, b2,
                  split: bool = False) -> torch.Tensor:
    """Launch the kernels of ``swin_mlp_route`` on a CUDA x [R, C] (fp32
    or bf16), through ``_SwinMlp`` when a gradient is needed;
    ``split=True`` takes the dtype's split route at any width."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if needs_grad(*args):
        return _SwinMlp.apply(*args, split)
    return _launch_fwd(*args, split)


def cuda_swin_mlp_bwd(x, scale, bias, w1, b1, w2, b2, dy) -> tuple:
    """The backward kernels on CUDA tensors: torch_swin_mlp_bwd's
    gradients (dx, dscale, dbias, dw1, db1, dw2, db2)."""
    return _launch_bwd(x, scale, bias, w1, b1, w2, b2, dy)


class _SwinMlp(torch.autograd.Function):
    """The forward kernels; the backward kernels on the card. On the CPU
    (the tests' stand-in for the forward kernel) the backward recomputes
    torch_swin_mlp under autograd, counted in ``recomputes``."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, split):
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        return _launch_fwd(x, scale, bias, w1, b1, w2, b2, split)

    @staticmethod
    def backward(ctx, dout):
        needs = ctx.needs_input_grad[:7]
        if dout.device.type == "cuda":
            grads = _launch_bwd(*ctx.saved_tensors, dout)
            grads = [g if n else None for g, n in zip(grads, needs)]
        else:
            grads = recompute_grads(torch_swin_mlp, ctx.saved_tensors, needs,
                                    (), dout)
            recomputes["swin_mlp_bwd"] += 1
        return (*grads, None)


def _operands(x, scale, bias, w1, b1, w2, b2, split: bool = False):
    """(route, w1, w2 in x's dtype, scale, bias, b1, b2 in fp32), all
    contiguous on x's card, after the checks both directions make."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"swin_mlp takes fp32 or bf16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"swin_mlp needs x [R, C], got {tuple(x.shape)}")
    R, C = x.shape
    Fh = w1.shape[-1]
    route = swin_mlp_route(x.dtype, C, split)
    if Fh <= 0 or Fh % 64 != 0:
        raise ValueError(f"swin_mlp takes a hidden width that is a multiple "
                         f"of 64; got {Fh}")
    if tuple(w1.shape) != (C, Fh) or tuple(w2.shape) != (Fh, C):
        raise ValueError(f"swin_mlp weights must be [{C}, {Fh}] and "
                         f"[{Fh}, {C}], got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"cuda_swin_mlp needs CUDA tensors, got {x.device}")
    if not x.is_contiguous():
        raise ValueError("swin_mlp needs a contiguous x")
    dt = x.dtype
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    vecs = [t.to(torch.float32).contiguous() for t in (scale, bias, b1, b2)]
    for t in (w1, w2, *vecs):
        if t.device != x.device:
            raise ValueError(f"swin_mlp operands on {t.device}, x on "
                             f"{x.device}")
    return (route, w1, w2, *vecs)


def _launch_fwd(x, scale, bias, w1, b1, w2, b2,
                split: bool = False) -> torch.Tensor:
    """The checks and the kernels' launches (the scratches the split
    routes need are allocated here)."""
    route, w1, w2, scale, bias, b1, b2 = _operands(x, scale, bias, w1, b1,
                                                   w2, b2, split)
    R, C = x.shape
    Fh = w1.shape[-1]
    dt = x.dtype
    y = torch.empty_like(x)
    if R == 0:
        return y
    ln = hidden = None
    if route.endswith("split"):
        hidden = torch.empty(R, Fh, dtype=dt, device=x.device)
    if route == "fma_split":
        ln = torch.empty_like(x)
    rc = _build.library().swin_mlp_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if ln is None else ln.data_ptr(),
        None if hidden is None else hidden.data_ptr(), y.data_ptr(), R, C,
        Fh, ROUTES[route], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "swin_mlp")
    count("swin_mlp")
    return y


def _launch_bwd(x, scale, bias, w1, b1, w2, b2, dy) -> tuple:
    """The backward on the card: the row passes of csrc/swin_mlp_bwd.cu
    (ln, g, dh, dln, dx and the LN parameters' per-block sums), then the
    weight sums on wgrad.cu and the blocks' sums added in order; each
    gradient in its input's dtype, the weights' rounded to x's first, as
    autograd of the plain version rounds them."""
    params = (scale, bias, w1, b1, w2, b2)
    _, w1c, w2c, sc, bi, b1c, _ = _operands(x, *params)
    R, C = x.shape
    Fh = w1c.shape[-1]
    dt = x.dtype
    if tuple(dy.shape) != (R, C) or dy.device != x.device:
        raise ValueError(f"swin_mlp cotangent must be [{R}, {C}] on "
                         f"{x.device}, got {list(dy.shape)} on {dy.device}")
    if R == 0:
        return (torch.zeros_like(x),
                *(torch.zeros_like(t) for t in params))
    dy = dy.to(dt).contiguous()
    x = x.contiguous()
    ln, dln, dx = (torch.empty_like(x) for _ in range(3))
    g, dh = (torch.empty(R, Fh, dtype=dt, device=x.device) for _ in range(2))
    ln_rows = max(BWD_LN_MIN_ROWS, -(-R // BWD_LN_BLOCKS))
    gpart = torch.empty(-(-R // ln_rows), 2 * C, dtype=torch.float32,
                        device=x.device)
    rc = _build.library().swin_mlp_bwd(
        x.data_ptr(), sc.data_ptr(), bi.data_ptr(), w1c.data_ptr(),
        b1c.data_ptr(), w2c.data_ptr(), dy.data_ptr(), ln.data_ptr(),
        g.data_ptr(), dh.data_ptr(), dln.data_ptr(), dx.data_ptr(),
        gpart.data_ptr(), R, C, Fh, ln_rows, dtype_code(dt), stream(x))
    _build.check(rc, "swin_mlp_bwd")
    count("swin_mlp_bwd")
    dw1, db1 = wgrad(ln, dh)
    dw2, db2 = wgrad(g, dy)
    ln_sums = col_sum(gpart)
    return (dx, ln_sums[:C].to(scale.dtype), ln_sums[C:].to(bias.dtype),
            dw1.to(dt).to(w1.dtype), db1.to(b1.dtype),
            dw2.to(dt).to(w2.dtype), db2.to(b2.dtype))
