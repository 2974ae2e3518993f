"""Fused LayerNorm -> MLP -> residual of the Swin blocks,
``x + fc2(gelu(fc1(LN(x))))``: the plain PyTorch version and the CUDA
kernels (``csrc/swin_mlp.cu``), in four routes (``swin_mlp_route``).

Counterpart of medical_tri_modal_pilot_tpu/kernels/swin_mlp.py
(``xla_swin_mlp`` and ``pallas_swin_mlp``). Weights are in the JAX layout:
w1 [C, 4C], w2 [4C, C]; x is [R, C].

Training (the trainable trunk): a call that needs a gradient goes
through ``_SwinMlp``, whose forward is the kernel and whose backward
recomputes the plain version under autograd, as the JAX package's custom
VJP takes ``jax.vjp`` of ``xla_swin_mlp`` (its ``_fused_bwd``).
``torch_mlp_branch`` is the branch without the residual, which the
blocks under stochastic depth run instead of the fused op (JAX
``mlp_branch``, plain XLA there too).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._util import count, needs_grad, recompute_grads, recomputes

LN_EPS = 1e-5
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


def cuda_swin_mlp(x, scale, bias, w1, b1, w2, b2,
                  split: bool = False) -> torch.Tensor:
    """Launch the kernels of ``swin_mlp_route`` on a CUDA x [R, C] (fp32
    or bf16), through ``_SwinMlp`` when a gradient is needed;
    ``split=True`` takes the dtype's split route at any width."""
    args = (x, scale, bias, w1, b1, w2, b2)
    if needs_grad(*args):
        return _SwinMlp.apply(*args, split)
    return _launch_fwd(*args, split)


class _SwinMlp(torch.autograd.Function):
    """The forward kernels; the backward recomputes torch_swin_mlp under
    autograd (counted in ``recomputes``, not ``launches``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, w1, b1, w2, b2, split):
        ctx.save_for_backward(x, scale, bias, w1, b1, w2, b2)
        return _launch_fwd(x, scale, bias, w1, b1, w2, b2, split)

    @staticmethod
    def backward(ctx, dout):
        grads = recompute_grads(torch_swin_mlp, ctx.saved_tensors,
                                ctx.needs_input_grad[:7], (), dout)
        recomputes["swin_mlp_bwd"] += 1
        return (*grads, None)


def _launch_fwd(x, scale, bias, w1, b1, w2, b2,
                split: bool = False) -> torch.Tensor:
    """The checks and the kernels' launches (the scratches the split
    routes need are allocated here)."""
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
    scale, bias, b1, b2 = vecs
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
