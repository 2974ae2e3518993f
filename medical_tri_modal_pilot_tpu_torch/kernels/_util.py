"""Launch counts and checks shared by the kernel wrappers.

``launches`` counts, per kernel, the wrapper calls that launched it on the
card; each wrapper adds one where it launches and nowhere else (a wrapper
may run several CUDA launches for one call, as the two-pass attention
forward does). ``ops`` re-exports the dict.
"""
from __future__ import annotations

import torch

KERNELS = ("umse", "attn_block", "attn_block_bwd", "ffn", "ffn_bwd",
           "dropout_masks", "swin_attention", "swin_mlp", "attention",
           "attention_bwd", "rowmm_ln", "rowmm_ln_bwd", "rowmm", "rowmm_bwd")
launches = {name: 0 for name in KERNELS}


def count(name: str) -> None:
    launches[name] += 1


def needs_grad(*tensors) -> bool:
    """True when autograd will differentiate through these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def forward_only(name: str, *tensors: torch.Tensor) -> None:
    """For kernels with no backward (the frozen Swin trunk's): refuse inputs
    that autograd would need to differentiate through."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is forward only; run it under "
            "torch.inference_mode() or torch.no_grad()")


def dtype_code(dt: torch.dtype) -> int:
    """The C entry points' dtype argument: 0 fp32, 1 bf16."""
    return 0 if dt == torch.float32 else 1


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
