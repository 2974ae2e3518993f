"""Launch counts and checks shared by the kernel wrappers.

``launches`` counts, per kernel, the wrapper calls that launched it on the
card; each wrapper adds one where it launches and nowhere else (a wrapper
may run several CUDA launches for one call, as the two-pass attention
forward does). The attention block counts its 3-D block-mask form apart
(``attn_block_3d``, ``attn_block_3d_bwd``). ``ops`` re-exports the dict.

The Swin kernels' backwards (the trainable trunk's gradients: the JAX
package takes them by ``jax.vjp`` of its XLA oracles, no kernel of its
own) count as ``swin_attention_bwd`` and ``swin_mlp_bwd`` where their
backward kernels launch. ``recomputes`` counts, under the same names, the
backward passes that recompute the plain version under autograd instead:
those of CPU tensors; on the card it stays 0.
"""
from __future__ import annotations

import torch

KERNELS = ("umse", "umse_bwd", "attn_block", "attn_block_bwd",
           "attn_block_3d", "attn_block_3d_bwd", "ffn", "ffn_bwd",
           "dropout_masks", "swin_attention", "swin_mlp", "attention",
           "attention_bwd", "rowmm_ln", "rowmm_ln_bwd", "rowmm", "rowmm_bwd",
           "swin_attention_bwd", "swin_mlp_bwd")
launches = {name: 0 for name in KERNELS}
RECOMPUTES = ("swin_attention_bwd", "swin_mlp_bwd")
recomputes = {name: 0 for name in RECOMPUTES}


def count(name: str) -> None:
    launches[name] += 1


def needs_grad(*tensors) -> bool:
    """True when autograd will differentiate through these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def recompute_grads(plain, saved, needs, args, dout):
    """The backward of a kernel whose gradients are autograd of its plain
    version: ``plain(*inputs, *args)`` recomputed from the ``saved``
    inputs, differentiated for those that ``needs`` marks; None for the
    rest."""
    inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
    with torch.enable_grad():
        out = plain(*inputs, *args)
    want = [t for t, n in zip(inputs, needs) if n]
    got = iter(torch.autograd.grad(out, want, dout) if want else ())
    return [next(got) if n else None for n in needs]


def dtype_code(dt: torch.dtype) -> int:
    """The C entry points' dtype argument: 0 fp32, 1 bf16."""
    return 0 if dt == torch.float32 else 1


def stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
