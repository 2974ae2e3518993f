"""ViT-B/16 returning the whole token sequence (counterpart of
medical_tri_modal_pilot_tpu/models/vit.py; the reference's truncated
torchvision copy, src/vision_transformer.py:290-307): a 16 x 16 stride-16
convolution (``conv_proj``), the class token, learned positions, twelve
pre-norm blocks of 12 heads at 768, the final LayerNorm ``ln``.

The names are the flax tree's (``encoder_layer_{i}.ln_1``,
``.self_attention.{query,key,value,out}``, ``.mlp_fc1``, ``.mlp_fc2``).
Its LayerNorms are flax's own (eps 1e-6), its GELU the exact one.
``FlaxAttention`` is flax's ``MultiHeadDotProductAttention`` (no mask, no
dropout) and serves ``models/maxvit.py`` too. The JAX package runs no
Pallas kernel here, so these are plain PyTorch on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import LayerNorm, dense


class FlaxAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over x [N, L, C]: the q, k, v
    DenseGenerals to (heads, C / heads) and ``out`` back to C, each with a
    bias, held as ``nn.Linear`` over the flattened heads."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = dtype
        for name in ("query", "key", "value", "out"):
            setattr(self, name, nn.Linear(dim, dim))

    def forward(self, x):
        N, L, C = x.shape
        dt, H = self.compute_dtype, self.heads
        q, k, v = (dense(getattr(self, n), x, dt).reshape(N, L, H, C // H)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        o = F.scaled_dot_product_attention(q, k, v)
        return dense(self.out, o.transpose(1, 2).reshape(N, L, C), dt)


class ViTBlock(nn.Module):

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.ln_1 = LayerNorm(dim, dtype, eps=1e-6)
        self.self_attention = FlaxAttention(dim, heads, dtype)
        self.ln_2 = LayerNorm(dim, dtype, eps=1e-6)
        self.mlp_fc1 = nn.Linear(dim, mlp_dim)
        self.mlp_fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        dt = self.compute_dtype
        x = x + self.self_attention(self.ln_1(x))
        h = F.gelu(dense(self.mlp_fc1, self.ln_2(x), dt))
        return x + dense(self.mlp_fc2, h, dt)


class VisionTransformer(nn.Module):
    """[B, 1, H, W] -> tokens [B, 1 + (H / 16)(W / 16), 768], the class
    token first."""

    def __init__(self, in_channels: int = 1, image_size: int = 224,
                 patch_size: int = 16, num_layers: int = 12,
                 num_heads: int = 12, hidden_dim: int = 768,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.feature_dim = hidden_dim
        self.conv_proj = nn.Conv2d(in_channels, hidden_dim, patch_size,
                                   stride=patch_size)
        n = (image_size // patch_size) ** 2
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n + 1, hidden_dim))
        self.layers = num_layers
        for i in range(num_layers):
            setattr(self, f"encoder_layer_{i}",
                    ViTBlock(hidden_dim, num_heads, mlp_dim, dtype))
        self.ln = LayerNorm(hidden_dim, dtype, eps=1e-6)

    def forward(self, x):
        dt = self.compute_dtype
        conv = self.conv_proj
        x = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     conv.stride)
        x = x.flatten(2).transpose(1, 2)                  # [B, N, C]
        B, _, C = x.shape
        x = torch.cat([self.class_token.expand(B, 1, C).to(dt), x], dim=1)
        x = x + self.pos_embedding.to(dt)
        for i in range(self.layers):
            x = getattr(self, f"encoder_layer_{i}")(x)
        return self.ln(x)
