"""The compact MaxViT of ``--img-model-type maxvit`` (counterpart of
medical_tri_modal_pilot_tpu/models/maxvit.py): a stem of two 3 x 3
convolutions, then four stages, each block an ``MBConv`` (pre-BatchNorm,
1 x 1 expansion, 3 x 3 depthwise, squeeze-excite, 1 x 1 projection), a
block attention (contiguous 7 x 7 windows) and a grid attention (the map
strided into 7 x 7 groups). Widths 64/128/256/512, 2/4/8/16 heads, depth
2 a stage: 224 -> 112 -> 56 -> 28 -> 14 -> 7.

The names are the flax tree's (``stem1``, ``s{stage}_mbconv{i}``,
``s{stage}_block{i}``, ``s{stage}_grid{i}``). The feature map stays NHWC
between the blocks, as in the JAX module; the MBConv runs NCHW. Its
GELU is flax's default, the tanh approximation; its LayerNorms the port's
(eps 1e-5), its BatchNorms flax's (``models/resnet.py::BatchNorm``). No
TPU kernel runs here in the JAX package, so this is plain PyTorch on
every device.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .modules import LayerNorm, dense
from .resnet import BatchNorm, Conv
from .vit import FlaxAttention


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _window(x, size: int, grid: bool):
    """[B, H, W, C] -> [B n, size^2, C]: contiguous windows, or with
    ``grid`` the groups of a stride-(H / size) lattice."""
    B, H, W, C = x.shape
    if grid:
        x = x.reshape(B, size, H // size, size, W // size, C)
        x = x.permute(0, 2, 4, 1, 3, 5)
    else:
        x = x.reshape(B, H // size, size, W // size, size, C)
        x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, size * size, C)


def _unwindow(x, size: int, grid: bool, H: int, W: int):
    C = x.shape[-1]
    x = x.reshape(-1, H // size, W // size, size, size, C)
    if grid:
        x = x.permute(0, 3, 1, 4, 2, 5)
    else:
        x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, H, W, C)


class MBConv(nn.Module):

    def __init__(self, cin: int, features: int, stride: int = 1,
                 expand: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = features * expand
        self.compute_dtype = dtype
        self.stride = stride
        self.pre_bn = BatchNorm(cin)
        self.expand_conv = Conv(cin, mid, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(mid)
        self.dw_conv = Conv(mid, mid, 3, stride, False, groups=mid,
                            dtype=dtype)
        self.bn2 = BatchNorm(mid)
        self.se1 = nn.Linear(mid, mid // 16)
        self.se2 = nn.Linear(mid // 16, mid)
        self.project_conv = Conv(mid, features, 1, bias=False, dtype=dtype)
        if stride != 1 or cin != features:
            self.shortcut = Conv(cin, features, 1, stride, dtype=dtype)

    def forward(self, x):                                # NHWC
        dt = self.compute_dtype
        x = x.permute(0, 3, 1, 2)
        y = _gelu(self.bn1(self.expand_conv(self.pre_bn(x))))
        y = _gelu(self.bn2(self.dw_conv(y)))
        s = _gelu(dense(self.se1, y.mean(dim=(2, 3)), dt))
        y = y * torch.sigmoid(dense(self.se2, s, dt))[:, :, None, None]
        y = self.project_conv(y)
        if hasattr(self, "shortcut"):
            if self.stride == 1:
                # flax avg_pool, SAME: the padded zeros count
                x = F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
            x = self.shortcut(x)
        return (y + x).permute(0, 2, 3, 1)


class WindowAttention(nn.Module):
    """x + MHA over windows (or grid groups) of LN(x), then x + MLP(LN(x))
    (JAX ``_WindowAttention``)."""

    def __init__(self, dim: int, heads: int, window: int, grid: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.grid = window, grid
        self.compute_dtype = dtype
        self.ln = LayerNorm(dim, dtype)
        self.attn = FlaxAttention(dim, heads, dtype)
        self.mlp_ln = LayerNorm(dim, dtype)
        self.mlp1 = nn.Linear(dim, 4 * dim)
        self.mlp2 = nn.Linear(4 * dim, dim)

    def forward(self, x):                                # NHWC
        _, H, W, _ = x.shape
        dt = self.compute_dtype
        y = self.attn(_window(self.ln(x), self.window, self.grid))
        x = x + _unwindow(y, self.window, self.grid, H, W)
        y = _gelu(dense(self.mlp1, self.mlp_ln(x), dt))
        return x + dense(self.mlp2, y, dt)


class MaxViT(nn.Module):
    """[B, 1, H, W] -> the final NHWC map [B, H / 32, W / 32, 512]."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 heads: Sequence[int] = (2, 4, 8, 16), window: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem1 = Conv(1, 64, 3, 2, dtype=dtype)
        self.stem2 = Conv(64, 64, 3, dtype=dtype)
        self.names = []
        cin = 64
        for stage, (width, depth, h) in enumerate(zip(widths, depths,
                                                      heads)):
            for i in range(depth):
                blocks = (MBConv(cin, width, 2 if i == 0 else 1,
                                 dtype=dtype),
                          WindowAttention(width, h, window, False, dtype),
                          WindowAttention(width, h, window, True, dtype))
                for kind, blk in zip(("mbconv", "block", "grid"), blocks):
                    self.add_module(f"s{stage}_{kind}{i}", blk)
                    self.names.append(f"s{stage}_{kind}{i}")
                cin = width
        self.feature_dim = cin

    def forward(self, x):
        x = self.stem2(_gelu(self.stem1(x)))
        x = x.permute(0, 2, 3, 1)
        for name in self.names:
            x = getattr(self, name)(x)
        return x
