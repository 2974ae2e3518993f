"""The MONAI-shape ResNet-18/50 of the uni-image family (counterpart of
medical_tri_modal_pilot_tpu/models/resnet.py; reference builder/models/
2_uni_image/resnet.py:9-18): block widths 32/64/128/256, a 7 x 7 stride-2
stem, one input channel, ``BasicBlock`` below depth 50, else
``BottleneckBlock`` (output 4x its width).

The modules keep the flax names (``conv1``, ``bn1``, ``layer{s}_{i}``,
``downsample``, ``down_bn``), so ``models/convert.py`` carries the JAX
weights across leaf for leaf. The layout is torch's NCHW; the
computation is flax's: convolutions pad as XLA's SAME does (the odd
extra row and column after), the max pool pads with -inf, and every
BatchNorm is flax's (``batch_norm``: momentum 0.99, eps 1e-5, the biased
batch variance, statistics in fp32). No TPU kernel runs here in the JAX
package, so these are plain PyTorch on every device.

``Conv`` and ``BatchNorm`` also serve ``models/maxvit.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

_LAYERS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}
_INPLANES = (32, 64, 128, 256)
# flax nn.BatchNorm's default
BN_MOMENTUM = 0.99


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis of length n, kernel k, stride s:
    (before, after), the odd one after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    (t, b), (lf, r) = (same_padding(x.shape[2], k, s),
                       same_padding(x.shape[3], k, s))
    return F.pad(x, (lf, r, t, b), value=value)


class Conv(nn.Conv2d):
    """flax ``nn.Conv`` over NCHW: SAME padding, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = True, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, k, stride=stride, bias=bias,
                         groups=groups)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        x = _pad_same(x.to(dt), self.kernel_size[0], self.stride[0])
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x, self.weight.to(dt), bias, self.stride, 0, 1,
                        self.groups)


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` over the channels of NCHW x (see the module
    docstring): eval normalises with the running statistics; training
    with the batch's (var = E[x^2] - E[x]^2, floored at 0) and moves the
    running ones by ``momentum`` toward them. Output in x's dtype."""

    def __init__(self, channels: int, momentum: float = BN_MOMENTUM):
        super().__init__(channels, eps=1e-5)
        self.flax_momentum = momentum

    def forward(self, x):
        h = x.float()
        if not self.training:
            return F.batch_norm(h, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0,
                                self.eps).to(x.dtype)
        mean = h.mean(dim=(0, 2, 3))
        var = ((h * h).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        out = (h - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return out.to(x.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, False, dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, 1, False, dtype=dtype)
        self.bn2 = BatchNorm(features)
        if stride != 1 or cin != features:
            self.downsample = Conv(cin, features, 1, stride, False,
                                   dtype=dtype)
            self.down_bn = BatchNorm(features)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if hasattr(self, "downsample"):
            x = self.down_bn(self.downsample(x))
        return torch.relu(y + x)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        out = 4 * features
        self.conv1 = Conv(cin, features, 1, 1, False, dtype=dtype)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, 3, stride, False, dtype=dtype)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, out, 1, 1, False, dtype=dtype)
        self.bn3 = BatchNorm(out)
        if stride != 1 or cin != out:
            self.downsample = Conv(cin, out, 1, stride, False, dtype=dtype)
            self.down_bn = BatchNorm(out)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "downsample"):
            x = self.down_bn(self.downsample(x))
        return torch.relu(y + x)


class ResNet(nn.Module):
    """[B, 1, H, W] -> the final map [B, C, H/32, W/32] (C = 256, or 1024
    at depth 50)."""

    def __init__(self, num_layers: int = 18,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block = BasicBlock if num_layers < 50 else BottleneckBlock
        self.conv1 = Conv(1, 64, 7, 2, False, dtype=dtype)
        self.bn1 = BatchNorm(64)
        cin = 64
        for stage, (depth, width) in enumerate(zip(_LAYERS[num_layers],
                                                   _INPLANES)):
            for i in range(depth):
                stride = 2 if (i == 0 and stage > 0) else 1
                setattr(self, f"layer{stage}_{i}",
                        block(cin, width, stride, dtype))
                cin = width * block.expansion
        self.depths = _LAYERS[num_layers]
        self.feature_dim = cin

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(_pad_same(x, 3, 2, float("-inf")), 3, 2)
        for stage, depth in enumerate(self.depths):
            for i in range(depth):
                x = getattr(self, f"layer{stage}_{i}")(x)
        return x
