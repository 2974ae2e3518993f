"""Swin-T image encoder (counterpart of
medical_tri_modal_pilot_tpu/models/swin.py): swin_t geometry (patch 4,
window 7, depths [2, 2, 6, 2], heads [3, 6, 12, 24], embed 96) returning
the pre-pool feature map [B, H/32, W/32, 8 * embed], and the patch stem
``PatchStem`` (JAX ``PatchEmbed``, the image stem of ``tri_mbt_v3`` and of
every ``--img-model-type`` but swin and vit).

Channels-last (NHWC) inside, as in the JAX package and torchvision. The
window attention and the LN -> MLP -> residual half of every block go
through ``ops.swin_attention`` and ``ops.swin_mlp`` (the CUDA kernels on the
card); roll, window partition, patch merging and the patch embedding stay
plain PyTorch, as they stay outside the Pallas kernels in JAX.

The trunk trains where the model says (``--img-pretrain No``,
``tri_mbt_v2``, ``fusiontrainer``): both ops are then autograd Functions
(their backward the plain version's, recomputed), the relative-position
bias is gathered from its table under autograd, and in training mode
block k of n drops its residual branches with probability 0.2 k / (n - 1)
(torchvision's row-mode stochastic depth, JAX swin.py:152-194): one keep
draw per image row, kept rows scaled by 1 / keep, the draws Philox from
the step's ``DropoutSeeds`` (``ops.dropout_masks``, two a block: the
attention's, then the MLP's). A block under stochastic depth runs the
MLP branch as plain PyTorch (``torch_mlp_branch``) and adds the dropped
branch, as the JAX block does; block 0 (probability 0) and every eval call
keep the fused ``ops.swin_mlp``.

Parameter names are torchvision's ``swin_t`` ``state_dict`` keys
(``features.0.0`` conv, ``features.0.2`` its LN, ``features.{1,3,5,7}.{b}``
blocks, ``features.{2,4,6}`` merges, ``norm``), so the JAX package's
``models/convert.py::convert_swin_t`` maps them onto the flax tree. The
stem has one input channel (grayscale CXRs). Patch merging concatenates in
torchvision's order [x0::2,0::2, x1::2,0::2, x0::2,1::2, x1::2,1::2].
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..kernels.swin_mlp import torch_mlp_branch
from .modules import DropoutSeeds, LayerNorm, draw_seed

# the last block's stochastic-depth probability (torchvision's swin_t)
STOCHASTIC_DEPTH = 0.2


def _rel_position_index(window: int) -> np.ndarray:
    """[(W*W), (W*W)] index into the (2W-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))            # [2, W, W]
    flat = coords.reshape(2, -1)                              # [2, W*W]
    rel = flat[:, :, None] - flat[:, None, :]                 # [2, N, N]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)                                        # [N, N]


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """bool [nW, N, N]; True = masked. Standard shifted-window mask."""
    img_mask = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    mw = img_mask.reshape(h // window, window, w // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return mw[:, :, None] != mw[:, None, :]


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.shift = shift
        self.compute_dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_rel_position_index(window).reshape(-1)),
            persistent=False)
        self._geometry: Dict[tuple, Tuple[Optional[torch.Tensor], int]] = {}
        self._bias_key: Optional[tuple] = None
        self._bias: Optional[torch.Tensor] = None

    def geometry(self, H: int, W: int, device: torch.device
                 ) -> Tuple[Optional[torch.Tensor], int]:
        """(shift mask [nW, N, N] bool or None, shift) for an H x W map,
        computed once per module, map size and device. The shift is
        clamped to 0 when the window covers the map, as torchvision does
        (swin_t's last stage)."""
        key = (H, W, device)
        if key not in self._geometry:
            win = self.window
            shift = 0 if win >= min(H, W) else self.shift
            smask = (torch.from_numpy(_shift_attn_mask(H, W, win, shift))
                     .to(device) if shift > 0 else None)
            self._geometry[key] = (smask, shift)
        return self._geometry[key]

    def live_bias(self) -> torch.Tensor:
        """The bias [nh, N, N] fp32 gathered from the table under autograd
        (the trainable trunk: its cotangent reaches the table)."""
        N = self.window * self.window
        return (self.relative_position_bias_table[
            self.relative_position_index].reshape(N, N, self.num_heads)
            .permute(2, 0, 1).float().contiguous())

    def frozen_bias(self) -> torch.Tensor:
        """The bias without autograd, gathered again only when the table
        changes (a load, an in-place update or a move to another
        device)."""
        table = self.relative_position_bias_table
        key = (table.device, table.data_ptr(), table._version)
        if key != self._bias_key:
            with torch.no_grad():
                self._bias = self.live_bias()
            self._bias_key = key
        return self._bias

    def forward(self, x):  # x: [B, H, W, C]
        B, H, W, C = x.shape
        win = self.window
        smask, shift = self.geometry(H, W, x.device)
        if (torch.is_grad_enabled()
                and self.relative_position_bias_table.requires_grad):
            bias = self.live_bias()
        else:
            bias = self.frozen_bias()
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        nH, nW = H // win, W // win
        xw = x.reshape(B, nH, win, nW, win, C).permute(0, 1, 3, 2, 4, 5)
        xw = xw.reshape(B * nH * nW, win * win, C).to(self.compute_dtype)
        out = ops.swin_attention(
            xw.contiguous(), self.qkv.weight.t(), self.qkv.bias,
            self.proj.weight.t(), self.proj.bias, bias, smask,
            self.num_heads)
        out = out.reshape(B, nH, nW, win, win, C).permute(0, 1, 3, 2, 4, 5)
        out = out.reshape(B, H, W, C)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return out


class SwinBlock(nn.Module):
    """x + attn(norm1(x)), then x + mlp(norm2(x)) through ``ops.swin_mlp``
    (norm2 and mlp hold the parameters; the fused op applies them). In
    training mode with ``sd_prob`` > 0 each branch is dropped per image
    row (stochastic depth) and the MLP branch runs unfused."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32,
                 sd_prob: float = 0.0):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.compute_dtype = dtype
        self.sd_prob = sd_prob
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = WindowAttention(dim, num_heads, window, shift, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        # torchvision's MLP: Linear, GELU, Dropout, Linear, Dropout
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(),
                                 nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def drop_path(self, h: torch.Tensor,
                  seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """Row-mode stochastic depth (JAX ``_stochastic_depth``): the rows
        of h [B, ...] kept with probability 1 - sd_prob, by the Philox
        mask of the step's next seed (``ops.dropout_masks`` over B rows of
        one column), and divided by it."""
        p = self.sd_prob
        _, keep = ops.dropout_masks(h.shape[0], 0, 1, draw_seed(seeds), p,
                                    h.device)
        q = torch.tensor(1.0 - p, dtype=h.dtype, device=h.device)
        keep = keep.reshape((h.shape[0],) + (1,) * (h.dim() - 1))
        return torch.where(keep, h / q, 0.0)

    def forward(self, x, seeds: Optional[DropoutSeeds] = None):
        sd_on = self.training and self.sd_prob > 0.0
        h = self.attn(self.norm1(x))
        x = x + (self.drop_path(h, seeds) if sd_on else h)
        B, H, W, C = x.shape
        fc1, fc2 = self.mlp[0], self.mlp[3]
        args = (x.reshape(-1, C).to(self.compute_dtype), self.norm2.weight,
                self.norm2.bias, fc1.weight.t(), fc1.bias, fc2.weight.t(),
                fc2.bias)
        if sd_on:
            o = torch_mlp_branch(*args).reshape(B, H, W, C)
            return x + self.drop_path(o, seeds)
        return ops.swin_mlp(*args).reshape(B, H, W, C)


class PatchMerging(nn.Module):
    """[B, H, W, C] -> [B, H/2, W/2, 2C]: LN over the four neighbours
    concatenated in torchvision's order, then a bias-free reduction."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.norm = LayerNorm(4 * dim, dtype)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        x = self.norm(x)
        return F.linear(x, self.reduction.weight.to(self.compute_dtype))


class PatchEmbed(nn.Sequential):
    """torchvision's ``features[0]``: Conv2d(k = stride = patch), Permute,
    LayerNorm. The convolution runs as its equivalent product over
    non-overlapping patches, which emits NHWC directly (and in fp32 is
    never TF32, unlike a cuDNN convolution)."""

    def __init__(self, in_channels: int, dim: int, patch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Conv2d(in_channels, dim, patch, stride=patch),
                         nn.Identity(), LayerNorm(dim, dtype))
        self.patch = patch
        self.compute_dtype = dtype

    def forward(self, x):  # [B, C, H, W]
        conv, _, norm = self
        B, Cin, H, W = x.shape
        p, dt = self.patch, self.compute_dtype
        x = x.reshape(B, Cin, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, H // p, W // p, Cin * p * p)
        x = F.linear(x.to(dt), conv.weight.reshape(conv.out_channels, -1)
                     .to(dt), conv.bias.to(dt))
        return norm(x)


class SwinTransformer(nn.Module):
    """swin_t geometry; returns the pre-pool [B, H/32, W/32, 768] map.
    Block k of n drops with probability STOCHASTIC_DEPTH k / (n - 1)."""

    def __init__(self, in_channels: int = 1, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = [PatchEmbed(in_channels, embed_dim, patch_size, dtype)]
        dim = embed_dim
        total, block = sum(depths), 0
        for si, depth in enumerate(depths):
            blocks = []
            for bi in range(depth):
                blocks.append(SwinBlock(
                    dim, num_heads[si], window,
                    0 if bi % 2 == 0 else window // 2, dtype=dtype,
                    sd_prob=STOCHASTIC_DEPTH * block
                    / max(total - 1, 1)))
                block += 1
            layers.append(nn.Sequential(*blocks))
            if si < len(depths) - 1:
                layers.append(PatchMerging(dim, dtype))
                dim *= 2
        self.features = nn.Sequential(*layers)
        self.norm = LayerNorm(dim, dtype)
        self.feature_dim = dim

    def forward(self, x, seeds: Optional[DropoutSeeds] = None):
        """x: [B, C, H, W] (the pipeline's layout) or [B, H, W, C];
        ``seeds``: the step's dropout seeds, needed in training mode."""
        if not (x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3)):
            x = x.permute(0, 3, 1, 2)
        for layer in self.features:
            if isinstance(layer, nn.Sequential) and isinstance(layer[0],
                                                               SwinBlock):
                for blk in layer:
                    x = blk(x, seeds)
            else:
                x = layer(x)
        return self.norm(x)


class PatchStem(nn.Module):
    """The patch stem (JAX ``PatchEmbed``, swin.py:253-273; the MONAI
    PatchEmbeddingBlock of tri_mbt_v3.py:107-116): a ``patch`` x ``patch``
    stride-``patch`` convolution to ``hidden`` channels, run as its product
    over non-overlapping patches in ``dtype``, plus the learned positions
    ``pos_embed`` [1, N, hidden]. [B, C, H, W] -> tokens [B, N, hidden]."""

    def __init__(self, img_size: int = 224, patch: int = 16,
                 hidden: int = 256, in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(in_channels, hidden, patch, stride=patch)
        self.pos_embed = nn.Parameter(
            torch.zeros(1, (img_size // patch) ** 2, hidden))

    def forward(self, x):
        if not (x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3)):
            x = x.permute(0, 3, 1, 2)
        B, Cin, H, W = x.shape
        p, dt = self.patch, self.compute_dtype
        conv = self.proj
        x = x.reshape(B, Cin, H // p, p, W // p, p).permute(0, 2, 4, 1, 3, 5)
        x = x.reshape(B, (H // p) * (W // p), Cin * p * p)
        x = F.linear(x.to(dt), conv.weight.reshape(conv.out_channels, -1)
                     .to(dt), conv.bias.to(dt))
        return x + self.pos_embed.to(dt)
