"""Model registry: ``--model`` name -> constructor (counterpart of
medical_tri_modal_pilot_tpu/models/registry.py), with seeded weights."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..config import Config

from . import legacy as LG
from . import models as M
from .modules import ProjLinear, StdLayerNorm
from .swin import WindowAttention

_REGISTRY: Dict[str, Callable] = {
    "tri_mbt_vsltcls": M.TRI_MBT_VSLTCLS,
    # the bimodal counterparts of the flagship, as the JAX registry maps
    # them (its registry.py:40-41)
    "biimg_mbt_vsltcls": M.TRI_MBT_VSLTCLS,
    "bitxt_mbt_vsltcls": M.TRI_MBT_VSLTCLS,
    "tri_mbt_v1": M.TRI_MBT_V1,
    "tri_mbt_v2": lambda cfg: M.TRI_MBT_V1(cfg, variant=2),
    "tri_mbt_v3": lambda cfg: M.TRI_MBT_V1(cfg, variant=3),
    "bi_vslttxt_mbt_v1": M.BI_MBT_V1,
    "bi_vsltimg_mbt_v1": M.BI_MBT_V1,
    "tri_mbt_vmulti": M.TRI_MBT_VMULTI,
    "tri_mbt_vmulti2": lambda cfg: M.TRI_MBT_VMULTI(cfg, vslt_main=True),
    "tri_mbt_vmultivslt": M.TRI_MBT_VMULTIVSLT,
    "unimodal_transformer": M.UNIMODAL_TRANSFORMER,
    "cross_transformer_txt_vslt": LG.CROSS_TRANSFORMER,
    "bi_cross_transformer_txt_vslt": LG.CROSS_TRANSFORMER,
}

@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter from ``generator`` with the JAX package's
    initialisers: xavier-uniform q/k/v projections, fan-in normal for the
    other dense and convolution weights (the Swin trunk's included), zero
    biases, truncated normals of std 0.02 for the Swin relative-position
    bias tables (flax's ``truncated_normal(0.02)``), unit normals for the
    embedding tables, cls tokens and bottlenecks, identity norms (the
    LayerNorm of ``ClsHeadLN`` included)."""
    def fill(p, values):
        p.copy_(values.to(p.dtype))

    def randn(p):
        return torch.randn(p.shape, generator=generator)

    projections = set()
    for mod in model.modules():
        if isinstance(mod, ProjLinear):
            lin = mod.linear
            fan_out, fan_in = lin.weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            fill(lin.weight, (2 * torch.rand(lin.weight.shape,
                                             generator=generator) - 1)
                 * bound)
            lin.bias.zero_()
            projections.add(lin)
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            if mod in projections:
                continue
            fan_in = mod.weight[0].numel()
            fill(mod.weight, randn(mod.weight) / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, WindowAttention):
            # flax scales its [-2, 2]-truncated unit normal by the std of
            # that truncation (0.8796), so the draws have std 0.02
            table = mod.relative_position_bias_table
            fill(table, nn.init.trunc_normal_(
                torch.empty(table.shape), generator=generator)
                * (0.02 / 0.87962566103423978))
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d)):
            mod.reset_parameters()
        elif isinstance(mod, StdLayerNorm):
            mod.gamma.fill_(1.0)
            mod.beta.zero_()
        else:
            for p in mod.parameters(recurse=False):
                fill(p, randn(p))


def get_model(cfg: Config, generator: Optional[torch.Generator] = None):
    """Build the model for ``cfg.model`` on the CPU in eval mode, weights
    drawn from ``generator`` (default: seeded with ``cfg.seed``)."""
    name = cfg.model
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    model = _REGISTRY[name](cfg)
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_parameters(model, generator)
    return model.eval()
