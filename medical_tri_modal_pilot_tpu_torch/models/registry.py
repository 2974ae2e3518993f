"""Model registry: ``--model`` name -> constructor (counterpart of
medical_tri_modal_pilot_tpu/models/registry.py), with seeded weights."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..config import Config

from . import baselines as BL
from . import extras as X
from . import legacy as LG
from . import models as M
from .modules import ProjLinear, StdLayerNorm
from .swin import PatchEmbed, PatchStem, WindowAttention

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
    "tri_mbt_vsltcls_noshareumse":
        lambda cfg: M.TRI_MBT_VSLTCLS(cfg, share_umse=False),
    # the softmax temperature of the masked weights (JAX registry.py:30-31)
    "tri_mbt_vflexible": M.TRI_MBT_VFLEXIBLE,
    "tri_mbt_vflexible2": lambda cfg: M.TRI_MBT_VFLEXIBLE(cfg, flex_temp=10.0),
    "tri_mbt_vflexible3":
        lambda cfg: M.TRI_MBT_VFLEXIBLE(cfg, flex_temp=3.334),
    # raise on their bimodal --input-types, as the JAX model does
    "biimg_mbt_vflexible1": M.TRI_MBT_VFLEXIBLE,
    "bitxt_mbt_vflexible1": M.TRI_MBT_VFLEXIBLE,
    "tri_mbt_vnoshavgtr": lambda cfg: M.TRI_MBT_VNOSH(cfg, avg_in_model=True),
    "tri_mbt_vnoshnoavgtr": M.TRI_MBT_VNOSH,
    "tri_mt_v1": M.MT_FUSION_MODEL,
    "biimg_mt_v1": M.MT_FUSION_MODEL,
    "bitxt_mt_v1": M.MT_FUSION_MODEL,
    "mt_v1": M.MT_FUSION_MODEL,
    "tri_mbt_vmulti": M.TRI_MBT_VMULTI,
    "tri_mbt_vmulti2": lambda cfg: M.TRI_MBT_VMULTI(cfg, vslt_main=True),
    "tri_mbt_vmultivslt": M.TRI_MBT_VMULTIVSLT,
    "unimodal_transformer": M.UNIMODAL_TRANSFORMER,
    # the paper's baselines (JAX registry.py:61-64)
    "gru_d": BL.GRU_D,
    "lstm": BL.LSTM_MODEL,
    "fusiontrainer": BL.FUSIONTRAINER,
    "feature_temporal_v1": X.FEATURE_TEMPORAL_V1,
    # the legacy families (JAX registry.py:67, legacy.py:685-759)
    **LG.LEGACY,
}

# parameters the JAX package initialises to zeros (its nn.initializers.
# zeros): the learned head weights, the joint stream's cls token, GRU-D's
# input-decay bias, feature_temporal_v1's stem biases and the ViT's class
# token
ZERO_INIT = ("flexibleavg", "final_cls_tokens", "input_decay_b",
             "feat_bias", "class_token")


def _trunc_normal(shape, generator, std: float) -> torch.Tensor:
    """flax ``truncated_normal(std)``: a [-2, 2]-truncated unit normal
    scaled by ``std`` over that truncation's own std (0.8796)."""
    return nn.init.trunc_normal_(torch.empty(shape), generator=generator) \
        * (std / 0.87962566103423978)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter from ``generator`` with the JAX package's
    initialisers: xavier-uniform q/k/v projections, fan-in normal for the
    other dense and convolution weights (the Swin trunk's included), zero
    biases, truncated normals of std 0.02 for the Swin relative-position
    bias tables (flax's ``truncated_normal(0.02)``), unit normals for the
    embedding tables, cls tokens and bottlenecks but ``ZERO_INIT``'s,
    identity norms (the LayerNorm of ``ClsHeadLN`` included); for the
    baselines, orthogonal hidden kernels in the recurrent cells (flax's
    ``recurrent_kernel_init``), a normal of std 0.02 for GRU-D's
    ``input_decay_w``, fan-in normals for ``feat_stems`` (flax's
    lecun-normal over [F, 1, D]: fan-in F) and a truncated normal of std
    0.02 for the patch stem's ``pos_embed``; for the legacy families, a
    normal of std 0.02 for the ViT's ``pos_embedding``, AUXCPC's
    ``ct_weight`` [T, ct_dim, F] uniform within +-sqrt(ct_dim) and identity
    BatchNorms in the ResNet and MaxViT backbones. One deviation, on trunks
    that train only: their Swin stem's convolution bias (``features.0.0``)
    is drawn as torch's Conv2d draws it (uniform within 1/sqrt(fan-in)),
    as the reference's torchvision trunk has it, not zero: at zero a
    missing CXR (a zero image) stays exactly zero through every block,
    each LayerNorm at variance 0 multiplies its cotangent by
    1/sqrt(eps), and the trunk's gradient overflows fp32 (the JAX
    package's own init does; ROADMAP Queue 3). A frozen trunk's stays
    zero, as in JAX."""
    def fill(p, values):
        p.copy_(values.to(p.dtype))

    def randn(p):
        return torch.randn(p.shape, generator=generator)

    claimed = set()
    for mod in model.modules():
        if isinstance(mod, (BL.GRUCell, BL.LSTMCell)):
            for name, lin in mod.named_children():
                w = lin.weight
                if name.startswith("h"):
                    fill(w, nn.init.orthogonal_(torch.empty(w.shape),
                                                generator=generator))
                else:
                    fill(w, randn(w) / math.sqrt(w.shape[1]))
                if lin.bias is not None:
                    lin.bias.zero_()
                claimed.add(lin)
        elif isinstance(mod, ProjLinear):
            lin = mod.linear
            fan_out, fan_in = lin.weight.shape
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            fill(lin.weight, (2 * torch.rand(lin.weight.shape,
                                             generator=generator) - 1)
                 * bound)
            lin.bias.zero_()
            claimed.add(lin)
        elif isinstance(mod, PatchEmbed):
            conv = mod[0]
            fan_in = conv.weight[0].numel()
            fill(conv.weight, randn(conv.weight) / math.sqrt(fan_in))
            if conv.bias.requires_grad:
                fill(conv.bias, (2 * torch.rand(conv.bias.shape,
                                                generator=generator) - 1)
                     / math.sqrt(fan_in))
            else:
                conv.bias.zero_()
            claimed.add(conv)
        elif isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            if mod in claimed:
                continue
            fan_in = mod.weight[0].numel()
            fill(mod.weight, randn(mod.weight) / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, WindowAttention):
            # flax scales its [-2, 2]-truncated unit normal by the std of
            # that truncation (0.8796), so the draws have std 0.02
            table = mod.relative_position_bias_table
            fill(table, _trunc_normal(table.shape, generator, 0.02))
        elif isinstance(mod, PatchStem):
            fill(mod.pos_embed, _trunc_normal(mod.pos_embed.shape,
                                              generator, 0.02))
        elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm1d,
                              nn.BatchNorm2d)):
            mod.reset_parameters()
        elif isinstance(mod, StdLayerNorm):
            mod.gamma.fill_(1.0)
            mod.beta.zero_()
        else:
            for name, p in mod.named_parameters(recurse=False):
                if name in ZERO_INIT:
                    p.zero_()
                elif name in ("input_decay_w", "pos_embedding"):
                    fill(p, 0.02 * randn(p))
                elif name == "ct_weight":
                    lim = math.sqrt(p.shape[1])
                    fill(p, (2 * torch.rand(p.shape, generator=generator)
                             - 1) * lim)
                elif name == "feat_stems":
                    fill(p, randn(p) / math.sqrt(p.shape[0]))
                else:
                    fill(p, randn(p))


def get_model(cfg: Config, generator: Optional[torch.Generator] = None,
              state: Optional[Dict[str, torch.Tensor]] = None):
    """Build the model for ``cfg.model`` on the CPU in eval mode, weights
    drawn from ``generator`` (default: seeded with ``cfg.seed``), or, given
    ``state``, loaded from it (strictly) without drawing any."""
    name = cfg.model
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model '{name}'; available: {sorted(_REGISTRY)}")
    model = _REGISTRY[name](cfg)
    if state is not None:
        model.load_state_dict(state)
        return model.eval()
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    init_parameters(model, generator)
    return model.eval()
