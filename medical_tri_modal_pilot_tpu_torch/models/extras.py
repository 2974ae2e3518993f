"""``feature_temporal_v1`` (counterpart of medical_tri_modal_pilot_tpu/
models/extras.py:186-236, ``FEATURE_TEMPORAL_V1``; reference
8_missing_models/feature_temporal_v1.py:177-238 in its 'gtransformer'
form): a per-timestep feature-graph transformer, then a temporal
transformer over the steps' cls vectors, then the BatchNorm head.
Carryforward only.

Per step t of the grid [B, T, F]: each feature value through its own
1 -> D stem (``feat_stems`` [F, 1, D], ``feat_bias`` [F, D], in fp32 as
the JAX model promotes there), ``stem_ln`` and relu; the age and gender
encoders' tokens beside them; the 2-layer instance transformer
(``instance_graph_transformer``) over [B T, cls + F + 2, D] with no key
mask and no positional encoding: every one of its attention and FFN halves
goes through ``ops.attn_block`` and ``ops.ffn`` unmasked (on the card at
B T rows of F + 3 = 19, no row tile skipped). Its cls rows [B, T, D] then
run through ``temporal_transformer`` (the positional encoding, the key
mask of ``input_length + 1``), ``final_ln`` on its cls row and
``fc_list``. The names are the flax tree's, the encoders' inside as
``models/encoder.py::TransformerEncoder`` names them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from .encoder import TransformerEncoder
from .heads import ClsHead
from .models import ModelOutput, model_dtype
from .modules import DropoutSeeds, LayerNorm


class FEATURE_TEMPORAL_V1(nn.Module):

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dt = self.compute_dtype = model_dtype(cfg)
        D, Fn = cfg.transformer_dim, cfg.vslt_len
        self.feat_stems = nn.Parameter(torch.zeros(Fn, 1, D))
        self.feat_bias = nn.Parameter(torch.zeros(Fn, D))
        self.stem_ln = LayerNorm(D, dt)
        self.age_encoder = nn.Linear(1, D)
        self.gender_encoder = nn.Linear(1, D)
        self.instance_graph_transformer = TransformerEncoder(
            n_layers=2, n_head=cfg.transformer_num_head, d_model=D,
            d_ff=4 * D, dropout=cfg.dropout, use_pe=False, dtype=dt,
            remat=cfg.remat == 1, mask=False)
        self.temporal_transformer = TransformerEncoder(
            n_layers=cfg.transformer_num_layers,
            n_head=cfg.transformer_num_head, d_model=D, d_ff=4 * D,
            dropout=cfg.dropout, use_pe=True, dtype=dt,
            remat=cfg.remat == 1)
        self.final_ln = LayerNorm(D, dt)
        self.fc_list = ClsHead(D, D, cfg.output_dim, cfg.activation, dt)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``missing_num`` is unused (one modality); ``seeds``: the step's
        dropout seeds, needed in training mode."""
        dt = self.compute_dtype
        x = batch["vslt"][:, 0].to(dt)                       # [B, T, F]
        B, T, Fn = x.shape
        D = self.cfg.transformer_dim
        tokens = (x.float()[..., None] * self.feat_stems[:, 0, :]
                  + self.feat_bias)                          # [B, T, F, D]
        tokens = torch.relu(self.stem_ln(tokens))
        static = batch["static"].to(dt)
        age, gen = (F.linear(static[:, i:i + 1], lin.weight.to(dt),
                             lin.bias.to(dt))
                    for i, lin in ((1, self.age_encoder),
                                   (0, self.gender_encoder)))
        inst = torch.cat([tokens, age[:, None, None].expand(B, T, 1, D),
                          gen[:, None, None].expand(B, T, 1, D)], dim=2)
        inst = self.instance_graph_transformer(
            inst.reshape(B * T, Fn + 2, D), None, seeds)
        steps = inst[:, 0].reshape(B, T, D)
        h = self.temporal_transformer(
            steps, batch["input_length"].long() + 1, seeds)
        logits = self.fc_list(self.final_ln(h[:, 0]))
        return logits[..., 0], None, None
