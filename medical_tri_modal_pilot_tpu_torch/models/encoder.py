"""The transformer encoder with a cls token (counterpart of
medical_tri_modal_pilot_tpu/models/encoder.py:23-67, ``TransformerEncoder``
at ``classification=True``, ``mask=True``, ``d_input == d_model``;
reference encoder.py:36-118): the cls token, ``layer_norm_in``, an optional
sinusoidal positional encoding, input dropout and a stack of pre-norm
encoder layers. ``unimodal_transformer`` runs it. The reference's other
forms (no cls token, an unmasked stream, the ``linear_in`` projection) wait
for the text baselines of ROADMAP Queue 1 item 6, their first callers.

Parameters keep the reference's state_dict names (``cls_tokens``,
``layer_norm_in``, ``layer_stack.{i}``). A stream longer than 512 rows
(with the cls token) is padded to a multiple of 256 before its key mask is
built, as in the JAX package: TIE-1000 becomes 1024 rows, the flagship's
vslt shape, so the fused FFN skips dead row tiles; the padded rows are
masked keys and the caller reads row 0.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .modules import (DropoutSeeds, LayerNorm, TransformerEncoderLayer,
                      length_key_mask, positional_encoding)
from .modules import dropout as apply_dropout


class TransformerEncoder(nn.Module):

    def __init__(self, n_layers: int, n_head: int, d_model: int, d_ff: int,
                 dropout: float = 0.1, pe_maxlen: int = 5000,
                 use_pe: bool = True, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.d_model = d_model
        self.dropout = dropout
        self.use_pe = use_pe
        self.compute_dtype = dtype
        self.cls_tokens = nn.Parameter(torch.zeros(1, 1, d_model))
        self.layer_norm_in = LayerNorm(d_model, dtype)
        self.layer_stack = nn.ModuleList(
            [TransformerEncoderLayer(d_model, n_head, d_ff, dropout, dtype,
                                     remat)
             for _ in range(n_layers)])
        if use_pe:
            self.register_buffer("pe", positional_encoding(pe_maxlen,
                                                           d_model),
                                 persistent=False)

    def forward(self, x, input_lengths: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """x: [B, L, D]; input_lengths: [B] valid rows, the cls token
        included. Returns [B, L + 1 (padded past 512), D]."""
        dt = self.compute_dtype
        B = x.shape[0]
        x = torch.cat([self.cls_tokens.expand(B, 1, self.d_model).to(dt),
                       x.to(dt)], dim=1)
        if x.shape[1] > 512:
            tgt = -(-x.shape[1] // 256) * 256
            x = F.pad(x, (0, 0, 0, tgt - x.shape[1]))
        key_mask = length_key_mask(input_lengths.long(), x.shape[1])
        h = self.layer_norm_in(x)
        if self.use_pe:
            h = h + self.pe[:, :h.shape[1]].to(dt)
        h = apply_dropout(h, self.dropout, self.training, seeds)
        for layer in self.layer_stack:
            h = layer(h, key_mask, seeds)
        return h
