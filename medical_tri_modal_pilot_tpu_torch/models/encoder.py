"""The transformer encoder with a cls token (counterpart of
medical_tri_modal_pilot_tpu/models/encoder.py:23-67, ``TransformerEncoder``
at ``classification=True``, ``d_input == d_model``; reference
encoder.py:36-118): the cls token, ``layer_norm_in``, an optional
sinusoidal positional encoding, input dropout and a stack of pre-norm
encoder layers. ``unimodal_transformer`` runs it masked; with
``mask=False`` (``feature_temporal_v1``'s instance transformer, JAX
extras.py:219-223) no key mask is built and no row is padded, so every
row is a live query and key. The reference's other forms (no cls token,
the ``linear_in`` projection) wait for their first callers (the legacy
families of ROADMAP Queue 1 item 7).

Parameters keep the reference's state_dict names (``cls_tokens``,
``layer_norm_in``, ``layer_stack.{i}``). A stream longer than 512 rows
(with the cls token) is padded to a multiple of 256 before its key mask is
built, as in the JAX package: TIE-1000 becomes 1024 rows, the flagship's
vslt shape, so the fused FFN skips dead row tiles; the padded rows are
masked keys and the caller reads row 0.

``MTFusion`` is the concat-fusion encoder of ``*_mt_v1`` (JAX
encoder.py:71-141, reference TrimodalTransformerEncoder_MT,
encoder.py:120-249). The reference's bridge does not reach it; its
parameters are named after the flax tree (``layer_norm_in_{m}``,
``cls_token_for_img``, ``final_cls_tokens``, ``specific_{m}_{layer}``,
``fusion_{layer}``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .modules import (DropoutSeeds, LayerNorm, StdLayerNorm,
                      TransformerEncoderLayer, length_key_mask,
                      positional_encoding)
from .modules import dropout as apply_dropout


class TransformerEncoder(nn.Module):

    def __init__(self, n_layers: int, n_head: int, d_model: int, d_ff: int,
                 dropout: float = 0.1, pe_maxlen: int = 5000,
                 use_pe: bool = True, dtype: torch.dtype = torch.float32,
                 remat: bool = False, mask: bool = True):
        super().__init__()
        self.mask = mask
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

    def forward(self, x, input_lengths: Optional[torch.Tensor],
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """x: [B, L, D]; input_lengths: [B] valid rows, the cls token
        included (None, or ignored, without a mask). Returns [B, L + 1
        (masked: padded past 512), D]."""
        dt = self.compute_dtype
        B = x.shape[0]
        x = torch.cat([self.cls_tokens.expand(B, 1, self.d_model).to(dt),
                       x.to(dt)], dim=1)
        key_mask = None
        if self.mask and input_lengths is not None:
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


class MTFusion(nn.Module):
    """Concat fusion: per stream StdLN (``layer_norm_in_{m}``), the
    positional encoding and the input dropout; the second stream (the
    image stream, or the notes of ``bitxt_mt_v1``) behind
    ``cls_token_for_img``; before ``fusion_startidx`` an encoder layer per
    stream (``specific_{m}_{layer}``) under its key mask; then one joint
    stream [``final_cls_tokens`` | stream 0 | stream 1 | ...] through
    ``fusion_{layer}`` under the concatenated key masks (the final cls and
    the unmasked streams never masked). The joint stream is not padded:
    its length stays the sum (1 + 1000 + 50 + 128 at config 4's shapes),
    so the FFN runs every row, as in the JAX package. A text stream whose
    valid length is 2 is masked whole (the ``vlen == 2 -> 0`` rule); in a
    specific layer its queries attend uniformly over every key."""

    def __init__(self, n_modality: int = 3, fusion_startidx: int = 0,
                 n_layers: int = 6, n_head: int = 4, d_model: int = 256,
                 d_ff: int = 1024, dropout: float = 0.1,
                 pe_maxlen: int = 5000, txt_idx: int = 2,
                 use_pe: bool = True,
                 mask: Tuple[bool, ...] = (True, False, True),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        M = n_modality
        self.n_modality = M
        self.fusion_startidx = fusion_startidx
        self.n_layers = n_layers
        self.d_model = d_model
        self.dropout = dropout
        self.txt_idx = txt_idx
        self.use_pe = use_pe
        self.mask = tuple(mask)
        self.compute_dtype = dtype
        self.cls_token_for_img = nn.Parameter(torch.zeros(1, 1, d_model))
        self.final_cls_tokens = nn.Parameter(torch.zeros(1, 1, d_model))
        for m in range(M):
            setattr(self, f"layer_norm_in_{m}",
                    StdLayerNorm(d_model, dtype=dtype))
        for layer in range(n_layers):
            names = ([f"specific_{m}_{layer}" for m in range(M)]
                     if layer < fusion_startidx else [f"fusion_{layer}"])
            for name in names:
                setattr(self, name, TransformerEncoderLayer(
                    d_model, n_head, d_ff, dropout, dtype, remat))
        if use_pe:
            self.register_buffer("pe", positional_encoding(pe_maxlen,
                                                           d_model),
                                 persistent=False)

    def forward(self, enc_inputs: Sequence[torch.Tensor],
                varying_lengths: Sequence[torch.Tensor],
                seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """enc_inputs[m]: [B, L_m, D]; varying_lengths[m]: [B] valid rows
        of stream m. Returns the joint stream [B, 1 + sum L_m (+1), D],
        the final cls token first (or the streams concatenated when no
        layer fuses)."""
        M, D = self.n_modality, self.d_model
        dt = self.compute_dtype
        B = enc_inputs[0].shape[0]
        xs: List[torch.Tensor] = []
        masks: List[Optional[torch.Tensor]] = []
        for m in range(M):
            x = enc_inputs[m].to(dt)
            vlen = varying_lengths[m].long()
            if m == 1:
                x = torch.cat([self.cls_token_for_img.expand(B, 1, D).to(dt),
                               x], dim=1)
                vlen = vlen + 1
            h = getattr(self, f"layer_norm_in_{m}")(x)
            if self.use_pe:
                h = h + self.pe[:, :h.shape[1]].to(dt)
            xs.append(apply_dropout(h, self.dropout, self.training, seeds))
            if m == self.txt_idx:
                vlen = torch.where(vlen == 2, 0, vlen)
            masks.append(length_key_mask(vlen, h.shape[1]) if self.mask[m]
                         else None)
        joint = None
        for layer in range(self.n_layers):
            if layer < self.fusion_startidx:
                xs = [getattr(self, f"specific_{m}_{layer}")(
                    xs[m], masks[m], seeds) for m in range(M)]
                continue
            if joint is None:
                joint = torch.cat(
                    [self.final_cls_tokens.expand(B, 1, D).to(dt)] + xs,
                    dim=1)
                joint_mask = torch.cat(
                    [torch.zeros(B, 1, dtype=torch.bool, device=joint.device)]
                    + [mk if mk is not None else
                       torch.zeros(B, x.shape[1], dtype=torch.bool,
                                   device=joint.device)
                       for x, mk in zip(xs, masks)], dim=1)
            joint = getattr(self, f"fusion_{layer}")(joint, joint_mask,
                                                     seeds)
        return joint if joint is not None else torch.cat(xs, dim=1)
