"""Modality-aware bottleneck fusion (counterpart of
medical_tri_modal_pilot_tpu/models/mbt.py:42-187, ``MBTFusion``).

Missing-modality handling is the JAX package's formulation: per-sample
mixing weights over modalities come from a one-hot of ``missing_num``
times a constant candidate matrix, and the new bottlenecks are that mix of
each stream's bottleneck outputs. Quirks kept: a text length of 3
(BOS/EOS-only note) becomes 0, so the whole text stream is masked;
bottleneck key masks run over ``vlen + n`` of the concatenated sequence;
``vsltonly`` skips the other streams and the mix in the last layer;
``resbottle`` averages the new bottlenecks with the previous ones.
``remat`` checkpoints every encoder layer (``--remat 1``).

Long masked streams are padded so [bottlenecks | cls | tokens] is a
multiple of 256 rows, as in the JAX package; the padded rows are masked
keys, so the logits do not depend on it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .modules import (DropoutSeeds, LayerNorm, TransformerEncoderLayer,
                      length_key_mask, positional_encoding)
from .modules import dropout as apply_dropout


def missing_candidate_weights(n_modality: int) -> np.ndarray:
    if n_modality == 3:
        return np.array([
            [1 / 3, 1 / 3, 1 / 3],   # 0: tri mean
            [1 / 2, 1 / 2, 0.0],     # 1: vslt + img
            [1 / 2, 0.0, 1 / 2],     # 2: vslt + txt
            [1.0, 0.0, 0.0],         # 3: vslt only
        ], dtype=np.float32)
    if n_modality == 2:
        return np.array([
            [1 / 2, 1 / 2],          # 0: both
            [1.0, 0.0],              # 1: vslt only
        ], dtype=np.float32)
    raise ValueError(f"n_modality must be 2 or 3, got {n_modality}")


class MBTFusion(nn.Module):
    """Bi/tri-modal bottleneck fusion (TrimodalTransformerEncoder_MBT /
    BimodalTransformerEncoder_MBT, mbt_encoder.py:519-784)."""

    def __init__(self, n_modality: int, bottlenecks_n: int = 4,
                 fusion_startidx: int = 0, n_layers: int = 6,
                 n_head: int = 4, d_model: int = 256, d_ff: int = 1024,
                 dropout: float = 0.1, pe_maxlen: int = 2500,
                 txt_idx: int = 2, vsltonly: int = 0,
                 resbottle: bool = False,
                 use_pe: Tuple[bool, ...] = (False, False, True),
                 mask: Tuple[bool, ...] = (True, False, True),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        M = n_modality
        self.n_modality = M
        self.bottlenecks_n = bottlenecks_n
        self.fusion_startidx = fusion_startidx
        self.n_layers = n_layers
        self.d_model = d_model
        self.dropout = dropout
        self.txt_idx = txt_idx
        self.vsltonly = vsltonly
        self.resbottle = resbottle
        self.use_pe = tuple(use_pe)
        self.mask = tuple(mask)
        self.compute_dtype = dtype
        self.bottlenecks = nn.Parameter(torch.zeros(1, bottlenecks_n,
                                                    d_model))
        self.cls_token_per_modality = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, 1, d_model)) for _ in range(M)])
        self.layer_norms_in = nn.ModuleList(
            [LayerNorm(d_model, dtype) for _ in range(M)])
        self.layer_stacks = nn.ModuleList()
        for layer in range(n_layers):
            mods = 1 if (vsltonly == 1 and layer == n_layers - 1) else M
            self.layer_stacks.append(nn.ModuleList(
                [TransformerEncoderLayer(d_model, n_head, d_ff, dropout,
                                         dtype, remat)
                 for _ in range(mods)]))
        self.register_buffer("pe", positional_encoding(pe_maxlen, d_model),
                             persistent=False)
        self.register_buffer(
            "candidates", torch.from_numpy(missing_candidate_weights(M)),
            persistent=False)

    def forward(self, enc_inputs: Sequence[torch.Tensor],
                varying_lengths: Sequence[torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> List[torch.Tensor]:
        """enc_inputs[m]: [B, L_m, D] (no cls yet); varying_lengths[m]: [B]
        int; missing_num: [B] int in [0, n_candidates); seeds: the step's
        dropout seeds (training mode). Returns per-modality
        [B, 1+L_m(+pad), D] with cls at position 0."""
        M = self.n_modality
        n = self.bottlenecks_n
        D = self.d_model
        dt = self.compute_dtype
        B = enc_inputs[0].shape[0]

        xs, key_masks, b_key_masks = [], [], []
        for m in range(M):
            cls = self.cls_token_per_modality[m].expand(B, 1, D).to(dt)
            x = torch.cat([cls, enc_inputs[m].to(dt)], dim=1)
            if self.mask[m] and x.shape[1] + n > 512:
                tgt = -(-(x.shape[1] + n) // 256) * 256
                x = F.pad(x, (0, 0, 0, tgt - n - x.shape[1]))
            L = x.shape[1]
            vlen = varying_lengths[m].long() + 1
            if m == self.txt_idx:
                vlen = torch.where(vlen == 3, 0, vlen)
            if self.mask[m]:
                key_masks.append(length_key_mask(vlen, L))
                b_key_masks.append(length_key_mask(vlen + n, L + n))
            else:
                key_masks.append(None)
                b_key_masks.append(None)
            h = self.layer_norms_in[m](x)
            if self.use_pe[m]:
                h = h + self.pe[:, :L].to(dt)
            xs.append(apply_dropout(h, self.dropout, self.training, seeds))

        onehot = F.one_hot(missing_num.long(), self.candidates.shape[0])
        mix = onehot.float() @ self.candidates                   # [B, M]
        bottlenecks = self.bottlenecks.expand(B, n, D).to(dt)

        # from the first fusion layer on, each stream carries the
        # bottleneck rows in front; later layers replace them out of place
        # (the stream is a saved input of the previous layer's backward)
        in_fusion = False
        for layer in range(self.n_layers):
            stack = self.layer_stacks[layer]
            if layer < self.fusion_startidx:
                xs = [stack[m](xs[m], key_masks[m], seeds) for m in range(M)]
                continue
            if not in_fusion:
                xs = [torch.cat([bottlenecks, x], dim=1) for x in xs]
                in_fusion = True
            else:
                xs = [torch.cat([bottlenecks.to(x.dtype), x[:, n:]], dim=1)
                      for x in xs]
            last_layer = layer == self.n_layers - 1
            new_xs, bn_outs = [], []
            for m in range(M):
                if self.vsltonly == 1 and last_layer and m > 0:
                    new_xs.append(xs[m])
                    continue
                out = stack[m](xs[m], b_key_masks[m], seeds)
                bn_outs.append(out[:, :n])
                new_xs.append(out)
            xs = new_xs
            if self.vsltonly == 1 and last_layer:
                break
            outs = torch.stack(bn_outs)                          # [M, B, n, D]
            mixed = torch.einsum("bm,mbnd->bnd", mix.to(outs.dtype), outs)
            if self.resbottle:
                mixed = (mixed + bottlenecks) / 2.0
            bottlenecks = mixed
        return [x[:, n:] for x in xs] if in_fusion else xs
