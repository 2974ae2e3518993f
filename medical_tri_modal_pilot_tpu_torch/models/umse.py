"""UMSE — Unified Multi-modal Set Embedding stems (counterpart of
medical_tri_modal_pilot_tpu/models/umse.py:70-144).

Per TIE or QIE token the value and time stems and the feature-id
embedding are summed through ``ops.umse`` (the CUDA kernels of
``csrc/umse.cu``, forward and backward, on the card); QIE then adds the
demographics embedding to every token. A carryforward grid goes through
the ``vslt_enc`` stem instead. The demographics stem, the note embedding
(BioBERT 768 -> d, or with ``--berttype bert`` a 30000 x d token table)
and the img/txt timestamp enrichment (feature ids 18/19, ``--imgtxt-time
1``) are plain PyTorch.

The stems are attributes of the model itself (``vslt_enc`` or
``ie_vslt``, ``ie_time``, ``ie_feat``, ``ie_demo``, ``txt_embedding``),
as in the reference, so the backbone and model classes extend this one
and the state_dict keys match the reference's. A model holds the stems
its inputs use, as the JAX model's parameter tree does: ``ie_time`` and
``ie_feat`` with TIE/QIE tokens or timestamp enrichment,
``txt_embedding`` with notes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import N_FEATURE_IDS

from .. import ops
from ..kernels.umse import stem as stem_formula
from .modules import MLPStem

# the token table of --berttype bert (umse.py:93)
BERT_VOCAB = 30000


class UMSE(nn.Module):
    """The shared input stems (tri_mbt_vsltcls.py:59-76, :183-224).
    ``vslt_len``: the carryforward grid's channels; ``txt``: whether the
    model embeds notes; ``timestamps``: whether img/txt tokens get the
    timestamp enrichment."""

    def __init__(self, d_model: int = 256, vslt_type: str = "TIE",
                 berttype: str = "biobert",
                 dtype: torch.dtype = torch.float32, vslt_len: int = 16,
                 txt: bool = True, timestamps: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.vslt_type = vslt_type
        self.berttype = berttype
        if vslt_type == "carryforward":
            self.vslt_enc = MLPStem(vslt_len, d_model, dtype)
        else:
            self.ie_vslt = MLPStem(1, d_model, dtype)
        if vslt_type != "carryforward" or timestamps:
            self.ie_time = MLPStem(1, d_model, dtype)
            self.ie_feat = nn.Embedding(N_FEATURE_IDS, d_model)
        self.ie_demo = MLPStem(2, d_model, dtype)
        if txt:
            self.txt_embedding = (nn.Embedding(BERT_VOCAB, d_model)
                                  if berttype == "bert"
                                  else nn.Linear(768, d_model))

    @staticmethod
    def _stem_params(stem: MLPStem):
        """(w [1, D], b, ln scale, ln bias) in the JAX layout."""
        return (stem[0].weight.t(), stem[0].bias, stem[1].weight,
                stem[1].bias)

    def embed_vslt(self, x, age, gen) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: TIE/QIE [B, L, 3] (time, value, feature id), or the
        carryforward stack [B, 3 (data, mask, delta), T, F], whose data
        channel the stem reads (trainer.py:40-44). Returns (tokens
        [B, L, D], demographics embedding [B, D]) in the compute dtype."""
        dt = self.compute_dtype
        demo = self.ie_demo(torch.stack([age, gen], dim=1).to(dt))
        if self.vslt_type == "carryforward":
            if x.dim() == 4:
                x = x[:, 0]
            return self.vslt_enc(x), demo
        tokens = ops.umse(x.float(), *self._stem_params(self.ie_vslt),
                          *self._stem_params(self.ie_time),
                          self.ie_feat.weight, dt)
        if self.vslt_type == "QIE":
            tokens = tokens + demo[:, None, :]
        return tokens, demo

    def embed_txt(self, txt) -> torch.Tensor:
        dt = self.compute_dtype
        if self.berttype == "bert":
            return F.embedding(txt.long(), self.txt_embedding.weight).to(dt)
        return F.linear(txt.to(dt), self.txt_embedding.weight.to(dt),
                        self.txt_embedding.bias.to(dt))

    def add_time_feature(self, tokens, t, feature_id: int,
                         demo: Optional[torch.Tensor] = None):
        """Add the modality timestamp embedding and the constant feature-id
        embedding (18 img / 19 txt) to every token, and under QIE the
        demographics embedding (tri_mbt_vsltcls.py:216-224)."""
        dt = self.compute_dtype
        B = tokens.shape[0]
        te = stem_formula(t.reshape(B, 1).float(),
                          *self._stem_params(self.ie_time), dt).to(dt)
        fe = self.ie_feat.weight[feature_id].to(dt)
        out = tokens + te[:, None, :] + fe[None, None, :]
        if self.vslt_type == "QIE" and demo is not None:
            out = out + demo[:, None, :]
        return out
