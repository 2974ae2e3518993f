"""UMSE — Unified Multi-modal Set Embedding stems (counterpart of
medical_tri_modal_pilot_tpu/models/umse.py:70-144).

Per TIE token the value and time stems and the feature-id embedding are
summed through ``ops.umse`` (the CUDA kernels of ``csrc/umse.cu``, forward
and backward, on the card); the demographics stem, the BioBERT projection
(768 -> d) and the img/txt timestamp enrichment (feature ids 18/19,
``--imgtxt-time 1``) are plain PyTorch.

The stems are attributes of the model itself (``ie_vslt``, ``ie_time``,
``ie_feat``, ``ie_demo``, ``txt_embedding``), as in the reference, so the
backbone and model classes extend this one and the state_dict keys match
the reference's.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import N_FEATURE_IDS

from .. import ops
from ..kernels.umse import stem as stem_formula
from .modules import MLPStem


class UMSE(nn.Module):
    """The shared input stems (tri_mbt_vsltcls.py:59-76, :183-224)."""

    def __init__(self, d_model: int = 256, vslt_type: str = "TIE",
                 berttype: str = "biobert",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if vslt_type != "TIE":
            raise NotImplementedError(
                f"--vslt-type {vslt_type}: carryforward and QIE stems are "
                "ROADMAP Queue 1 item 3")
        if berttype != "biobert":
            raise NotImplementedError(
                f"--berttype {berttype}: only the BioBERT projection is "
                "ported (ROADMAP Queue 1 item 3)")
        self.compute_dtype = dtype
        self.ie_vslt = MLPStem(1, d_model, dtype)
        self.ie_time = MLPStem(1, d_model, dtype)
        self.ie_feat = nn.Embedding(N_FEATURE_IDS, d_model)
        self.ie_demo = MLPStem(2, d_model, dtype)
        self.txt_embedding = nn.Linear(768, d_model)

    @staticmethod
    def _stem_params(stem: MLPStem):
        """(w [1, D], b, ln scale, ln bias) in the JAX layout."""
        return (stem[0].weight.t(), stem[0].bias, stem[1].weight,
                stem[1].bias)

    def embed_vslt(self, x, age, gen) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: TIE [B, L, 3] (time, value, feature id). Returns (tokens
        [B, L, D], demographics embedding [B, D]) in the compute dtype."""
        dt = self.compute_dtype
        demo = self.ie_demo(torch.stack([age, gen], dim=1).to(dt))
        tokens = ops.umse(x.float(), *self._stem_params(self.ie_vslt),
                          *self._stem_params(self.ie_time),
                          self.ie_feat.weight, dt)
        return tokens, demo

    def embed_txt(self, txt) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(txt.to(dt), self.txt_embedding.weight.to(dt),
                        self.txt_embedding.bias.to(dt))

    def add_time_feature(self, tokens, t, feature_id: int):
        """Add the modality timestamp embedding and the constant feature-id
        embedding (18 img / 19 txt) to every token
        (tri_mbt_vsltcls.py:216-224)."""
        dt = self.compute_dtype
        B = tokens.shape[0]
        te = stem_formula(t.reshape(B, 1).float(),
                          *self._stem_params(self.ie_time), dt).to(dt)
        fe = self.ie_feat.weight[feature_id].to(dt)
        return tokens + te[:, None, :] + fe[None, None, :]
