"""Legacy model families (counterpart of medical_tri_modal_pilot_tpu/models/
legacy.py): the cross-modal transformer over carryforward vital signs and
clinical notes, ``cross_transformer_txt_vslt`` and
``bi_cross_transformer_txt_vslt`` (reference builder/models/5_bi_vslt_txt/
{bi_,}cross_transformer_txt_vslt.py).

The modules are named after the JAX parameter tree (``vslt_tokens``,
``txt_tokens``, ``self_{v,o}_i``, ``cross_{v,o}_i``, ``merge``,
``final_ln``, ``fc_list``), so ``models/convert.py::from_jax_variables``
carries JAX weights across with a strict load. The other legacy families
(early, mid and late fusion, the ``auxcpc_*`` family, the image cross
transformer) are ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from .baselines import _unpack_carryforward, _with_demo
from .heads import ClsHead
from .models import ModelOutput, model_dtype
from .modules import (CrossmodalTransformerEncoderLayer, DropoutSeeds,
                      LayerNorm, TransformerEncoderLayer, length_key_mask)
from .umse import BERT_VOCAB


def _dense(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dt)``: input and weights cast to ``dt``."""
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))


class _VsltTokens(nn.Module):
    """Carryforward grid + demographics channels -> d_model tokens (the
    init_fc pattern, cross_transformer_img_vslt_sssccc.py:57)."""

    def __init__(self, cfg: Config, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.init_fc = nn.Linear(cfg.vslt_len + 2, cfg.transformer_dim)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        x, _, _ = _unpack_carryforward(batch)
        x = _with_demo(x.to(self.compute_dtype), batch)
        return _dense(x, self.init_fc, self.compute_dtype)


class _TxtTokens(nn.Module):
    """Notes -> d_model tokens: dense BioBERT embeddings [B, T, 768] (or
    [B, 768]) through a Linear, or under ``--berttype bert`` token ids
    [B, T] through a 30000 x d table (JAX legacy.py:131-147)."""

    def __init__(self, cfg: Config, dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = dtype
        self.bert = cfg.berttype == "bert"
        self.txt_embedding = (nn.Embedding(BERT_VOCAB, cfg.transformer_dim)
                              if self.bert
                              else nn.Linear(768, cfg.transformer_dim))

    def forward(self, txt: torch.Tensor) -> torch.Tensor:
        if self.bert:
            return F.embedding(txt.long(), self.txt_embedding.weight).to(
                self.compute_dtype)
        if not txt.is_floating_point():
            raise ValueError("note token ids need --berttype bert (the "
                             "token table); this model projects BioBERT "
                             "embeddings")
        if txt.dim() == 2:
            txt = txt[:, None, :]
        return _dense(txt, self.txt_embedding, self.compute_dtype)


def _check_inputs(cfg: Config) -> None:
    """The cross transformer runs carryforward vital signs and notes."""
    mods = cfg.input_types.split("_")
    if "img" in mods:
        raise NotImplementedError(
            f"--input-types {cfg.input_types}: the legacy models' image "
            "backbones are ROADMAP Queue 1 item 7")
    if mods != ["vslt", "txt"]:
        raise NotImplementedError(
            f"--input-types {cfg.input_types}: the cross transformer runs "
            "vslt_txt")
    if cfg.vslt_type != "carryforward":
        raise NotImplementedError(
            f"--vslt-type {cfg.vslt_type}: the legacy models read the "
            "carryforward grid (pass --vslt-type carryforward)")


def _modal_tokens(model: nn.Module, batch: Dict[str, torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """vslt and txt tokens and their validity masks (True = valid): vslt
    from the carryforward grid, valid up to ``input_length``; txt from the
    notes, valid up to clip(txt_length + 2, 1, T) (JAX legacy.py:293-314)."""
    vslt = model.vslt_tokens(batch)
    txt = model.txt_tokens(batch["txt"])
    T = txt.shape[1]
    valid = [~length_key_mask(batch["input_length"].long(), vslt.shape[1]),
             ~length_key_mask(
                 torch.clamp(batch["txt_length"].long() + 2, 1, T), T)]
    return [vslt, txt], valid


def _head(cfg: Config, head: ClsHead, x: torch.Tensor) -> torch.Tensor:
    logits = head(x)
    return logits[..., 0] if cfg.output_dim == 1 else logits


class CROSS_TRANSFORMER(nn.Module):
    """Self-attention stacks per modality, then bidirectional cross-modal
    layers, masked mean pooling of each stream, ``merge``, ReLU, LayerNorm
    and the classifier head (JAX legacy.py:433-475). ``--transformer-num-
    layers`` n gives max(n // 2, 1) self layers per stream, then
    max(n - n // 2, 1) cross layers; each cross layer updates vslt from
    the txt stream and txt from the vslt stream it was given."""

    def __init__(self, cfg: Config):
        super().__init__()
        _check_inputs(cfg)
        self.cfg = cfg
        dt = model_dtype(cfg)
        self.compute_dtype = dt
        D, H = cfg.transformer_dim, cfg.transformer_num_head
        n_self = max(cfg.transformer_num_layers // 2, 1)
        n_cross = max(cfg.transformer_num_layers - n_self, 1)
        self.n_self, self.n_cross = n_self, n_cross
        self.vslt_tokens = _VsltTokens(cfg, dt)
        self.txt_tokens = _TxtTokens(cfg, dt)
        for i in range(n_self):
            for s in ("v", "o"):
                self.add_module(f"self_{s}_{i}", TransformerEncoderLayer(
                    D, H, 4 * D, cfg.dropout, dt))
        for i in range(n_cross):
            for s in ("v", "o"):
                self.add_module(f"cross_{s}_{i}",
                                CrossmodalTransformerEncoderLayer(
                                    D, H, 4 * D, cfg.dropout, dt))
        self.merge = nn.Linear(2 * D, D)
        self.final_ln = LayerNorm(D, dt)
        self.fc_list = ClsHead(D, D, cfg.output_dim, cfg.activation, dt)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``seeds``: the step's dropout seeds, needed in training mode.
        Returns (logits, None, None): no aux-rmse head, no aux loss."""
        del missing_num
        dt = self.compute_dtype
        tokens, valid = _modal_tokens(self, batch)
        v, o = tokens
        v_mask, o_mask = ~valid[0], ~valid[1]
        for i in range(self.n_self):
            v = getattr(self, f"self_v_{i}")(v, v_mask, seeds)
            o = getattr(self, f"self_o_{i}")(o, o_mask, seeds)
        for i in range(self.n_cross):
            v_new = getattr(self, f"cross_v_{i}")(v, o, o_mask, seeds)
            o = getattr(self, f"cross_o_{i}")(o, v, v_mask, seeds)
            v = v_new
        vw = valid[0].to(dt)[..., None]
        ow = valid[1].to(dt)[..., None]
        v_feat = (v * vw).sum(1) / vw.sum(1).clamp_min(1.0)
        o_feat = (o * ow).sum(1) / ow.sum(1).clamp_min(1.0)
        x = _dense(torch.cat([v_feat, o_feat], dim=-1), self.merge, dt)
        x = self.final_ln(torch.relu(x))
        return _head(self.cfg, self.fc_list, x), None, None
