"""Legacy model families (counterpart of medical_tri_modal_pilot_tpu/models/
legacy.py; reference builder/models/{1,2,4,5,6}_*): the earlier models the
reference keeps outside its live registry, as a few configurable
archetypes registered under every reference file name (``LEGACY``):

  1_uni_vslt   time (``T_TRANSFORMER``), feature (``F_TRANSFORMER``) and
               dual (``FT_TRANSFORMER``) transformers, GRU-D into a time
               transformer (``GRUD_T_TRANSFORMER``); ``binary_*`` and
               ``multi_*`` alike, and the GRU-D / LSTM aliases
  2_uni_image  CXR classifiers over a backbone (``UNI_IMAGE``)
  4/5/6        early (``EARLYFUSION``), mid (``MIDFUSION``) and late
               (``LATEFUSION``) fusion and the cross-modal transformer
               (``CROSS_TRANSFORMER``) of carryforward vital signs with
               images and/or notes; the MBT aliases
  5 auxcpc_*   the contrastive-pretraining family (``AUXCPC``)

All read the carryforward grid (``--vslt-type carryforward``; the image
classifiers read no vital signs) and return (logits, None, aux): aux is
``AUXCPC``'s auxiliary loss, which the Trainer adds with
``--auxiliary-loss-weight``, and None elsewhere.

The modules are named after the JAX parameter tree (``vslt_tokens``,
``txt_tokens``, ``img_backbone``, ``img_proj``, ``layers_{i}``,
``self_{v,o}_i``, ``cross_{v,o}_i``, ``merge``, ``final_ln``,
``fc_list``, ``c_t_model``, ``ct_weight``, ...), so
``models/convert.py::from_jax_variables`` carries JAX weights across with
a strict load. Every encoder layer goes through ``ops.attn_block`` and
``ops.ffn`` (the cross layers' attention through ``ops.attention``), the
Swin trunk through ``ops.swin_attention`` and ``ops.swin_mlp``, the input
dropout through ``ops.dropout_masks``; the ResNet, ViT and MaxViT
backbones, GRU-D and the auxiliary losses are plain PyTorch, as the JAX
package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from . import baselines as BL
from . import models as M
from .baselines import (GRUDCell, _unpack_carryforward, _with_demo,
                        grud_states)
from .encoder import TransformerEncoder
from .heads import ClsHead, flax_batch_norm
from .mbt import MBTFusion
from .models import ModelOutput, model_dtype
from .modules import (CrossmodalTransformerEncoderLayer, DropoutSeeds,
                      LayerNorm, TransformerEncoderLayer, dense, dropout,
                      length_key_mask, positional_encoding)
from .swin import PatchStem
from .umse import BERT_VOCAB

# CPC split point and predicted future steps (auxcpc_early.py:161, :105)
T_SAMPLES = 24
CPC_STEPS = 12
# the longest joint stream the positional table covers
PE_MAXLEN = 5000


def _check_inputs(cfg: Config) -> None:
    """The legacy models read the carryforward grid."""
    if cfg.vslt_type != "carryforward":
        raise NotImplementedError(
            f"--vslt-type {cfg.vslt_type}: the legacy models read the "
            "carryforward grid (pass --vslt-type carryforward)")
    if "img" in cfg.input_types.split("_") and cfg.multiimages == 1:
        raise ValueError(f"--multiimages 1: --model {cfg.model} takes one "
                         "image per sample")


class GRUDEncoder(nn.Module):
    """GRU-D over the carryforward grid (JAX legacy.py:50-73): the input
    decay ``input_decay_w`` / ``_b`` and the cell ``gru``, as ``gru_d``
    runs them (``baselines.grud_states``). Returns (the state at
    clip(input_length - 1, 0, T - 1), every step's state), in dt."""

    def __init__(self, cfg: Config, dtype: torch.dtype):
        super().__init__()
        F_ = cfg.vslt_len
        self.compute_dtype = dtype
        self.input_decay_w = nn.Parameter(torch.zeros(F_))
        self.input_decay_b = nn.Parameter(torch.zeros(F_))
        self.register_buffer("x_mean", torch.as_tensor(
            cfg.feature_means, dtype=torch.float32), persistent=False)
        self.gru = GRUDCell(F_, cfg.transformer_dim)

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.compute_dtype
        x, m, d = (t.to(dt) for t in _unpack_carryforward(batch))
        B, T, _ = x.shape
        hs = grud_states(self.gru, self.input_decay_w, self.input_decay_b,
                         self.x_mean, x, m, d, dt)
        idx = (batch["input_length"].long() - 1).clamp(0, T - 1)
        last = hs[torch.arange(B, device=x.device), idx]
        return last.to(dt), hs.to(dt)


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
        return dense(self.init_fc, x, self.compute_dtype)


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
        return dense(self.txt_embedding, txt, self.compute_dtype)


class ImageBackbone(nn.Module):
    """The CXR backbone of ``kind`` (``--img-model-type``, or the model's
    own; JAX legacy.py:90-128): ``resnet18`` / ``resnet50``
    (``models/resnet.py``), ``maxvit``, ``vit`` (ViT-B/16), ``swin`` (the
    Swin-T trunk, trainable: stochastic depth in training mode), anything
    else the patch stem (``patch_embedding``, 16 x 16 to d_model). Returns
    (pooled [B, C], tokens [B, N, C]); ``width`` is C."""

    def __init__(self, cfg: Config, dtype: torch.dtype,
                 kind: Optional[str] = None):
        super().__init__()
        trunk = M.image_trunk(cfg, kind or cfg.img_model_type, dtype)
        if isinstance(trunk, PatchStem):
            self.patch_embedding = trunk
            self.width = cfg.transformer_dim
        else:
            self.img_encoder = trunk
            self.width = trunk.feature_dim

    def forward(self, img: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        trunk = (self.img_encoder if hasattr(self, "img_encoder")
                 else self.patch_embedding)
        toks = M.trunk_tokens(trunk, img, seeds)
        return toks.mean(dim=1), toks


def _txt_valid(batch: Dict[str, torch.Tensor], T: int) -> torch.Tensor:
    """The valid note rows: clip(txt_length + 2, 1, T) (JAX legacy.py:
    311-313)."""
    n = torch.clamp(batch["txt_length"].long() + 2, 1, T)
    return ~length_key_mask(n, T)


def _head(cfg: Config, head: ClsHead, x: torch.Tensor) -> torch.Tensor:
    logits = head(x)
    return logits[..., 0] if cfg.output_dim == 1 else logits


class _Streams(nn.Module):
    """The per-modality tokens of the fusion archetypes (JAX legacy.py:
    293-314), in ``--input-types`` order: ``vslt_tokens`` (valid up to
    ``input_length``); the backbone's tokens (``img_backbone``, through
    ``img_proj`` where their width is not d_model), always valid, a
    missing image's too; ``txt_tokens`` (valid up to clip(txt_length + 2,
    1, T))."""

    def __init__(self, cfg: Config):
        super().__init__()
        _check_inputs(cfg)
        self.cfg = cfg
        self.mods = cfg.input_types.split("_")
        dt = self.compute_dtype = model_dtype(cfg)
        D = cfg.transformer_dim
        self.vslt_tokens = _VsltTokens(cfg, dt)
        if "img" in self.mods:
            self.img_backbone = ImageBackbone(cfg, dt)
            if self.img_backbone.width != D:
                self.img_proj = nn.Linear(self.img_backbone.width, D)
        if "txt" in self.mods:
            self.txt_tokens = _TxtTokens(cfg, dt)

    def layer(self, cross: bool = False) -> nn.Module:
        cfg = self.cfg
        D = cfg.transformer_dim
        if cross:
            return CrossmodalTransformerEncoderLayer(
                D, cfg.transformer_num_head, 4 * D, cfg.dropout,
                self.compute_dtype)
        return TransformerEncoderLayer(D, cfg.transformer_num_head, 4 * D,
                                       cfg.dropout, self.compute_dtype,
                                       cfg.remat == 1)

    def modal_tokens(self, batch: Dict[str, torch.Tensor],
                     seeds: Optional[DropoutSeeds]
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The streams' tokens and validity masks (True = valid)."""
        vslt = self.vslt_tokens(batch)
        tokens = [vslt]
        valid = [~length_key_mask(batch["input_length"].long(),
                                  vslt.shape[1])]
        if "img" in self.mods:
            _, toks = self.img_backbone(batch["img"], seeds)
            if hasattr(self, "img_proj"):
                toks = dense(self.img_proj, toks, self.compute_dtype)
            tokens.append(toks)
            valid.append(torch.ones(toks.shape[:2], dtype=torch.bool,
                                    device=toks.device))
        if "txt" in self.mods:
            toks = self.txt_tokens(batch["txt"])
            tokens.append(toks)
            valid.append(_txt_valid(batch, toks.shape[1]))
        return tokens, valid


# ---------------------------------------------------------------------------
# 1_uni_vslt
# ---------------------------------------------------------------------------

def _encoder(cfg: Config, dt: torch.dtype, use_pe: bool = True,
             mask: bool = True) -> TransformerEncoder:
    D = cfg.transformer_dim
    return TransformerEncoder(
        n_layers=cfg.transformer_num_layers,
        n_head=cfg.transformer_num_head, d_model=D, d_ff=4 * D,
        dropout=cfg.dropout, use_pe=use_pe, dtype=dt,
        remat=cfg.remat == 1, mask=mask)


def _feature_traces(batch: Dict[str, torch.Tensor], dt: torch.dtype
                    ) -> torch.Tensor:
    """One row per feature, its [x; m] trace: [B, F, 2T]."""
    x, m, _ = _unpack_carryforward(batch)
    return torch.cat([x, m], dim=1).to(dt).transpose(1, 2)


class _UniVslt(nn.Module):
    """The 1_uni_vslt transformers' ``final_ln`` and ``fc_list`` over the
    cls row(s) (JAX legacy.py:160-262)."""

    def __init__(self, cfg: Config):
        super().__init__()
        _check_inputs(cfg)
        self.cfg = cfg
        dt = self.compute_dtype = model_dtype(cfg)
        D = cfg.transformer_dim
        self.final_ln = LayerNorm(D, dt)
        self.fc_list = ClsHead(D, D, cfg.output_dim, cfg.activation, dt)

    def classify(self, x: torch.Tensor) -> ModelOutput:
        return _head(self.cfg, self.fc_list, self.final_ln(x)), None, None


class T_TRANSFORMER(_UniVslt):
    """The time-axis transformer: the init_fc tokens through the encoder
    (PE, a cls token, key mask ``input_length + 1``); ``final_ln`` on the
    cls row (binary_t_transformer.py)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.vslt_tokens = _VsltTokens(cfg, self.compute_dtype)
        self.transformer_encoder = _encoder(cfg, self.compute_dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        enc = self.transformer_encoder(self.vslt_tokens(batch),
                                       batch["input_length"].long() + 1,
                                       seeds)
        return self.classify(enc[:, 0])


class F_TRANSFORMER(_UniVslt):
    """The feature-axis transformer: one token per feature from its
    [x; m] trace (``feat_embed``, 2T -> d), no PE, no key mask
    (binary_f_transformer.py)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.feat_embed = nn.Linear(2 * cfg.window_size, cfg.transformer_dim)
        self.transformer_encoder = _encoder(cfg, self.compute_dtype,
                                            use_pe=False, mask=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        dt = self.compute_dtype
        tokens = dense(self.feat_embed, _feature_traces(batch, dt), dt)
        return self.classify(self.transformer_encoder(tokens, None,
                                                      seeds)[:, 0])


class FT_TRANSFORMER(_UniVslt):
    """Both stacks (``t_encoder`` over time, ``f_encoder`` over features),
    their cls rows concatenated through ``merge`` (multi_ft_transformer.
    py)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        dt, D = self.compute_dtype, cfg.transformer_dim
        self.vslt_tokens = _VsltTokens(cfg, dt)
        self.t_encoder = _encoder(cfg, dt)
        self.feat_embed = nn.Linear(2 * cfg.window_size, D)
        self.f_encoder = _encoder(cfg, dt, use_pe=False, mask=False)
        self.merge = nn.Linear(2 * D, D)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        dt = self.compute_dtype
        t_enc = self.t_encoder(self.vslt_tokens(batch),
                               batch["input_length"].long() + 1, seeds)
        f_tokens = dense(self.feat_embed, _feature_traces(batch, dt), dt)
        f_enc = self.f_encoder(f_tokens, None, seeds)
        feats = torch.cat([t_enc[:, 0], f_enc[:, 0]], dim=-1)
        return self.classify(dense(self.merge, feats, dt))


class GRUD_T_TRANSFORMER(_UniVslt):
    """GRU-D's state sequence through the time encoder
    (binary_gru_d_t_transformer.py)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.grud = GRUDEncoder(cfg, self.compute_dtype)
        self.transformer_encoder = _encoder(cfg, self.compute_dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        _, hs = self.grud(batch)
        enc = self.transformer_encoder(hs, batch["input_length"].long() + 1,
                                       seeds)
        return self.classify(enc[:, 0])


# ---------------------------------------------------------------------------
# 2_uni_image
# ---------------------------------------------------------------------------

class UNI_IMAGE(nn.Module):
    """The CXR-only classifier: the backbone's pooled feature through
    ``fc`` (2_uni_image/{resnet,resnet_enc,swin_transformer,vit,
    vit_monai}.py; JAX legacy.py:269-286). ``backbone`` overrides
    ``--img-model-type``."""

    def __init__(self, cfg: Config, backbone: Optional[str] = None):
        super().__init__()
        if cfg.multiimages == 1:
            raise ValueError(f"--multiimages 1: --model {cfg.model} takes "
                             "one image per sample")
        self.cfg = cfg
        dt = self.compute_dtype = model_dtype(cfg)
        self.img_backbone = ImageBackbone(cfg, dt, backbone)
        self.fc = nn.Linear(self.img_backbone.width, cfg.output_dim)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        pooled, _ = self.img_backbone(batch["img"], seeds)
        logits = dense(self.fc, pooled, self.compute_dtype)
        return (logits[..., 0] if self.cfg.output_dim == 1
                else logits), None, None


# ---------------------------------------------------------------------------
# 4/5/6 — fusion archetypes
# ---------------------------------------------------------------------------

class EARLYFUSION(_Streams):
    """Every stream's tokens behind one cls token, one joint encoder
    (``layer_norm_in``, PE over the whole length, input dropout,
    ``layers_{i}`` under the joint key mask), ``final_ln`` on the cls row
    (4_bi/earlyfusion_img_vslt.py:63-76, 5_bi/earlyfusion_vslt_txt_
    transformer.py, 6_tri/earlyfusion_*; JAX legacy.py:317-345). At tri
    on Swin-T: 1 + 24 + 49 + 128 = 202 rows, the image rows valid between
    the masked vslt and note tails."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        D, dt = cfg.transformer_dim, self.compute_dtype
        self.cls_tokens = nn.Parameter(torch.zeros(1, 1, D))
        self.layer_norm_in = LayerNorm(D, dt)
        for i in range(cfg.transformer_num_layers):
            setattr(self, f"layers_{i}", self.layer())
        self.final_ln = LayerNorm(D, dt)
        self.fc_list = ClsHead(D, D, cfg.output_dim, cfg.activation, dt)
        self.register_buffer("pe", positional_encoding(PE_MAXLEN, D),
                             persistent=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        cfg, dt = self.cfg, self.compute_dtype
        tokens, valid = self.modal_tokens(batch, seeds)
        B, D = tokens[0].shape[0], cfg.transformer_dim
        x = torch.cat([self.cls_tokens.expand(B, 1, D).to(dt)] + tokens,
                      dim=1)
        ones = torch.ones(B, 1, dtype=torch.bool, device=x.device)
        key_mask = ~torch.cat([ones] + valid, dim=1)
        h = self.layer_norm_in(x) + self.pe[:, :x.shape[1]].to(dt)
        h = dropout(h, cfg.dropout, self.training, seeds)
        for i in range(cfg.transformer_num_layers):
            h = getattr(self, f"layers_{i}")(h, key_mask, seeds)
        return _head(cfg, self.fc_list, self.final_ln(h[:, 0])), None, None


class _VsltFeature(nn.Module):
    """The pooled vslt feature: GRU-D's last state (``grud``) or the time
    encoder's cls row (``ttrans``: ``vslt_tokens``, ``t_encoder``)."""

    def __init__(self, cfg: Config, kind: str, dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        if kind == "grud":
            self.grud = GRUDEncoder(cfg, dtype)
        else:
            self.vslt_tokens = _VsltTokens(cfg, dtype)
            self.t_encoder = _encoder(cfg, dtype)

    def forward(self, batch: Dict[str, torch.Tensor],
                seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        if self.kind == "grud":
            return self.grud(batch)[0]
        return self.t_encoder(self.vslt_tokens(batch),
                              batch["input_length"].long() + 1, seeds)[:, 0]


class _PooledFusion(nn.Module):
    """The mid and late fusions' two pooled features (JAX legacy.py:
    348-389): ``vslt_feature``, and the image backbone's pooled feature
    through ``img_proj`` or the masked mean of the note tokens."""

    def __init__(self, cfg: Config, vslt_kind: str):
        super().__init__()
        _check_inputs(cfg)
        self.cfg = cfg
        dt = self.compute_dtype = model_dtype(cfg)
        D = cfg.transformer_dim
        self.vslt_feature = _VsltFeature(cfg, vslt_kind, dt)
        self.img = "img" in cfg.input_types
        if self.img:
            self.img_backbone = ImageBackbone(cfg, dt)
            self.img_proj = nn.Linear(self.img_backbone.width, D)
        else:
            self.txt_tokens = _TxtTokens(cfg, dt)

    def features(self, batch: Dict[str, torch.Tensor],
                 seeds: Optional[DropoutSeeds]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dt = self.compute_dtype
        v = self.vslt_feature(batch, seeds)
        if self.img:
            pooled, _ = self.img_backbone(batch["img"], seeds)
            return v, dense(self.img_proj, pooled, dt)
        toks = self.txt_tokens(batch["txt"])
        w = _txt_valid(batch, toks.shape[1]).to(dt)[..., None]
        return v, (toks * w).sum(1) / w.sum(1).clamp_min(1.0)


class MIDFUSION(_PooledFusion):
    """The two pooled features concatenated, ``final_ln``, ``merge``, ReLU
    and the head (4_bi/midfusion_img_trans_vslt_{grud,ttrans}.py,
    5_bi/midfusion_vslt_txt_transformer.py)."""

    def __init__(self, cfg: Config, vslt_kind: str = "ttrans"):
        super().__init__(cfg, vslt_kind)
        D, dt = cfg.transformer_dim, self.compute_dtype
        self.final_ln = LayerNorm(2 * D, dt)
        self.merge = nn.Linear(2 * D, D)
        self.fc_list = ClsHead(D, D, cfg.output_dim, cfg.activation, dt)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        v, o = self.features(batch, seeds)
        x = dense(self.merge, self.final_ln(torch.cat([v, o], dim=-1)),
                  self.compute_dtype)
        return _head(self.cfg, self.fc_list, torch.relu(x)), None, None


class LATEFUSION(_PooledFusion):
    """A head per feature (``v_ln`` -> ``fc_vslt``, ``o_ln`` ->
    ``fc_other``), their logits averaged (4_bi/latefusion_img_trans_vslt_
    {grud,ttrans}.py, 5_bi/latefusion_vslt_{grud_,}txt_transformer.py)."""

    def __init__(self, cfg: Config, vslt_kind: str = "ttrans"):
        super().__init__(cfg, vslt_kind)
        D, dt = cfg.transformer_dim, self.compute_dtype
        for s in ("v", "o"):
            setattr(self, f"{s}_ln", LayerNorm(D, dt))
        for s in ("vslt", "other"):
            setattr(self, f"fc_{s}", ClsHead(D, D, cfg.output_dim,
                                             cfg.activation, dt))

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        v, o = self.features(batch, seeds)
        lv = _head(self.cfg, self.fc_vslt, self.v_ln(v))
        lo = _head(self.cfg, self.fc_other, self.o_ln(o))
        return (lv + lo) / 2, None, None


class CROSS_TRANSFORMER(_Streams):
    """Self-attention stacks per modality, then bidirectional cross-modal
    layers, masked mean pooling of each stream, ``merge``, ReLU, LayerNorm
    and the classifier head (4_bi/cross_transformer_img_vslt_sssccc.py,
    5_bi/{bi_,}cross_transformer_txt_vslt.py; JAX legacy.py:433-475).
    ``--transformer-num-layers`` n gives max(n // 2, 1) self layers per
    stream, then max(n - n // 2, 1) cross layers; each cross layer
    updates vslt from the other stream (the first after vslt in
    ``--input-types``) and that stream from the vslt stream it was
    given."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        if len(self.mods) < 2:
            raise ValueError(f"--input-types {cfg.input_types}: the cross "
                             "transformer fuses vslt with img or txt")
        D, dt = cfg.transformer_dim, self.compute_dtype
        n_self = max(cfg.transformer_num_layers // 2, 1)
        n_cross = max(cfg.transformer_num_layers - n_self, 1)
        self.n_self, self.n_cross = n_self, n_cross
        for i in range(n_self):
            for s in ("v", "o"):
                self.add_module(f"self_{s}_{i}", self.layer())
        for i in range(n_cross):
            for s in ("v", "o"):
                self.add_module(f"cross_{s}_{i}", self.layer(cross=True))
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
        tokens, valid = self.modal_tokens(batch, seeds)
        v, o = tokens[:2]
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
        x = dense(self.merge, torch.cat([v_feat, o_feat], dim=-1), dt)
        x = self.final_ln(torch.relu(x))
        return _head(self.cfg, self.fc_list, x), None, None


# ---------------------------------------------------------------------------
# 5_bi_vslt_txt auxcpc_* — contrastive auxiliary losses
# ---------------------------------------------------------------------------

def _cosine_rows(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7):
    """Per-row cosine similarity, the denominator clamped at eps (torch
    CosineSimilarity(dim=1), auxcpc_early.py:131)."""
    num = (a * b).sum(-1)
    return num / torch.clamp(a.norm(dim=-1) * b.norm(dim=-1), min=eps)


class AUXCPC(nn.Module):
    """The vslt + notes CPC family (5_bi_vslt_txt/auxcpc_*.py; JAX
    legacy.py:494-678). The vslt stream z [B, L, d] is the init_fc tokens
    (``ttrans``) or GRU-D's state sequence (``grud``). On a window of
    more than 24 rows (the 36-row windows of ``--auxiliary-loss-input``)
    the 12 rows after row 24 are the auxiliary targets and the fusion
    sees the first 24 only.

    ``fusion``: ``early`` (a cls token, ``layer_norm_in``, PE, the joint
    encoder ``layers_{i}`` over [cls, z, notes]; its cls row is c_t) or
    ``mbt`` (``c_t_model``, a bimodal bottleneck fusion with PE and key
    masks on both streams and every sample counted as having both, its
    two cls rows concatenated through ``layer_norms_after_concat``).
    ``wiring``: ``predict`` (the future encoded steps predicted as c_t
    ``ct_weight[t]``, [12, ct_dim, d]), ``direct`` (the same against the
    raw future features, ct_weight [12, ct_dim, F]), or ``ct`` (the
    future steps and the notes through the same fusion to a mirror c_t,
    LayerNormed). ``post_ln`` (and ``ct``) LayerNorms an early c_t.

    Loss (``--auxiliary-loss-type``, in fp32, ``f_indices``-weighted):
    ``cpc`` the in-batch softmax over the [12B, 12B] scores, invalid
    targets and a sample's other steps filled with -65504; ``cosine``;
    ``l2``; with ``Wbrl`` the prediction first through ``brl_bn`` (flax's
    BatchNorm at momentum 0.9), the activation and ``brl_fc``. Under
    ``ct``: minus the cosine of the flattened batches, or the mean l2;
    ``cpc`` gives 0. The auxiliary parameters exist where the windows have
    future rows, under ``--auxiliary-loss-input``, as the JAX model
    creates them on such windows."""

    def __init__(self, cfg: Config, vslt_kind: str = "ttrans",
                 fusion: str = "early", wiring: str = "predict",
                 post_ln: bool = False):
        super().__init__()
        _check_inputs(cfg)
        if "txt" not in cfg.input_types.split("_"):
            raise ValueError(f"--input-types {cfg.input_types}: --model "
                             f"{cfg.model} fuses vslt_txt")
        self.cfg = cfg
        self.vslt_kind, self.fusion, self.wiring = vslt_kind, fusion, wiring
        dt = self.compute_dtype = model_dtype(cfg)
        D, L = cfg.transformer_dim, cfg.transformer_num_layers
        if vslt_kind == "grud":
            self.grud = GRUDEncoder(cfg, dt)
        else:
            self.vslt_tokens = _VsltTokens(cfg, dt)
        self.txt_tokens = _TxtTokens(cfg, dt)
        ct_dim = D
        if fusion == "mbt":
            self.c_t_model = MBTFusion(
                2, 4, cfg.mbt_fusion_startidx, L, cfg.transformer_num_head,
                D, 4 * D, cfg.dropout, pe_maxlen=600, txt_idx=1,
                use_pe=(True, True), mask=(True, True), dtype=dt,
                remat=cfg.remat == 1)
            ct_dim = 2 * D
            self.layer_norms_after_concat = LayerNorm(ct_dim, dt)
        else:
            self.cls_tokens = nn.Parameter(torch.zeros(1, 1, D))
            self.layer_norm_in = LayerNorm(D, dt)
            for i in range(L):
                setattr(self, f"layers_{i}", TransformerEncoderLayer(
                    D, cfg.transformer_num_head, 4 * D, cfg.dropout, dt,
                    cfg.remat == 1))
            if post_ln or wiring == "ct":
                self.layer_norms_after_concat = LayerNorm(D, dt)
            self.register_buffer("pe", positional_encoding(PE_MAXLEN, D),
                                 persistent=False)
        self.fc_list = ClsHead(ct_dim, D, cfg.output_dim, cfg.activation, dt)
        self.aux_type = cfg.auxiliary_loss_type or ""
        self.pretrain = cfg.auxiliary_loss_input is not None
        if not self.pretrain:
            return
        if wiring == "ct":
            self.layer_norms_after_concat_mirror = LayerNorm(ct_dim, dt)
            return
        Fd = cfg.vslt_len if wiring == "direct" else D
        self.ct_weight = nn.Parameter(torch.zeros(CPC_STEPS, ct_dim, Fd))
        if "Wbrl" in self.aux_type:
            self.brl_bn = nn.BatchNorm1d(Fd, eps=1e-5)
            self.brl_fc = nn.Linear(Fd, Fd)

    def fuse(self, v_toks: torch.Tensor, v_len: torch.Tensor,
             t_tokens: torch.Tensor, batch: Dict[str, torch.Tensor],
             seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """c_t of the vslt tokens (``v_len`` valid rows) and the notes."""
        dt, D = self.compute_dtype, self.cfg.transformer_dim
        B = v_toks.shape[0]
        if self.fusion == "mbt":
            zeros = torch.zeros(B, dtype=torch.long, device=v_toks.device)
            outs = self.c_t_model(
                [v_toks, t_tokens], [v_len, batch["txt_length"].long() + 2],
                zeros, seeds)
            return torch.cat([outs[0][:, 0], outs[1][:, 0]], dim=-1)
        x = torch.cat([self.cls_tokens.expand(B, 1, D).to(dt), v_toks,
                       t_tokens], dim=1)
        ones = torch.ones(B, 1, dtype=torch.bool, device=x.device)
        key_mask = ~torch.cat([ones, ~length_key_mask(v_len, v_toks.shape[1]),
                               _txt_valid(batch, t_tokens.shape[1])], dim=1)
        h = self.layer_norm_in(x) + self.pe[:, :x.shape[1]].to(dt)
        for i in range(self.cfg.transformer_num_layers):
            h = getattr(self, f"layers_{i}")(h, key_mask, seeds)
        return h[:, 0]

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """Returns (logits, None, the auxiliary loss: an fp32 scalar, 0
        on a window without future rows)."""
        x_raw = _unpack_carryforward(batch)[0]
        if self.vslt_kind == "grud":
            z = self.grud(batch)[1]
        else:
            z = self.vslt_tokens(batch)
        t_tokens = self.txt_tokens(batch["txt"])
        B, Lv = z.shape[:2]
        v_len = batch["input_length"].long()
        has_future = Lv > T_SAMPLES
        if has_future and not self.pretrain:
            raise ValueError(f"a {Lv}-row window: --model {self.cfg.model} "
                             "takes future rows under --auxiliary-loss-input")
        z_in = z[:, :T_SAMPLES] if has_future else z
        c_t = self.fuse(z_in, v_len, t_tokens, batch, seeds)
        if hasattr(self, "layer_norms_after_concat"):
            c_t = self.layer_norms_after_concat(c_t)
        logits = _head(self.cfg, self.fc_list, c_t)
        aux = torch.zeros((), dtype=torch.float32, device=z.device)
        if has_future:
            aux = self.aux_loss(c_t, z, x_raw, t_tokens, batch, seeds)
        return logits, None, aux

    def aux_loss(self, c_t, z, x_raw, t_tokens, batch, seeds) -> torch.Tensor:
        """The auxiliary loss of a window with future rows (JAX
        legacy.py:612-677)."""
        T = min(CPC_STEPS, z.shape[1] - T_SAMPLES)
        enc_samples = z[:, T_SAMPLES:T_SAMPLES + T]
        c32 = c_t.float()
        aux_type = self.aux_type
        zero = torch.zeros((), dtype=torch.float32, device=z.device)
        if self.wiring == "ct":
            B = z.shape[0]
            full = torch.full((B,), T, dtype=torch.long, device=z.device)
            mirror = self.layer_norms_after_concat_mirror(
                self.fuse(enc_samples, full, t_tokens, batch, seeds))
            m32 = mirror.float()
            if "cosine" in aux_type:
                return -_cosine_rows(c32.reshape(1, -1),
                                     m32.reshape(1, -1))[0]
            if "l2" in aux_type:
                return ((c32 - m32) ** 2).mean()
            return zero
        tgt = (x_raw[:, T_SAMPLES:T_SAMPLES + T] if self.wiring == "direct"
               else enc_samples).float()                     # [B, T, F]
        Fd = tgt.shape[-1]
        f = batch["f_indices"][:, -CPC_STEPS:][:, :T].float()
        pred = torch.einsum("bd,tdf->btf", c32, self.ct_weight[:T])
        if "Wbrl" in aux_type:
            pred = flax_batch_norm(pred, self.brl_bn, self.training, 0.9)
            pred = (torch.relu(pred) if self.cfg.activation == "relu"
                    else F.selu(pred))
            pred = F.linear(pred, self.brl_fc.weight, self.brl_fc.bias)
        pf, tf_, fv = pred.reshape(-1, Fd), tgt.reshape(-1, Fd), f.reshape(-1)
        count = fv.sum().clamp_min(1.0)
        if "cpc" in aux_type:
            total = pf @ tf_.t()                              # [BT, BT]
            fill = torch.tensor(-65504.0, device=z.device)
            total = torch.where(fv[None, :] != 1, fill, total)
            idx = torch.arange(pf.shape[0], device=z.device)
            offdiag = ((idx[:, None] // T) == (idx[None, :] // T)) \
                & (idx[:, None] != idx[None, :])
            total = torch.where(offdiag, fill, total)
            diag_p = torch.softmax(total, dim=1).diagonal()
            return (torch.log(diag_p * fv + 1e-7) * fv).sum() / -count
        if "cosine" in aux_type:
            return -(_cosine_rows(pf, tf_) * fv).sum() / count
        if "l2" in aux_type:
            return (((pf - tf_) ** 2).mean(dim=1) * fv).sum() / count
        return zero


# ---------------------------------------------------------------------------
# registry wiring
# ---------------------------------------------------------------------------

_p = functools.partial

# every reference legacy file name (JAX legacy.py:685-759)
LEGACY: Dict[str, Callable] = {
    # 1_uni_vslt
    "binary_t_transformer": T_TRANSFORMER,
    "multi_t_transformer": T_TRANSFORMER,
    "binary_f_transformer": F_TRANSFORMER,
    "multi_f_transformer": F_TRANSFORMER,
    "multi_ft_transformer": FT_TRANSFORMER,
    "binary_gru_d": BL.GRU_D,
    "multi_gru_d": BL.GRU_D,
    "binary_lstm": BL.LSTM_MODEL,
    "multi_lstm": BL.LSTM_MODEL,
    "binary_gru_d_t_transformer": GRUD_T_TRANSFORMER,
    "multi_gru_d_t_transformer": GRUD_T_TRANSFORMER,
    # 2_uni_image
    "resnet": _p(UNI_IMAGE, backbone="resnet18"),
    "resnet_enc": _p(UNI_IMAGE, backbone="resnet18"),
    "swin_transformer": _p(UNI_IMAGE, backbone="swin"),
    "vit": _p(UNI_IMAGE, backbone="vit"),
    "vit_monai": _p(UNI_IMAGE, backbone="patch"),
    "maxvit": _p(UNI_IMAGE, backbone="maxvit"),
    # 4_bi_vslt_img
    "earlyfusion_img_vslt": EARLYFUSION,
    "earlyfusion_img_vslt_v2": EARLYFUSION,
    "latefusion_img_trans_vslt_grud": _p(LATEFUSION, vslt_kind="grud"),
    "latefusion_img_trans_vslt_ttrans": LATEFUSION,
    "midfusion_img_trans_vslt_grud": _p(MIDFUSION, vslt_kind="grud"),
    "midfusion_img_trans_vslt_ttrans": MIDFUSION,
    "cross_transformer_img_vslt_sssccc": CROSS_TRANSFORMER,
    "mbt_v1_img": M.TRI_MBT_V1,
    # 5_bi_vslt_txt
    "earlyfusion_vslt_txt_transformer": EARLYFUSION,
    "latefusion_vslt_txt_transformer": LATEFUSION,
    "latefusion_vslt_grud_txt_transformer": _p(LATEFUSION,
                                               vslt_kind="grud"),
    "midfusion_vslt_txt_transformer": MIDFUSION,
    "cross_transformer_txt_vslt": CROSS_TRANSFORMER,
    "bi_cross_transformer_txt_vslt": CROSS_TRANSFORMER,
    "mbt_v1": M.TRI_MBT_V1,
    # fusion x wiring per reference file (see AUXCPC)
    "auxcpc_early": AUXCPC,
    "auxcpc_early2": _p(AUXCPC, post_ln=True),
    "auxcpc_early_ct": _p(AUXCPC, wiring="ct"),
    "auxcpc_early_direct": _p(AUXCPC, wiring="direct", post_ln=True),
    "auxcpc_grudtxt": _p(AUXCPC, vslt_kind="grud"),
    "auxcpc_grudtxt_ct": _p(AUXCPC, vslt_kind="grud", wiring="ct"),
    "auxcpc_grudtxt_dir": _p(AUXCPC, vslt_kind="grud", wiring="direct",
                             post_ln=True),
    "auxcpc_mbt": _p(AUXCPC, fusion="mbt"),
    "auxcpc_mbt_ct": _p(AUXCPC, fusion="mbt", wiring="ct"),
    "auxcpc_mbt_direct": _p(AUXCPC, fusion="mbt", wiring="direct"),
    # 6_tri_vslt_img_txt
    "earlyfusion_img_txt_vslt": EARLYFUSION,
    "mbt_v2": M.TRI_MBT_VSLTCLS,
}

# names whose model (and weight bridge) is one of the live registry's
ALIASES = {"binary_gru_d": "gru_d", "multi_gru_d": "gru_d",
           "binary_lstm": "lstm", "multi_lstm": "lstm",
           "mbt_v1_img": "tri_mbt_v1", "mbt_v1": "tri_mbt_v1",
           "mbt_v2": "tri_mbt_vsltcls"}
