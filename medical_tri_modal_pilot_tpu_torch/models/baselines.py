"""The paper's baseline families (counterpart of
medical_tri_modal_pilot_tpu/models/baselines.py): GRU-D (``gru_d``), the
LSTM EHR classifier (``lstm``) and the MedFuse / MMTM / DAFT fusion
baselines behind ``--fuse-baseline`` (``fusiontrainer``); reference
builder/models/1_uni_vslt/binary_gru_d.py, src/lstm.py,
src/baseline_{medfuse,mmtm,daft}.py, 8_missing_models/fusiontrainer.py.

All read the carryforward grid (``vslt`` [B, 3, T, F]: data, mask,
delta); the LSTM models append age and gender as two constant channels
(fusiontrainer.py:86-88). They return logits, as every model of the port
does.

The recurrences are the flax cells the JAX package scans, step by step:
``GRUCell`` (flax ``nn.GRUCell``: r, z, n from input denses ``ir``, ``iz``,
``in`` with biases and hidden denses ``hr``, ``hz`` without and ``hn``
with one; n = tanh(W_in x + b_in + r (W_hn h + b_hn)), h' = (1 - z) n +
z h) and ``LSTMCell`` (flax ``nn.OptimizedLSTMCell``: gates i, f, g, o;
input kernels ``ii`` .. ``io`` without bias, hidden ``hi`` .. ``ho`` with
one). Each keeps its flax denses as separate ``nn.Linear`` modules, so the
weight bridge carries them leaf for leaf; the forward concatenates them
into one input product over every step (the inputs of a layer are known
before its loop) and one hidden product per step. The products run in
the compute dtype; the gates and the carried state in fp32 (under bf16
the JAX cells keep them in bf16, under fp32 the two are the same
arithmetic). No cell has a TPU kernel: the JAX package runs them as
``nn.scan``, so the port's are plain PyTorch on every device.

The fixed dropout of the LSTM features (0.3, whatever ``--dropout`` says,
JAX baselines.py:111-150) draws its Philox mask from the step's
``DropoutSeeds`` (``modules.dropout``). ``fusiontrainer``'s Swin-T
(``cxr_model``) runs over every image row, unpacked, and trains unless
``--fusion-type`` holds ``uni_ehr``, where the JAX model stops its
gradient (baselines.py:185-187): the port runs it under ``no_grad`` then,
so its parameters get the zero gradient (and AdamW's decay) the
optimizer fills in. ``--fuse-baseline`` None takes Medfuse; ``Retain`` and
``Multi`` fall through to the DAFT branch, as in the JAX model
(baselines.py:177, :227).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from .heads import flax_batch_norm
from .models import ModelOutput, model_dtype
from .modules import DropoutSeeds, LayerNorm, dropout
from .swin import SwinTransformer
from .umse import BERT_VOCAB

# the BioBERT note vectors' width
TXT_WIDTH = 768
# the Swin-T trunk's feature width
CXR_WIDTH = 768


def _unpack_carryforward(batch: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """batch['vslt'] is [B, 3, T, F] (data, mask, delta)."""
    v = batch["vslt"]
    return v[:, 0], v[:, 1], v[:, 2]


def _with_demo(x: torch.Tensor, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Append age and gender as constant channels (fusiontrainer.py:86-88):
    [B, T, F] -> [B, T, F + 2]."""
    B, T, _ = x.shape
    static = batch["static"].to(x.dtype)
    age = static[:, 1][:, None, None].expand(B, T, 1)
    gen = static[:, 0][:, None, None].expand(B, T, 1)
    return torch.cat([x, age, gen], dim=-1)


def dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dt)``: x, the weight and the bias in dt."""
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


def _side_by_side(mods: List[nn.Linear], dt: torch.dtype
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The denses ``mods`` as one (weight, bias) in dt, their outputs
    concatenated in the order of ``mods``; a bias of 0 for those without
    one, None when none has one."""
    w = torch.cat([m.weight for m in mods]).to(dt)
    if all(m.bias is None for m in mods):
        return w, None
    b = torch.cat([torch.zeros_like(m.weight[:, 0]) if m.bias is None
                   else m.bias for m in mods]).to(dt)
    return w, b


def _fused(mods: List[nn.Linear], x: torch.Tensor, dt: torch.dtype
           ) -> torch.Tensor:
    """x through the denses ``mods`` side by side, in dt, to fp32."""
    return F.linear(x.to(dt), *_side_by_side(mods, dt)).float()


class GRUCell(nn.Module):
    """flax ``nn.GRUCell`` (see the module docstring for its layout)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in ("r", "z", "n"):
            setattr(self, f"i{g}", nn.Linear(d_in, hidden))
            setattr(self, f"h{g}", nn.Linear(hidden, hidden, bias=g == "n"))

    def gates(self, names: str) -> List[nn.Linear]:
        return [getattr(self, n) for n in names.split()]

    def input_proj(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """W_ir x + b_ir | W_iz x + b_iz | W_in x + b_in over x [..., d_in]
        -> fp32 [..., 3H]."""
        return _fused(self.gates("ir iz in"), x, dt)

    def hidden_weights(self, dt: torch.dtype):
        """hr | hz | hn as one weight, and their bias (hn's; 0 for hr and
        hz), in dt: a step's hidden product."""
        return _side_by_side(self.gates("hr hz hn"), dt)

    def step(self, h: torch.Tensor, xi: torch.Tensor, wh) -> torch.Tensor:
        """h' from the fp32 state h [B, H], this step's input_proj and
        ``hidden_weights``."""
        H = self.hidden
        w, b = wh
        hh = F.linear(h.to(w.dtype), w, b).float()
        r = torch.sigmoid(xi[:, :H] + hh[:, :H])
        z = torch.sigmoid(xi[:, H:2 * H] + hh[:, H:2 * H])
        n = torch.tanh(xi[:, 2 * H:] + r * hh[:, 2 * H:])
        return (1.0 - z) * n + z * h


class LSTMCell(nn.Module):
    """flax ``nn.OptimizedLSTMCell`` (see the module docstring)."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        for g in self.GATES:
            setattr(self, f"i{g}", nn.Linear(d_in, hidden, bias=False))
            setattr(self, f"h{g}", nn.Linear(hidden, hidden))

    def input_proj(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """The input kernels of i, f, g, o over x [..., d_in] -> fp32
        [..., 4H]."""
        return _fused([getattr(self, f"i{g}") for g in self.GATES], x, dt)

    def hidden_weights(self, dt: torch.dtype):
        """The hidden kernels and biases of i, f, g, o as one (weight, bias)
        in dt: a step's hidden product."""
        return _side_by_side([getattr(self, f"h{g}") for g in self.GATES],
                             dt)

    def step(self, c: torch.Tensor, h: torch.Tensor, xi: torch.Tensor,
             wh) -> Tuple[torch.Tensor, torch.Tensor]:
        """(c', h') from the fp32 carry, this step's input_proj and
        ``hidden_weights``."""
        H = self.hidden
        w, b = wh
        y = xi + F.linear(h.to(w.dtype), w, b).float()
        i, f, g, o = (y[:, k * H:(k + 1) * H] for k in range(4))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class MaskedLSTMCell(nn.Module):
    """An LSTM layer whose carry freezes past each sample's length and
    whose outputs there are 0 (JAX ``_MaskedLSTMCell``, the functional
    analog of pack_padded_sequence, src/lstm.py:39-44)."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.cell = LSTMCell(d_in, hidden)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, d_in], valid [B, T] bool -> (the outputs [B, T, H] in
        dt, the final fp32 hidden state [B, H])."""
        B, T, _ = x.shape
        H = self.cell.hidden
        xi = self.cell.input_proj(x, dt)
        wh = self.cell.hidden_weights(dt)
        keep = valid.to(torch.float32)[..., None]
        c = h = torch.zeros(B, H, dtype=torch.float32, device=x.device)
        ys = []
        for t in range(T):
            nc, nh = self.cell.step(c, h, xi[:, t], wh)
            k = keep[:, t]
            c = nc * k + c * (1.0 - k)
            h = nh * k + h * (1.0 - k)
            ys.append(nh * k)
        return torch.stack(ys, dim=1).to(dt), h


class LSTMEncoder(nn.Module):
    """Stacked masked LSTM layers ``layer{l}`` over padded sequences (JAX
    ``LSTMEncoder``, src/lstm.py:6-47). ``forward`` gives the last layer's
    outputs and final state; ``features`` the final state through the
    fixed dropout ``p``."""

    def __init__(self, d_in: int, hidden: int, layers: int, p: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = layers
        self.p = p
        self.compute_dtype = dtype
        for layer in range(layers):
            setattr(self, f"layer{layer}",
                    MaskedLSTMCell(d_in if layer == 0 else hidden, hidden))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, d_in], lengths [B] -> (outputs [B, T, H], final state
        [B, H]), both in the compute dtype."""
        T = x.shape[1]
        valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
        seq, h = x.to(self.compute_dtype), None
        for layer in range(self.layers):
            seq, h = getattr(self, f"layer{layer}")(seq, valid,
                                                    self.compute_dtype)
        return seq, h.to(self.compute_dtype)

    def features(self, x: torch.Tensor, lengths: torch.Tensor,
                 seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """The final state through the dropout (training mode)."""
        return dropout(self(x, lengths)[1], self.p, self.training, seeds)


class GRUDCell(nn.Module):
    """One GRU-D step's parameters (JAX ``_GRUDCell``, binary_gru_d.py:
    60-66): the hidden decay from delta (``hidden_decay``) and a GRU cell
    over [x_t | m_t] (``cell``)."""

    def __init__(self, n_features: int, hidden: int):
        super().__init__()
        self.hidden_decay = nn.Linear(n_features, hidden)
        self.cell = GRUCell(2 * n_features, hidden)


class GRU_D(nn.Module):
    """``gru_d`` (JAX baselines.py:46-83; binary_gru_d.py:8-73): the
    per-feature input decay exp(-relu(w delta + b)) imputing toward the
    population mean, the hidden decay, the GRU cell over [x_t | m_t]
    (``gru``), the state at ``input_length`` clipped to T - 1, then fc1
    (64) -> BatchNorm (flax's defaults: momentum 0.99, eps 1e-5, the
    biased batch variance) -> relu -> fc2. The imputation runs in fp32,
    as the JAX model's promotes there."""

    BN_MOMENTUM = 0.99

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = model_dtype(cfg)
        F_ = cfg.vslt_len
        H = cfg.hidden_size
        self.input_decay_w = nn.Parameter(torch.zeros(F_))
        self.input_decay_b = nn.Parameter(torch.zeros(F_))
        self.register_buffer("x_mean", torch.as_tensor(
            cfg.feature_means, dtype=torch.float32), persistent=False)
        self.gru = GRUDCell(F_, H)
        self.fc1 = nn.Linear(H, 64)
        self.bn = nn.BatchNorm1d(64, eps=1e-5)
        self.fc2 = nn.Linear(64, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``missing_num`` and ``seeds`` are unused (one modality, no
        dropout)."""
        dt = self.compute_dtype
        x, m, d = (t.to(dt) for t in _unpack_carryforward(batch))
        B, T, _ = x.shape
        x_d = torch.exp(-torch.relu(d.float() * self.input_decay_w
                                    + self.input_decay_b))
        mf = m.float()
        x = (mf * x.float() + (1 - mf) * x_d * x.float()
             + (1 - mf) * (1 - x_d) * self.x_mean.to(dt).float())
        cell = self.gru.cell
        h_decay = torch.exp(-torch.relu(
            dense(self.gru.hidden_decay, d, dt).float()))      # [B, T, H]
        xi = cell.input_proj(torch.cat([x.to(dt), m], dim=-1), dt)
        wh = cell.hidden_weights(dt)
        h = torch.zeros(B, cell.hidden, dtype=torch.float32, device=x.device)
        hs = []
        for t in range(T):
            h = cell.step(h_decay[:, t] * h, xi[:, t], wh)
            hs.append(h)
        idx = batch["input_length"].long().clamp(0, T - 1)
        last = torch.stack(hs, dim=1)[torch.arange(B, device=x.device), idx]
        h = dense(self.fc1, last, dt)
        h = flax_batch_norm(h, self.bn, self.training,
                            self.BN_MOMENTUM).to(dt)
        return dense(self.fc2, torch.relu(h), dt)[..., 0], None, None


class LSTM_MODEL(nn.Module):
    """``lstm`` (JAX baselines.py:244-260; src/lstm.py with fusion_type
    uni_ehr): the two-layer LSTM over the carryforward data and the
    demographics (``ehr_model``, its features through the fixed 0.3
    dropout), then ``dense_layer``."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = model_dtype(cfg)
        D = cfg.transformer_dim
        self.ehr_model = LSTMEncoder(cfg.vslt_len + 2, D, 2, 0.3,
                                     self.compute_dtype)
        self.dense_layer = nn.Linear(D, 1)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        dt = self.compute_dtype
        x = _unpack_carryforward(batch)[0]
        lengths = batch["input_length"].long().clamp_min(1)
        feats = self.ehr_model.features(_with_demo(x.to(dt), batch), lengths,
                                        seeds)
        return dense(self.dense_layer, feats, dt)[..., 0], None, None


class FUSIONTRAINER(nn.Module):
    """``fusiontrainer`` (JAX baselines.py:168-241; fusiontrainer.py:
    27-92): the EHR LSTM (``ehr_model``), the Swin-T trunk over every image
    (``cxr_model``, torchvision's names) and one note vector
    (``txtnorm`` + ``txt_embedding`` over the mean of the BioBERT rows,
    padding included, or the mean of the token embeddings under
    ``--berttype bert``), fused by ``--fuse-baseline``:

    * Medfuse (and None): the LSTM ``lstm_fusion_layer`` (hidden 768) over
      [txt, ehr, ``projection``(cxr)], then ``lstm_fused_cls``;
    * MMTM: squeeze-excite gates from [txt | cxr | ehr mean]
      (``fc_squeeze`` to width / ``--mmtm-ratio``, then ``fc_txt``,
      ``fc_visual``, ``fc_skeleton``, 2 sigmoid), the gated txt and EHR
      projected to 768 (``projection_txt``, ``projection``), then
      ``joint_cls`` over the three;
    * DAFT (and Retain, Multi): FiLM of the EHR sequence, scale and shift
      from [txt | cxr | ehr mean] through ``aux_base`` (width / 7, at
      least 4) and ``aux_out`` (no biases), then the LSTM ``daft_head``
      and ``dense_layer``."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.multiimages == 1:
            raise ValueError(f"--multiimages 1: --model {cfg.model} takes "
                             "one image per sample")
        self.cfg = cfg
        dt = self.compute_dtype = model_dtype(cfg)
        kind = cfg.fuse_baseline or "Medfuse"
        self.kind = kind if kind in ("Medfuse", "MMTM") else "DAFT"
        self.stop_trunk = "uni_ehr" in cfg.fusion_type
        D = cfg.transformer_dim
        self.ehr_model = LSTMEncoder(cfg.vslt_len + 2, D, 2, 0.3, dt)
        self.cxr_model = SwinTransformer(in_channels=1, dtype=dt)
        if cfg.berttype == "biobert":
            self.txtnorm = LayerNorm(TXT_WIDTH, dt)
            self.txt_embedding = nn.Linear(TXT_WIDTH, D)
        else:
            self.txt_embedding = nn.Embedding(BERT_VOCAB, D)
        if self.kind == "Medfuse":
            self.projection = nn.Linear(CXR_WIDTH, D)
            self.lstm_fusion_layer = LSTMEncoder(D, CXR_WIDTH, 1, 0.0, dt)
            self.lstm_fused_cls = nn.Linear(CXR_WIDTH, 1)
            return
        squeeze = 2 * D + CXR_WIDTH
        if self.kind == "MMTM":
            out = squeeze // int(cfg.mmtm_ratio)
            self.fc_squeeze = nn.Linear(squeeze, out)
            self.fc_txt = nn.Linear(out, D)
            self.fc_visual = nn.Linear(out, CXR_WIDTH)
            self.fc_skeleton = nn.Linear(out, D)
            self.projection_txt = nn.Linear(D, CXR_WIDTH)
            self.projection = nn.Linear(D, CXR_WIDTH)
            self.joint_cls = nn.Linear(3 * CXR_WIDTH, 1)
            return
        bottleneck = max(squeeze // 7, 4)
        self.aux_base = nn.Linear(squeeze, bottleneck, bias=False)
        self.aux_out = nn.Linear(bottleneck, 2 * D, bias=False)
        self.daft_head = LSTMEncoder(D, D, 1, 0.3, dt)
        self.dense_layer = nn.Linear(D, 1)

    def txt_vector(self, txt: torch.Tensor) -> torch.Tensor:
        """One note vector [B, D] (JAX ``_txt_vector``)."""
        dt = self.compute_dtype
        if self.cfg.berttype == "biobert":
            if txt.dim() == 3:
                txt = txt.mean(dim=1)
            return dense(self.txt_embedding, self.txtnorm(txt.to(dt)), dt)
        emb = self.txt_embedding.weight[txt.long()].to(dt)
        return emb.mean(dim=1)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``missing_num`` is unused; ``seeds``: the step's dropout seeds,
        which the LSTM features and the trunk's stochastic depth draw in
        training mode."""
        dt = self.compute_dtype
        x = _unpack_carryforward(batch)[0]
        ehr_in = _with_demo(x.to(dt), batch)
        lengths = batch["input_length"].long().clamp_min(1)
        with torch.no_grad() if self.stop_trunk else contextlib.nullcontext():
            feats_map = self.cxr_model(batch["img"], seeds)  # [B, 7, 7, 768]
        cxr_pooled = feats_map.mean(dim=(1, 2))
        txt_vec = self.txt_vector(batch["txt"])
        if self.kind == "Medfuse":
            ehr_feats = self.ehr_model.features(ehr_in, lengths, seeds)
            tokens = torch.stack([txt_vec, ehr_feats,
                                  dense(self.projection, cxr_pooled, dt)], 1)
            fused = self.lstm_fusion_layer.features(
                tokens, torch.full_like(lengths, 3), seeds)
            return dense(self.lstm_fused_cls, fused, dt)[..., 0], None, None
        ehr_seq = self.ehr_model(ehr_in, lengths)[0]
        ehr_avg = ehr_seq.mean(dim=1)
        if self.kind == "MMTM":
            B = feats_map.shape[0]
            vis_flat = feats_map.reshape(B, -1, CXR_WIDTH).mean(dim=1)
            squeeze = torch.cat([txt_vec, vis_flat, ehr_avg], dim=1)
            exc = torch.relu(dense(self.fc_squeeze, squeeze, dt))
            g_txt, g_vis, g_ehr = (2 * torch.sigmoid(dense(lin, exc, dt))
                                   for lin in (self.fc_txt, self.fc_visual,
                                               self.fc_skeleton))
            ehr_g = (ehr_seq * g_ehr[:, None, :]).mean(dim=1)
            feats = torch.cat([dense(self.projection_txt, txt_vec * g_txt, dt),
                               dense(self.projection, ehr_g, dt),
                               cxr_pooled * g_vis], dim=1)
            return dense(self.joint_cls, feats, dt)[..., 0], None, None
        squeeze = torch.cat([txt_vec, cxr_pooled, ehr_avg], dim=1)
        film = dense(self.aux_out,
                     torch.relu(dense(self.aux_base, squeeze, dt)), dt)
        v_scale, v_shift = film.chunk(2, dim=1)
        ehr_mod = ehr_seq * v_scale[:, None, :] + v_shift[:, None, :]
        feats = self.daft_head.features(ehr_mod, lengths, seeds)
        return dense(self.dense_layer, feats, dt)[..., 0], None, None
