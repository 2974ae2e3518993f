"""The MBT models (counterpart of medical_tri_modal_pilot_tpu/models/
models.py:49-561): UMSE stems + modality encoders + MBT fusion,
and the heads of ``tri_mbt_vsltcls`` (the vslt cls token plus
demographics), ``bi_*_mbt_v1`` (a missing-aware mix of the two cls
vectors) and ``tri_mbt_v1`` (a missing-aware mix of per-modality logits);
the paper's ablations ``tri_mbt_vsltcls_noshareumse`` (stems per
stream), ``tri_mbt_vflexible*`` (learned missing-aware weights of
per-stream logits) and ``tri_mbt_vnosh*avgtr`` (a head per stream); the
concat-fusion baseline ``*_mt_v1``; the multitoken family
``tri_mbt_vmulti``, ``tri_mbt_vmulti2`` and ``tri_mbt_vmultivslt`` (four
cls heads, one per missing case); and ``unimodal_transformer``, the UMSE
stems under one encoder.

The classes extend each other (UMSE <- ImageEncoder <- MBTBackbone <-
TRI_MBT_VSLTCLS) so every parameter sits where the reference's single
model class keeps it and the state_dict keys are the reference's (the
image trunk under ``img_encoder.``, its projection at ``linear``).
"""
from __future__ import annotations

import contextlib

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..constants import IMG_FEATURE_ID, TXT_FEATURE_ID
from .encoder import MTFusion, TransformerEncoder
from .heads import ClsHead, ClsHeadLN
from .mbt import (MBTFusion, MultitokenMBTFusion,
                  MultitokenMBTVSLTMAINFusion, missing_candidate_weights)
from .modules import DropoutSeeds, LayerNorm
from .swin import PatchStem, SwinTransformer
from .umse import UMSE

ModelOutput = Tuple[torch.Tensor, Optional[torch.Tensor], None]


def model_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bf16" else torch.float32


def pack_capacity(cfg: Config, rows: int) -> int:
    """Static capacity of the presence-packed trunk for ``rows`` image rows
    (models.py:81-82); an unresolved ``--img-pack-frac`` (-1) means 0.5."""
    frac = cfg.img_pack_frac if cfg.img_pack_frac > 0 else 0.5
    return max(1, min(rows - 1, int(-(-rows * frac // 1))))


def head_width(cfg: Config) -> int:
    """Width of the head's input: the normalised cls vector, plus the
    demographics but under QIE, whose tokens carry them (models.py:
    260-264)."""
    return cfg.transformer_dim * (1 if cfg.vslt_type == "QIE" else 2)


def class_input(norm: nn.Module, cls_vec: torch.Tensor, demo: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """``norm(cls_vec)`` [..., D], with ``demo`` [B, D] concatenated on the
    last axis but under QIE; the leading axes end in the batch's."""
    h = norm(cls_vec)
    if cfg.vslt_type != "QIE":
        demo = demo.to(h.dtype).expand(h.shape[:-1] + demo.shape[-1:])
        h = torch.cat([h, demo], dim=-1)
    return h


def stack_cls(model: nn.Module, outputs: List[torch.Tensor],
              demo: torch.Tensor) -> torch.Tensor:
    """Each stream's cls token stacked [M, B, D] through
    ``layer_norms_after_concat``, the demographics concatenated but under
    QIE: the input of the per-stream heads (JAX models.py:415-418)."""
    return class_input(model.layer_norms_after_concat,
                       torch.stack([o[:, 0, :] for o in outputs]), demo,
                       model.cfg)


def _require_three_streams(cfg: Config) -> None:
    if cfg.input_types != "vslt_img_txt":
        raise ValueError(f"--model {cfg.model} fuses vslt_img_txt, not "
                         f"--input-types {cfg.input_types}")


class ImageEncoder(UMSE):
    """UMSE plus, when ``--input-types`` has img, the image stem: the
    Swin-T trunk (``img_encoder``) and its 768 -> d projection (``linear``)
    (tri_mbt_vsltcls.py:83-118, :202-214), or the patch stem
    (``patch_embedding``, ``models/swin.py::PatchStem``) where ``stem`` is
    "patch" (``tri_mbt_v3``) or ``--img-model-type`` is neither swin nor
    vit, as the JAX ImageEncoder falls through to it (models.py:146); vit
    raises (ROADMAP Queue 1 item 7). The trunk is frozen where
    ``img_frozen`` says, or at ``--img-pretrain Yes`` when it is None (JAX
    models.py:125; the v1 family passes True, tri_mbt_v1.py:228, and
    tri_mbt_v2 False): its parameters take no gradient, it stays in eval
    mode under ``model.train()`` and runs under ``torch.no_grad()`` (JAX:
    stop_gradient, models.py:125-141, and the optimizer mask), and only
    ``linear`` trains on the image side. A trunk that is not frozen trains:
    training mode under ``model.train()``, gradients through its ops'
    autograd Functions, stochastic depth from the step's seeds; it runs
    over every row (the packed trunk is a frozen-only path, as in JAX
    models.py:127-141). The weights are seeded or carried across, since
    loading ``--img-pretrain-path`` is not ported yet. ``share_umse=False``
    gives the img and txt streams stems of their own; ``timestamps=False``
    leaves out the img/txt timestamp stems (a model that never enriches
    its tokens, ``*_mt_v1``)."""

    def __init__(self, cfg: Config, img_frozen: Optional[bool] = None,
                 share_umse: bool = True, timestamps: bool = True,
                 stem: Optional[str] = None):
        dt = model_dtype(cfg)
        mods = cfg.input_types.split("_")
        stamps = timestamps and cfg.imgtxt_time == 1 and len(mods) > 1
        super().__init__(cfg.transformer_dim, cfg.vslt_type, cfg.berttype,
                         dt, cfg.vslt_len, txt="txt" in mods and share_umse,
                         timestamps=stamps and share_umse)
        self.cfg = cfg
        self.share_umse = share_umse
        if not share_umse:
            # the img and txt streams' own stems, where the JAX model calls
            # them (models.py:183-212): the timestamp enrichment, the notes
            for m in ("img", "txt"):
                if m in mods and (m == "txt" or stamps):
                    setattr(self, f"umse_{m}", UMSE(
                        cfg.transformer_dim, cfg.vslt_type, cfg.berttype, dt,
                        txt=m == "txt", timestamps=stamps, vslt=False))
        self.frozen, self.img_pack = True, False
        # rows the trunk ran on in the last call (cap + 1 when packed)
        self.trunk_rows = 0
        if "img" not in mods:
            return
        if stem != "patch" and cfg.img_model_type == "vit":
            raise NotImplementedError(
                "--img-model-type vit: the ViT encoder is ROADMAP Queue 1 "
                "item 7 (swin runs the Swin-T trunk, every other type the "
                "patch stem)")
        if stem == "patch" or cfg.img_model_type != "swin":
            self.patch_embedding = PatchStem(cfg.image_size, 16,
                                             cfg.transformer_dim, 1, dt)
            return
        if cfg.img_pretrain_path:
            raise NotImplementedError(
                "--img-pretrain-path: loading torchvision weights into the "
                "trunk is ROADMAP Queue 1 item 10")
        self.img_encoder = SwinTransformer(in_channels=1, dtype=dt)
        self.linear = nn.Linear(self.img_encoder.num_features,
                                cfg.transformer_dim)
        self.frozen = (cfg.img_pretrain == "Yes" if img_frozen is None
                       else img_frozen)
        self.img_encoder.requires_grad_(not self.frozen)
        self.img_pack = self.frozen and (
            cfg.img_pack == 1
            or (cfg.img_pack == -1 and "missing" in cfg.modality_inclusion))

    def stems(self, stream: str) -> UMSE:
        """The stems of the img or txt stream: the shared ones, or under
        ``share_umse=False`` the stream's own (``umse_img``,
        ``umse_txt``)."""
        return self if self.share_umse else getattr(self, f"umse_{stream}")

    def train(self, mode: bool = True):
        """Training mode for everything but a frozen trunk, which stays in
        eval mode."""
        super().train(mode)
        trunk = getattr(self, "img_encoder", None)
        if trunk is not None and self.frozen:
            trunk.eval()
        return self

    def _trunk(self, img, present: torch.Tensor,
               seeds: Optional[DropoutSeeds]) -> torch.Tensor:
        """The trunk over [rows, 1, H, W] images (models.py:65-107).
        Packed (a frozen trunk only): every row without an image equals
        swin(0), so the trunk runs on the first ``cap`` present rows plus
        one shared zero row and the features are gathered back per row. A
        batch with more present images than ``cap`` runs the full batch
        instead. In eager PyTorch the branch is a host decision on the
        present count, which costs one device sync per step."""
        rows = img.shape[0]
        cap = pack_capacity(self.cfg, rows)
        if not self.img_pack or int(present.sum()) > cap:
            self.trunk_rows = rows
            return self.img_encoder(img, seeds)
        order = torch.argsort((~present).to(torch.int8), stable=True)
        inv = torch.argsort(order)
        packed = torch.cat([img[order[:cap]], torch.zeros_like(img[:1])])
        self.trunk_rows = cap + 1
        feats = self.img_encoder(packed)
        src = torch.where(present & (inv < cap), inv, cap)
        return feats[src]

    def encode_images(self, img, present: torch.Tensor,
                      seeds: Optional[DropoutSeeds] = None) -> torch.Tensor:
        """img [B, 1, H, W], or [B, 3, 1, H, W] with ``--multiimages 1``;
        present: bool per image row. Returns tokens [rows, 49, d] (the
        patch stem's [B, N, d]) in the compute dtype. ``seeds``: the step's
        dropout seeds, which a training trunk's stochastic depth draws."""
        cfg = self.cfg
        img = img.reshape(-1, 1, cfg.image_size, cfg.image_size)
        if hasattr(self, "patch_embedding"):
            return self.patch_embedding(img)
        with torch.no_grad() if self.frozen else contextlib.nullcontext():
            feats = self._trunk(img, present.reshape(-1), seeds)
        feats = feats.reshape(feats.shape[0], -1, feats.shape[-1])
        dt = self.compute_dtype
        return F.linear(feats.to(dt), self.linear.weight.to(dt),
                        self.linear.bias.to(dt))


class MBTBackbone(ImageEncoder):
    """UMSE stems + the image trunk and text projection + MBT fusion over
    the streams of ``--input-types`` (vslt, then img, then txt). The v1
    wiring knobs (JAX models.py:155-165): ``img_frozen`` (see
    ``ImageEncoder``), ``allow_multiimages`` (False: one
    image per sample, ``--multiimages 1`` refused), ``allow_resbottle``
    (False: ``--residual-bottlenecks`` ignored) and ``img_use_pe`` (the
    image stream gets the positional encoding, bi_vsltimg_mbt_v1.py:130);
    ``share_umse`` (False: ``tri_mbt_vsltcls_noshareumse``'s stems per
    stream, JAX models.py:173-236; the vslt tokens and the demographics
    still come from the shared ones, so ``ops.umse`` runs once); ``stem``
    ("patch": ``tri_mbt_v3``'s patch stem, see ``ImageEncoder``).
    """

    def __init__(self, cfg: Config, img_frozen: Optional[bool] = None,
                 allow_multiimages: bool = True,
                 allow_resbottle: bool = True, img_use_pe: bool = False,
                 share_umse: bool = True, stem: Optional[str] = None):
        super().__init__(cfg, img_frozen, share_umse, stem=stem)
        mods = cfg.input_types.split("_")
        if cfg.multiimages == 1 and "img" in mods and (
                not allow_multiimages or hasattr(self, "patch_embedding")):
            raise ValueError(f"--multiimages 1: --model {cfg.model} takes "
                             "one image per sample")
        use_pe = [cfg.vslt_type == "carryforward"]
        mask = [True]
        if "img" in mods:
            # a single image per sample runs unmasked; multi-image stacks
            # mask their absent slots
            use_pe.append(img_use_pe)
            mask.append(cfg.multiimages == 1)
        if "txt" in mods:
            use_pe.append(True)
            mask.append(True)
        self.fusion_transformer = MBTFusion(
            n_modality=len(mask),
            bottlenecks_n=cfg.mbt_bottlenecks_n,
            fusion_startidx=cfg.mbt_fusion_startidx,
            n_layers=cfg.transformer_num_layers,
            n_head=cfg.transformer_num_head,
            d_model=cfg.transformer_dim,
            d_ff=cfg.transformer_dim * 4,
            dropout=cfg.dropout,
            txt_idx=mods.index("txt") if "txt" in mods else -1,
            vsltonly=cfg.mbt_only_vslt,
            resbottle=cfg.residual_bottlenecks == 1 and allow_resbottle,
            use_pe=tuple(use_pe), mask=tuple(mask),
            dtype=model_dtype(cfg), remat=cfg.remat == 1)

    def _img_stream(self, batch: Dict[str, torch.Tensor], demo,
                    seeds: Optional[DropoutSeeds] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image tokens [B, 49 (x3) or the patch stem's N, d] and their
        valid lengths (models.py:183-217)."""
        cfg = self.cfg
        B = batch["vslt"].shape[0]
        multi = cfg.multiimages == 1
        if multi:
            # per-slot presence: absent slots carry img_time == 10
            present = batch["img_time"].reshape(-1) != 10.0
        else:
            present = batch["missing"][:, 1] == 0.0
        tokens = self.encode_images(batch["img"], present, seeds)
        per_image = tokens.shape[1]
        if cfg.imgtxt_time == 1:
            tokens = self.stems("img").add_time_feature(
                tokens, batch["img_time"].reshape(-1), IMG_FEATURE_ID, demo)
        if not multi:
            return tokens, torch.full((B,), per_image, dtype=torch.long,
                                      device=tokens.device)
        n_real = torch.count_nonzero(batch["img_time"].reshape(B, 3) - 10,
                                     dim=1)
        return tokens.reshape(B, -1, tokens.shape[-1]), n_real * per_image

    def backbone(self, batch: Dict[str, torch.Tensor],
                 missing_num: torch.Tensor,
                 seeds: Optional[DropoutSeeds] = None
                 ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        cfg = self.cfg
        mods = cfg.input_types.split("_")
        vslt_tokens, demo = self.embed_vslt(
            batch["vslt"], batch["static"][:, 1], batch["static"][:, 0])
        enc_inputs = [vslt_tokens]
        varying = [batch["input_length"].long()]
        if "img" in mods:
            img_tokens, img_len = self._img_stream(batch, demo, seeds)
            enc_inputs.append(img_tokens)
            varying.append(img_len.long())
        if "txt" in mods:
            stems = self.stems("txt")
            txt_tokens = stems.embed_txt(batch["txt"])
            if txt_tokens.dim() == 2:
                txt_tokens = txt_tokens[:, None, :]
            if cfg.imgtxt_time == 1:
                txt_tokens = stems.add_time_feature(
                    txt_tokens, batch["txt_time"], TXT_FEATURE_ID, demo)
            enc_inputs.append(txt_tokens)
            varying.append(batch["txt_length"].long() + 2)
        outputs = self.fusion_transformer(enc_inputs, varying, missing_num,
                                          seeds)
        return outputs, demo


class TRI_MBT_VSLTCLS(MBTBackbone):
    """Flagship: classify from the vslt cls token + demographics
    (tri_mbt_vsltcls.py:248-255). Also the bimodal ``biimg_mbt_vsltcls``
    and ``bitxt_mbt_vsltcls``, as in the JAX registry, and
    ``tri_mbt_vsltcls_noshareumse`` (``share_umse=False``: the img and txt
    streams' own stems, JAX models.py:287)."""

    def __init__(self, cfg: Config, **wiring):
        super().__init__(cfg, **wiring)
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        self.layer_norms_after_concat = LayerNorm(D, dt)
        if "rmse" in cfg.auxiliary_loss_type:
            self.rmse_layer = nn.Linear(head_width(cfg), 1)
        self.fc_list = ClsHead(head_width(cfg), D, cfg.output_dim,
                               cfg.activation, dt)

    def cls_vector(self, outputs: List[torch.Tensor],
                   missing_num: torch.Tensor) -> torch.Tensor:
        """The head's input: the vslt stream's cls token [B, D]."""
        return outputs[0][:, 0, :]

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``seeds``: the step's dropout seeds, needed in training mode."""
        cfg = self.cfg
        outputs, demo = self.backbone(batch, missing_num, seeds)
        x = class_input(self.layer_norms_after_concat,
                        self.cls_vector(outputs, missing_num), demo, cfg)
        rmse = None
        if "rmse" in cfg.auxiliary_loss_type:
            lin = self.rmse_layer
            rmse = F.linear(x, lin.weight.to(x.dtype),
                            lin.bias.to(x.dtype))[..., 0]
        logits = self.fc_list(x)
        return (logits[..., 0] if cfg.output_dim == 1 else logits), rmse, None


class BI_MBT_V1(TRI_MBT_VSLTCLS):
    """``bi_vslttxt_mbt_v1`` / ``bi_vsltimg_mbt_v1`` (JAX models.py:350-387;
    bi_vslttxt_mbt_v1.py:167-183): the missing-selected mean of the two
    cls VECTORS (both streams' mean, or the vslt one alone when the other
    modality is missing) -> LayerNorm -> (+demo) -> the BatchNorm head. The
    reference's ``all_cls_stack[missing, idx_order]`` select is a one-hot
    of ``missing_num`` times a constant (2, 2) mix. Wiring: one image per
    sample, no residual bottlenecks, the image stream with a positional
    encoding; the trunk always frozen."""

    def __init__(self, cfg: Config):
        if cfg.n_modality != 2:
            raise ValueError(f"--model {cfg.model} fuses two streams, not "
                             f"--input-types {cfg.input_types}")
        super().__init__(cfg, img_frozen=True, allow_multiimages=False,
                         allow_resbottle=False, img_use_pe=True)
        self.register_buffer("cls_mix", torch.tensor([[0.5, 0.5],
                                                      [1.0, 0.0]]),
                             persistent=False)

    def cls_vector(self, outputs, missing_num):
        cls0, cls1 = outputs[0][:, 0, :], outputs[1][:, 0, :]
        onehot = F.one_hot(missing_num.long(), 2).float()
        mix = (onehot @ self.cls_mix).to(cls0.dtype)             # [B, 2]
        return mix[:, :1] * cls0 + mix[:, 1:] * cls1


class TRI_MBT_V1(MBTBackbone):
    """``tri_mbt_v1`` (JAX models.py:291-347, variant 1; tri_mbt_v1.py:
    269-280): each stream's cls token, stacked [3, B, D], through one
    LayerNorm (+demo) and the LayerNorm head ``ClsHeadLN`` with one output,
    and the per-modality logits mixed by a one-hot of ``missing_num``
    times the constant (4, 3) missing-aware weights. No rmse output (the
    reference returns None). The trunk is always frozen. Variant 2
    (``tri_mbt_v2``, tri_mbt_v2.py): the trunk trains, the BatchNorm head
    ``ClsHead`` with ``--output-dim`` outputs, one image per sample, no
    residual bottlenecks, and with ``--auxiliary-loss-type rmse`` the
    per-stream ``rmse_layer`` [3, B] mixed the same way (tri_mbt_v2.py:
    240-247). Variant 3 (``tri_mbt_v3``, tri_mbt_v3.py:86-96, 187):
    variant 2 with the patch stem in place of the trunk."""

    def __init__(self, cfg: Config, variant: int = 1):
        _require_three_streams(cfg)
        v1 = variant == 1
        super().__init__(cfg, img_frozen=v1, allow_multiimages=v1,
                         allow_resbottle=v1,
                         stem="patch" if variant == 3 else None)
        self.variant = variant
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        self.layer_norms_after_concat = LayerNorm(D, dt)
        # the reference forces one output in v1 (tri_mbt_v1.py:26)
        self.out_dim = 1 if v1 else cfg.output_dim
        head = ClsHeadLN if v1 else ClsHead
        self.fc_list = head(head_width(cfg), D, self.out_dim, cfg.activation,
                            dt)
        if not v1 and "rmse" in cfg.auxiliary_loss_type:
            self.rmse_layer = nn.Linear(head_width(cfg), 1)
        self.register_buffer(
            "logit_mix", torch.from_numpy(missing_candidate_weights(3)),
            persistent=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        outputs, demo = self.backbone(batch, missing_num, seeds)
        stack = stack_cls(self, outputs, demo)                  # [M, B, W]
        logits = self.fc_list(stack)                            # [M, B, O]
        onehot = F.one_hot(missing_num.long(), 4).float()
        mix = (onehot @ self.logit_mix).to(logits.dtype)        # [B, M]
        out = torch.einsum("bm,mbo->bo", mix, logits)
        rmse = None
        if hasattr(self, "rmse_layer"):
            lin = self.rmse_layer
            r = F.linear(stack, lin.weight.to(stack.dtype),
                         lin.bias.to(stack.dtype))[..., 0]      # [M, B]
            rmse = torch.einsum("bm,mb->b", mix.to(r.dtype), r)
        return (out[..., 0] if self.out_dim == 1 else out), rmse, None


class TRI_MBT_VFLEXIBLE(MBTBackbone):
    """``tri_mbt_vflexible`` (JAX models.py:390-437; tri_mbt_vflexible.py:
    148, 269-289): per-stream logits from one LayerNorm head over the
    stacked cls tokens [3, B], weighted by a learned (3, 1) parameter
    ``flexibleavg`` (zeros at init) masked by the sample's available
    streams and softmaxed over them, then the missing case's candidate sum
    (tri, v+i, v+t, v). The weights are filled with -1e9 where a stream is
    missing, then scaled by ``flex_temp`` (10 in ``tri_mbt_vflexible2``,
    3.334 in ``vflexible3``), and softmaxed in fp32, in that order. No
    rmse output.

    The bimodal ``biimg_mbt_vflexible1`` / ``bitxt_mbt_vflexible1`` map to
    this class in the JAX registry, whose module stacks two streams but
    broadcasts the demographics and the weights to three and raises
    (models.py:411, :425); the port refuses them here (ROADMAP Queue 3)."""

    # rows: missing case (tri, v+i, v+t, v); True = stream left out
    AVAILABLE = ((False, False, False), (False, False, True),
                 (False, True, False), (False, True, True))

    def __init__(self, cfg: Config, flex_temp: float = 1.0):
        if cfg.input_types != "vslt_img_txt":
            raise ValueError(
                f"--model {cfg.model} on --input-types {cfg.input_types}: "
                "the JAX model weights three streams and raises on two "
                "(its models.py:411, :425); ROADMAP Queue 3")
        super().__init__(cfg)
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        self.flex_temp = flex_temp
        self.layer_norms_after_concat = LayerNorm(D, dt)
        self.fc_list = ClsHeadLN(head_width(cfg), D, cfg.output_dim,
                                 cfg.activation, dt)
        self.flexibleavg = nn.Parameter(torch.zeros(3, 1))
        self.register_buffer("left_out", torch.tensor(self.AVAILABLE),
                             persistent=False)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        outputs, demo = self.backbone(batch, missing_num, seeds)
        logits = self.fc_list(stack_cls(self, outputs, demo))[..., 0]
        B = logits.shape[1]
        w = self.flexibleavg.float().expand(3, B)
        w = torch.where(self.left_out[missing_num.long()].T, -1e9, w)
        w = torch.softmax(w * self.flex_temp, dim=0).to(logits.dtype)
        weighted = logits * w                                    # [3, B]
        cands = torch.stack([weighted.sum(0), weighted[0] + weighted[1],
                             weighted[0] + weighted[2], weighted[0]])
        onehot = F.one_hot(missing_num.long(), 4).to(cands.dtype)
        return torch.einsum("bk,kb->b", onehot, cands), None, None


class TRI_MBT_VNOSH(MBTBackbone):
    """``tri_mbt_vnoshnoavgtr`` and ``tri_mbt_vnoshavgtr`` (JAX models.py:
    440-477; tri_mbt_vnoshnoavgtr.py:259-281): the stacked cls tokens
    through one LayerNorm (+demo), then a BatchNorm head per stream
    (``fc_list_0``, ``fc_list_1``, ``fc_list_2``), logits [3, B] and, with
    ``--auxiliary-loss-type rmse``, ``rmse_layer`` over the stack [3, B].
    ``avg_in_model`` (vnoshavgtr) returns the missing case's mean of the
    available streams' logits [B]; otherwise the Trainer weights each
    head's loss and selects the output (train/trainer.py)."""

    def __init__(self, cfg: Config, avg_in_model: bool = False):
        _require_three_streams(cfg)
        super().__init__(cfg)
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        self.avg_in_model = avg_in_model
        self.layer_norms_after_concat = LayerNorm(D, dt)
        if "rmse" in cfg.auxiliary_loss_type:
            self.rmse_layer = nn.Linear(head_width(cfg), 1)
        for m in range(3):
            setattr(self, f"fc_list_{m}", ClsHead(
                head_width(cfg), D, cfg.output_dim, cfg.activation, dt))

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        outputs, demo = self.backbone(batch, missing_num, seeds)
        stack = stack_cls(self, outputs, demo)
        rmse = None
        if "rmse" in self.cfg.auxiliary_loss_type:
            lin = self.rmse_layer
            rmse = F.linear(stack, lin.weight.to(stack.dtype),
                            lin.bias.to(stack.dtype))[..., 0]
        out = torch.stack([getattr(self, f"fc_list_{m}")(stack[m])[..., 0]
                           for m in range(3)])                   # [3, B]
        if self.avg_in_model:
            out = select_case_mean(out, missing_num)
        return out, rmse, None


def select_case_mean(out: torch.Tensor, missing_num: torch.Tensor
                     ) -> torch.Tensor:
    """Per sample, the mean of the available streams' outputs [3, B] ->
    [B]: all three, v+i, v+t or v by the missing case (JAX models.py:
    468-475, trainer.py:218-225)."""
    cands = torch.stack([out.mean(0), (out[0] + out[1]) / 2,
                         (out[0] + out[2]) / 2, out[0]])
    onehot = F.one_hot(missing_num.long(), 4).to(cands.dtype)
    return torch.einsum("bk,kb->b", onehot, cands)


class MT_FUSION_MODEL(ImageEncoder):
    """The concat-fusion baseline ``tri_mt_v1`` / ``biimg_mt_v1`` /
    ``bitxt_mt_v1`` / ``mt_v1`` (JAX models.py:480-527): the UMSE stems
    (no timestamp enrichment), the frozen trunk over every image row (no
    presence packing: the JAX model calls its image encoder without
    one), the notes at ``txt_length + 1`` valid rows, ``models/encoder.py::
    MTFusion`` over the streams, and the BatchNorm head on the joint cls
    token (``layer_norms_after_concat``, +demo). No rmse output. One image
    per sample."""

    def __init__(self, cfg: Config):
        mods = cfg.input_types.split("_")
        if cfg.multiimages == 1 and "img" in mods:
            raise ValueError(f"--multiimages 1: --model {cfg.model} takes "
                             "one image per sample")
        super().__init__(cfg, timestamps=False)
        self.img_pack = False
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        mask = [True] + [False] * ("img" in mods) + [True] * ("txt" in mods)
        self.fusion_transformer = MTFusion(
            n_modality=len(mods), fusion_startidx=cfg.mbt_fusion_startidx,
            n_layers=cfg.transformer_num_layers,
            n_head=cfg.transformer_num_head, d_model=D, d_ff=4 * D,
            dropout=cfg.dropout,
            txt_idx=mods.index("txt") if "txt" in mods else -1,
            mask=tuple(mask), dtype=dt, remat=cfg.remat == 1)
        self.layer_norms_after_concat = LayerNorm(D, dt)
        self.fc_list = ClsHead(head_width(cfg), D, cfg.output_dim,
                               cfg.activation, dt)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``missing_num`` is unused: the joint stream's key mask carries
        the missing notes."""
        cfg = self.cfg
        mods = cfg.input_types.split("_")
        vslt_tokens, demo = self.embed_vslt(
            batch["vslt"], batch["static"][:, 1], batch["static"][:, 0])
        enc_inputs = [vslt_tokens]
        varying = [batch["input_length"].long()]
        if "img" in mods:
            tokens = self.encode_images(batch["img"],
                                        batch["missing"][:, 1] == 0.0, seeds)
            enc_inputs.append(tokens)
            varying.append(torch.full((tokens.shape[0],), tokens.shape[1],
                                      dtype=torch.long,
                                      device=tokens.device))
        if "txt" in mods:
            txt_tokens = self.embed_txt(batch["txt"])
            if txt_tokens.dim() == 2:
                txt_tokens = txt_tokens[:, None, :]
            enc_inputs.append(txt_tokens)
            varying.append(batch["txt_length"].long() + 1)
        joint = self.fusion_transformer(enc_inputs, varying, seeds)
        logits = self.fc_list(class_input(self.layer_norms_after_concat,
                                          joint[:, 0, :], demo, cfg))
        return (logits[..., 0] if cfg.output_dim == 1 else logits), None, None


class MultitokenBase(ImageEncoder):
    """The multitoken family's embedding path (JAX models.py:564-621;
    tri_mbt_vmulti.py:128+): the UMSE stems, the trunk over every image row
    (no presence packing: the JAX package runs this family's frozen trunk
    over all rows), the timestamp enrichment of the img and txt tokens, and
    a multitoken fusion with every stream masked (the image stream at its
    full length, the notes at ``txt_length + 2``); then the head over the
    four per-case vectors [4, B, D]: ``layer_norms_after_concat``, the
    demographics (concatenated under every ``--vslt-type``, as the JAX
    package does) and four LayerNorm heads ``fc_lists.{i}``. Returns
    logits [4, B]. The trunk is frozen at ``--img-pretrain Yes`` (JAX
    registry.py:105)."""

    # logits [4, B], one head per missing case: the Trainer's loss and
    # eval selection read this (train/trainer.py::compute_loss)
    MULTI_HEAD = True

    def __init__(self, cfg: Config, vslt_main: bool = False):
        _require_three_streams(cfg)
        if cfg.multiimages == 1:
            raise ValueError(f"--multiimages 1: --model {cfg.model} takes "
                             "one image per sample")
        super().__init__(cfg)
        self.img_pack = False  # the trunk runs over every row
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        fusion = (MultitokenMBTVSLTMAINFusion if vslt_main
                  else MultitokenMBTFusion)
        self.fusion_transformer = fusion(
            n_modality=3, bottlenecks_n=cfg.mbt_bottlenecks_n,
            fusion_startidx=cfg.mbt_fusion_startidx,
            n_layers=cfg.transformer_num_layers,
            n_head=cfg.transformer_num_head, d_model=D, d_ff=4 * D,
            dropout=cfg.dropout,
            use_pe=(cfg.vslt_type == "carryforward", False, True),
            mask=(True, True, True), dtype=dt, remat=cfg.remat == 1)
        self.layer_norms_after_concat = LayerNorm(D, dt)
        self.fc_lists = nn.ModuleList(
            ClsHeadLN(2 * D, D, cfg.output_dim, cfg.activation, dt)
            for _ in range(4))

    def case_vectors(self, outputs: List[torch.Tensor]) -> torch.Tensor:
        """The four per-case vectors [4, B, D] from the streams' outputs."""
        raise NotImplementedError

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        cfg = self.cfg
        vslt_tokens, demo = self.embed_vslt(
            batch["vslt"], batch["static"][:, 1], batch["static"][:, 0])
        img_tokens = self.encode_images(batch["img"],
                                        batch["missing"][:, 1] == 0.0, seeds)
        txt_tokens = self.embed_txt(batch["txt"])
        if txt_tokens.dim() == 2:
            txt_tokens = txt_tokens[:, None, :]
        if cfg.imgtxt_time == 1:
            img_tokens = self.add_time_feature(
                img_tokens, batch["img_time"].reshape(-1), IMG_FEATURE_ID,
                demo)
            txt_tokens = self.add_time_feature(
                txt_tokens, batch["txt_time"], TXT_FEATURE_ID, demo)
        B = img_tokens.shape[0]
        varying = [batch["input_length"].long(),
                   torch.full((B,), img_tokens.shape[1], dtype=torch.long,
                              device=img_tokens.device),
                   batch["txt_length"].long() + 2]
        outputs = self.fusion_transformer(
            [vslt_tokens, img_tokens, txt_tokens], varying, missing_num,
            seeds)
        h = self.layer_norms_after_concat(self.case_vectors(outputs))
        h = torch.cat([h, demo.to(h.dtype).expand(4, -1, -1)], dim=-1)
        logits = torch.stack([head(h[i])[..., 0]
                              for i, head in enumerate(self.fc_lists)])
        return logits, None, None


class TRI_MBT_VMULTI(MultitokenBase):
    """``tri_mbt_vmulti`` (JAX models.py:624-641; tri_mbt_vmulti.py:
    154-180): tri = the mean of each stream's cls 0; v+i = the mean of the
    vslt cls 1 and the img cls 1; v+t = the mean of the vslt cls 2 and the
    txt cls 1; v = the vslt cls 3. ``tri_mbt_vmulti2`` (vslt_main) wires
    the same head over the VSLTMAIN fusion, whose img and txt streams carry
    no cls tokens, so their slots 0 and 1 are content tokens (the
    reference's quirk, kept)."""

    def case_vectors(self, outputs):
        v, i, t = outputs
        return torch.stack([(v[:, 0] + i[:, 0] + t[:, 0]) / 3,
                            (v[:, 1] + i[:, 1]) / 2,
                            (v[:, 2] + t[:, 1]) / 2, v[:, 3]])


class TRI_MBT_VMULTIVSLT(MultitokenBase):
    """``tri_mbt_vmultivslt`` (JAX models.py:651-667;
    tri_mbt_vmultivslt.py:181-187): the VSLTMAIN fusion, classified from
    the vslt stream's four cls tokens."""

    def __init__(self, cfg: Config):
        super().__init__(cfg, vslt_main=True)

    def case_vectors(self, outputs):
        return outputs[0][:, :4].transpose(0, 1)


class UNIMODAL_TRANSFORMER(UMSE):
    """``unimodal_transformer`` (JAX models.py:530-561; reference
    unimodal_transformer.py:67-124): the vslt stems, one
    ``TransformerEncoder`` with a cls token (the positional encoding for a
    carryforward grid only), ``layer_norm_final`` on the cls token, the
    demographics (but under QIE, whose tokens carry them) and the
    BatchNorm head."""

    def __init__(self, cfg: Config):
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        super().__init__(D, cfg.vslt_type, cfg.berttype, dt, cfg.vslt_len,
                         txt=False)
        self.cfg = cfg
        self.transformer_encoder = TransformerEncoder(
            n_layers=cfg.transformer_num_layers,
            n_head=cfg.transformer_num_head, d_model=D, d_ff=4 * D,
            dropout=cfg.dropout, pe_maxlen=2000,
            use_pe=cfg.vslt_type == "carryforward", dtype=dt,
            remat=cfg.remat == 1)
        self.layer_norm_final = LayerNorm(D, dt)
        self.fc_list = ClsHead(head_width(cfg), D, cfg.output_dim,
                               cfg.activation, dt)

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``missing_num`` is unused (one modality)."""
        cfg = self.cfg
        tokens, demo = self.embed_vslt(
            batch["vslt"], batch["static"][:, 1], batch["static"][:, 0])
        h = self.transformer_encoder(tokens, batch["input_length"].long() + 1,
                                     seeds)
        logits = self.fc_list(class_input(self.layer_norm_final, h[:, 0, :],
                                          demo, cfg))
        return (logits[..., 0] if cfg.output_dim == 1 else logits), None, None
