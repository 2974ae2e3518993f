"""The flagship model (counterpart of medical_tri_modal_pilot_tpu/models/
models.py:49-284): UMSE stems + modality encoders + MBT fusion, and the
``tri_mbt_vsltcls`` head on the vslt cls token plus demographics.

The classes extend each other (UMSE <- ImageEncoder <- MBTBackbone <-
TRI_MBT_VSLTCLS) so every parameter sits where the reference's single
model class keeps it and the state_dict keys are the reference's (the
image trunk under ``img_encoder.``, its projection at ``linear``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..constants import IMG_FEATURE_ID, TXT_FEATURE_ID
from .heads import ClsHead
from .mbt import MBTFusion
from .modules import DropoutSeeds, LayerNorm
from .swin import SwinTransformer
from .umse import UMSE

ModelOutput = Tuple[torch.Tensor, Optional[torch.Tensor], None]


def model_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.precision == "bf16" else torch.float32


def pack_capacity(cfg: Config, rows: int) -> int:
    """Static capacity of the presence-packed trunk for ``rows`` image rows
    (models.py:81-82); an unresolved ``--img-pack-frac`` (-1) means 0.5."""
    frac = cfg.img_pack_frac if cfg.img_pack_frac > 0 else 0.5
    return max(1, min(rows - 1, int(-(-rows * frac // 1))))


class ImageEncoder(UMSE):
    """UMSE plus, when ``--input-types`` has img, the Swin-T trunk
    (``img_encoder``) and its 768 -> d projection (``linear``)
    (tri_mbt_vsltcls.py:83-118, :202-214). The trunk is frozen when
    ``--img-pretrain Yes``: its parameters take no gradient, it stays in
    eval mode under ``model.train()`` and runs under ``torch.no_grad()``
    (JAX: stop_gradient, models.py:125-141, and the optimizer mask). Only
    ``linear`` trains on the image side. The weights are seeded or carried
    across, since loading ``--img-pretrain-path`` is not ported yet."""

    def __init__(self, cfg: Config):
        dt = model_dtype(cfg)
        super().__init__(cfg.transformer_dim, cfg.vslt_type, cfg.berttype,
                         dt)
        self.cfg = cfg
        if "img" not in cfg.input_types.split("_"):
            return
        if cfg.img_model_type != "swin":
            raise NotImplementedError(
                f"--img-model-type {cfg.img_model_type}: only the Swin-T "
                "trunk is ported; ViT, ResNet, MaxViT and the patch stem are "
                "ROADMAP Queue 1 item 7")
        if cfg.img_pretrain_path:
            raise NotImplementedError(
                "--img-pretrain-path: loading torchvision weights into the "
                "trunk is ROADMAP Queue 1 item 10")
        self.img_encoder = SwinTransformer(in_channels=1, dtype=dt)
        self.linear = nn.Linear(self.img_encoder.num_features,
                                cfg.transformer_dim)
        frozen = cfg.img_pretrain == "Yes"
        self.img_encoder.requires_grad_(not frozen)
        self.img_pack = frozen and (
            cfg.img_pack == 1
            or (cfg.img_pack == -1 and "missing" in cfg.modality_inclusion))
        # rows the trunk ran on in the last call (cap + 1 when packed)
        self.trunk_rows = 0

    def train(self, mode: bool = True):
        """Training mode for everything but a frozen trunk, which stays in
        eval mode. A trainable trunk (``--img-pretrain No``) is not ported
        and raises."""
        super().train(mode)
        trunk = getattr(self, "img_encoder", None)
        if trunk is not None:
            if mode and self.cfg.img_pretrain != "Yes":
                raise NotImplementedError(
                    "--img-pretrain No: training the Swin trunk (its "
                    "backward and stochastic depth) is ROADMAP Queue 1 "
                    "item 11")
            trunk.eval()
        return self

    def _trunk(self, img, present: torch.Tensor) -> torch.Tensor:
        """The frozen trunk over [rows, 1, H, W] images (models.py:65-107).
        Packed: every row without an image equals swin(0), so the trunk
        runs on the first ``cap`` present rows plus one shared zero row and
        the features are gathered back per row. A batch with more present
        images than ``cap`` runs the full batch instead. In eager PyTorch
        the branch is a host decision on the present count, which costs
        one device sync per step."""
        rows = img.shape[0]
        cap = pack_capacity(self.cfg, rows)
        if not self.img_pack or int(present.sum()) > cap:
            self.trunk_rows = rows
            return self.img_encoder(img)
        order = torch.argsort((~present).to(torch.int8), stable=True)
        inv = torch.argsort(order)
        packed = torch.cat([img[order[:cap]], torch.zeros_like(img[:1])])
        self.trunk_rows = cap + 1
        feats = self.img_encoder(packed)
        src = torch.where(present & (inv < cap), inv, cap)
        return feats[src]

    def encode_images(self, img, present: torch.Tensor) -> torch.Tensor:
        """img [B, 1, H, W], or [B, 3, 1, H, W] with ``--multiimages 1``;
        present: bool per image row. Returns tokens [rows, 49, d] in the
        compute dtype."""
        cfg = self.cfg
        img = img.reshape(-1, 1, cfg.image_size, cfg.image_size)
        with torch.no_grad():
            feats = self._trunk(img, present.reshape(-1))
        feats = feats.reshape(feats.shape[0], -1, feats.shape[-1])
        dt = self.compute_dtype
        return F.linear(feats.to(dt), self.linear.weight.to(dt),
                        self.linear.bias.to(dt))


class MBTBackbone(ImageEncoder):
    """UMSE stems + the image trunk and text projection + MBT fusion over
    the streams of ``--input-types`` (vslt, then img, then txt)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        mods = cfg.input_types.split("_")
        use_pe = [cfg.vslt_type == "carryforward"]
        mask = [True]
        if "img" in mods:
            # a single image per sample runs unmasked; multi-image stacks
            # mask their absent slots
            use_pe.append(False)
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
            resbottle=cfg.residual_bottlenecks == 1,
            use_pe=tuple(use_pe), mask=tuple(mask),
            dtype=model_dtype(cfg))

    def _img_stream(self, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Image tokens [B, 49 (x3), d] and their valid lengths
        (models.py:183-217)."""
        cfg = self.cfg
        B = batch["vslt"].shape[0]
        multi = cfg.multiimages == 1
        if multi:
            # per-slot presence: absent slots carry img_time == 10
            present = batch["img_time"].reshape(-1) != 10.0
        else:
            present = batch["missing"][:, 1] == 0.0
        tokens = self.encode_images(batch["img"], present)
        per_image = tokens.shape[1]
        if cfg.imgtxt_time == 1:
            tokens = self.add_time_feature(
                tokens, batch["img_time"].reshape(-1), IMG_FEATURE_ID)
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
            img_tokens, img_len = self._img_stream(batch)
            enc_inputs.append(img_tokens)
            varying.append(img_len.long())
        if "txt" in mods:
            txt_tokens = self.embed_txt(batch["txt"])
            if txt_tokens.dim() == 2:
                txt_tokens = txt_tokens[:, None, :]
            if cfg.imgtxt_time == 1:
                txt_tokens = self.add_time_feature(
                    txt_tokens, batch["txt_time"], TXT_FEATURE_ID)
            enc_inputs.append(txt_tokens)
            varying.append(batch["txt_length"].long() + 2)
        outputs = self.fusion_transformer(enc_inputs, varying, missing_num,
                                          seeds)
        return outputs, demo


class TRI_MBT_VSLTCLS(MBTBackbone):
    """Flagship: classify from the vslt cls token + demographics
    (tri_mbt_vsltcls.py:248-255)."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        D = cfg.transformer_dim
        dt = model_dtype(cfg)
        self.layer_norms_after_concat = LayerNorm(D, dt)
        d_in = D if cfg.vslt_type == "QIE" else 2 * D
        if "rmse" in cfg.auxiliary_loss_type:
            self.rmse_layer = nn.Linear(d_in, 1)
        self.fc_list = ClsHead(d_in, D, cfg.output_dim, cfg.activation, dt)

    def _class_input(self, cls_vec, demo):
        h = self.layer_norms_after_concat(cls_vec)
        if self.cfg.vslt_type != "QIE":
            h = torch.cat([h, demo.to(h.dtype)], dim=-1)
        return h

    def forward(self, batch: Dict[str, torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> ModelOutput:
        """``seeds``: the step's dropout seeds, needed in training mode."""
        cfg = self.cfg
        outputs, demo = self.backbone(batch, missing_num, seeds)
        x = self._class_input(outputs[0][:, 0, :], demo)
        rmse = None
        if "rmse" in cfg.auxiliary_loss_type:
            lin = self.rmse_layer
            rmse = F.linear(x, lin.weight.to(x.dtype),
                            lin.bias.to(x.dtype))[..., 0]
        logits = self.fc_list(x)
        return (logits[..., 0] if cfg.output_dim == 1 else logits), rmse, None
