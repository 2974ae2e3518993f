"""Eval step of the port (counterpart of the eval subset of
medical_tri_modal_pilot_tpu/train/trainer.py): missing-modality codes, the
detection loss, eval output selection, and a ``Trainer`` whose
``eval_step`` returns ``(probs, loss, rmse)`` like the JAX one.

Dense ``txt`` and fp32 ``img`` batches only: the ``txt_id``/uint8/packed
image wire format and TIE length bucketing are ROADMAP Queue 1 item 4;
training is item 2.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config

# the batch keys the eval step reads
BATCH_KEYS = ("vslt", "static", "input_length", "img", "img_time", "txt",
              "txt_length", "txt_time", "missing", "target", "target_aux")


def compute_missing_num(cfg: Config, missing: torch.Tensor) -> torch.Tensor:
    """missing: [B, 3] floats (vslt, img, txt; 1 = missing) -> canonical
    candidate index (reference trainer.py:53-105)."""
    img = missing[:, 1].long()
    txt = missing[:, 2].long()
    if cfg.input_types == "vslt_img_txt":
        return 2 * img + txt
    if cfg.input_types == "vslt_img":
        return img
    if cfg.input_types == "vslt_txt":
        return txt
    return torch.zeros_like(img)


def bce(logits, targets):
    """Elementwise sigmoid binary cross-entropy (optax's formula)."""
    return F.binary_cross_entropy_with_logits(logits, targets,
                                              reduction="none")


def compute_loss(cfg: Config, logits, rmse, targets, targets_aux):
    """The detection loss of single-output models: mean BCE, plus the
    aux-rmse term on positive samples when configured."""
    if cfg.model_types != "detection":
        raise NotImplementedError(
            f"--model-types {cfg.model_types}: only detection is ported")
    loss = bce(logits, targets).mean()
    if rmse is not None and "rmse" in cfg.auxiliary_loss_type:
        err = (rmse - targets_aux) ** 2
        pos = targets == 1
        rmse_loss = torch.sqrt(torch.where(pos, err, 0.0).sum()
                               / pos.sum().clamp_min(1))
        loss = loss + torch.nan_to_num(rmse_loss)
    return loss


def select_eval_output(cfg: Config, logits, missing_num):
    """Eval-time output selection (trainer.py:218-230): single-output
    models return their logits as they are."""
    if "multi" in cfg.model or "mbt_vnoshnoavgtr" in cfg.model:
        raise NotImplementedError(
            f"--model {cfg.model}: multi-output selection is ROADMAP "
            "Queue 1 item 6")
    return logits


class Trainer:
    """Holds the model on its device and runs the eval step."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 device: torch.device, eval_only: bool = True):
        if not eval_only:
            raise NotImplementedError(
                "training is ROADMAP Queue 1 item 2; construct the Trainer "
                "with eval_only=True")
        if cfg.model_types != "detection":
            raise NotImplementedError(
                f"--model-types {cfg.model_types}: only detection is ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def device_batch(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        wire = ("txt_id" in batch or "img_pack" in batch
                or np.asarray(batch.get("img", np.zeros(0))).dtype == np.uint8)
        if wire:
            raise NotImplementedError(
                "the txt_id / uint8-image / packed-image wire format is "
                "ROADMAP Queue 1 item 4")
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in BATCH_KEYS if k in batch}

    def eval_step(self, batch: Dict[str, np.ndarray]
                  ) -> Tuple[np.ndarray, float, Optional[float]]:
        """Returns ``(probs, loss, rmse)``; rmse is None unless the run has
        an aux-rmse head (``--auxiliary-loss-type rmse``)."""
        cfg = self.cfg
        with torch.inference_mode():
            b = self.device_batch(batch)
            missing_num = compute_missing_num(cfg, b["missing"])
            logits, rmse, _ = self.model(b, missing_num)
            logits = logits.float()
            out = select_eval_output(cfg, logits, missing_num)
            # detection eval loss: BCE on the selected output, no aux term
            loss = bce(out, b["target"].float()).mean()
            probs = torch.sigmoid(out)
            eval_rmse = None
            if rmse is not None and "rmse" in cfg.auxiliary_loss_type:
                err = (rmse.float() - b["target_aux"]) ** 2
                pos = b["target"] == 1
                eval_rmse = torch.nan_to_num(torch.sqrt(
                    torch.where(pos, err, 0.0).sum()
                    / pos.sum().clamp_min(1)))
            return (probs.cpu().numpy(), float(loss),
                    None if eval_rmse is None else float(eval_rmse))
