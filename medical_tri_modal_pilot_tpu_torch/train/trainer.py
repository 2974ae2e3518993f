"""Train and eval steps of the port (counterpart of
medical_tri_modal_pilot_tpu/train/trainer.py): missing-modality codes, the
detection loss, eval output selection, the LR schedules and optimizers,
and a ``Trainer`` whose ``train_step`` returns the loss and whose
``eval_step`` returns ``(probs, loss, rmse)`` like the JAX one.

Dense ``txt`` and fp32 ``img`` batches only: the ``txt_id``/uint8/packed
image wire format and TIE length bucketing are ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import Config
from ..models.modules import DropoutSeeds
from .schedule import cosine_annealing_warmup_restarts, cosine_warmup_single

# the batch keys the train and eval steps read
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


def build_schedule(cfg: Config, iters_per_epoch: int) -> Callable:
    """The LR schedule of a run (JAX trainer.py:112-122)."""
    max_lr = cfg.lr_init * math.sqrt(cfg.batch_size)
    if cfg.lr_scheduler == "CosineAnnealing":
        return cosine_annealing_warmup_restarts(
            first_cycle_steps=max(cfg.t_0 * iters_per_epoch, 2),
            max_lr=max_lr, min_lr=1e-6,
            warmup_steps=cfg.t_up * iters_per_epoch,
            gamma=cfg.gamma, cycle_mult=float(cfg.t_mult))
    return cosine_warmup_single(
        total_steps=max(cfg.epochs * iters_per_epoch, 2), max_lr=max_lr,
        min_lr=1e-6, warmup_steps=cfg.t_up * iters_per_epoch)


class Optimizer:
    """adamw, adam or sgd with momentum, each optionally with LARS trust-
    ratio scaling chained before it (``--optim {adamw,adam,sgd}[_lars]``,
    JAX trainer.py:140-154 over optax). The update k (from 0) runs at the
    learning rate the caller passes, ``schedule(k)``, as optax's count
    does. torch.optim computes the same updates as optax: AdamW's decay
    p (1 - lr wd) equals optax's -lr (adam + wd p); SGD's first momentum
    buffer is the gradient, as optax's trace of zeros plus it."""

    def __init__(self, cfg: Config, params: List[torch.nn.Parameter]):
        kind = cfg.optim.replace("_lars", "")
        self.lars = cfg.optim.endswith("_lars")
        self.params = list(params)
        if kind == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=0.0,
                                         weight_decay=cfg.weight_decay,
                                         eps=1e-8)
        elif kind == "adam":
            self.opt = torch.optim.Adam(self.params, lr=0.0, eps=1e-8)
        elif kind == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=0.0,
                                       momentum=cfg.momentum)
        else:
            raise ValueError(f"--optim {cfg.optim}: not an optimizer")

    @torch.no_grad()
    def _trust_ratio(self) -> None:
        """optax.scale_by_trust_ratio(): g *= |p| / |g| per tensor, 1 where
        either norm is 0."""
        for p in self.params:
            if p.grad is None:
                continue
            pn, gn = p.norm(), p.grad.norm()
            ratio = torch.where((pn == 0) | (gn == 0), 1.0, pn / gn)
            p.grad.mul_(ratio)

    def step(self, lr: float) -> None:
        # a parameter the loss does not reach (the last layer's non-vslt
        # streams) has a zero gradient in optax, which still decays it and
        # moves its moments; torch.optim would skip a None gradient
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.lars:
            self._trust_ratio()
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self):
        return self.opt.state_dict()

    def load_state_dict(self, state) -> None:
        self.opt.load_state_dict(state)


def build_optimizer(cfg: Config, model: torch.nn.Module) -> Optimizer:
    """``--optim`` over the parameters that take a gradient (JAX
    trainer.py:140-154 with its _trainable_mask: a frozen trunk, whose
    parameters the model builds with requires_grad False, takes no update,
    decay or moment state)."""
    return Optimizer(cfg, [p for p in model.parameters() if p.requires_grad])


class Trainer:
    """Holds the model on its device and runs the train and eval steps.

    ``eval_only=False`` builds the optimizer over the trainable parameters
    and the LR schedule. ``train_step`` runs update ``self.step`` (from 0)
    at ``schedule(self.step)``; its dropout draws the seeds of
    ``DropoutSeeds(seed, self.step)``, so a run resumed at a step draws the
    masks it would have drawn."""

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 device: torch.device, eval_only: bool = True,
                 iters_per_epoch: int = 1, seed: int = 0):
        if cfg.model_types != "detection":
            raise NotImplementedError(
                f"--model-types {cfg.model_types}: only detection is ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.seed = int(seed)
        self.step = 0
        self.schedule = build_schedule(cfg, max(iters_per_epoch, 1))
        self.optimizer = None if eval_only else build_optimizer(cfg,
                                                                 self.model)

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

    def train_step(self, batch: Dict[str, np.ndarray]) -> float:
        """One optimizer step on ``batch``: the loss (JAX trainer.py:
        450-480), its gradients, the update at ``schedule(step)``, and the
        BatchNorm running statistics. Returns the loss."""
        if self.optimizer is None:
            raise RuntimeError("construct the Trainer with eval_only=False "
                               "to train")
        cfg = self.cfg
        self.model.train()
        b = self.device_batch(batch)
        missing_num = compute_missing_num(cfg, b["missing"])
        logits, rmse, _ = self.model(b, missing_num,
                                     DropoutSeeds(self.seed, self.step))
        loss = compute_loss(cfg, logits.float(),
                            None if rmse is None else rmse.float(),
                            b["target"].float(), b["target_aux"].float())
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step(self.current_lr())
        self.step += 1
        self.model.eval()
        return float(loss.detach())

    def current_lr(self) -> float:
        """The learning rate of the next update."""
        return self.schedule(self.step)

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
