"""Checkpoint save/load with the reference's directory contract
(logger.py:166-177; counterpart of medical_tri_modal_pilot_tpu/train/
checkpoints.py): single-file checkpoints named
``{dir_result}/{project}/ckpts/{best,last}_fold{k}_seed{s}.pth`` holding
{'model', 'optimizer', 'best_step', 'last_step', 'score', 'epoch',
'step'}: here a torch ``.pth`` whose model entry is the port's state_dict
(the reference's names) and whose optimizer entry is the Trainer's
optimizer state_dict. The asynchronous saver comes with the port's
``2_train.py`` counterpart.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch


def ckpt_path(dir_result: str, project: str, kind: str, fold, seed) -> str:
    return os.path.join(dir_result, project, "ckpts",
                        f"{kind}_fold{fold}_seed{seed}.pth")


def save_checkpoint(path: str, trainer, score: float, epoch: int,
                    best_step: int = 0, last_step: int = 0) -> None:
    """Write the trainer's model, optimizer and step atomically (a
    temporary file renamed over ``path``)."""
    payload = {
        "model": trainer.model.state_dict(),
        "optimizer": (None if trainer.optimizer is None
                      else trainer.optimizer.state_dict()),
        "best_step": int(best_step),
        "last_step": int(last_step),
        "score": float(score),
        "epoch": int(epoch),
        "step": int(trainer.step),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore(trainer, payload: Dict[str, Any],
            with_optimizer: bool = True) -> None:
    """Bring a checkpoint's model, optimizer and step back into
    ``trainer``, so that its next step goes on from the point of the save
    (the dropout seeds follow the step)."""
    trainer.model.load_state_dict(payload["model"], strict=True)
    if (with_optimizer and trainer.optimizer is not None
            and payload.get("optimizer") is not None):
        trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.step = int(payload.get("step", 0))
