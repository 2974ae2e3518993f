"""What the train and test drivers share: the device, the flags they
refuse, the seeds and the eval loop."""
from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.pipeline import length_rebatch


def resolve_device(device=None) -> torch.device:
    """The drivers run on the GPU. The CPU only when the caller passes
    ``device="cpu"`` (the tests)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the port's drivers run on a CUDA device and none is visible; "
            "pass device='cpu' to main() for a CPU run")
    return torch.device("cuda")


def check_flags(cfg: Config, train: bool = True) -> None:
    """Refuse by name the flags of the JAX drivers that the port's do not
    honour (every other flag they read is honoured)."""
    if cfg.ckpt_backend == "orbax":
        raise NotImplementedError(
            "--ckpt-backend orbax: the port reads and writes single-file "
            ".pth checkpoints only")
    if cfg.mp_size > 1 or cfg.dp_size > 1:
        raise NotImplementedError(
            f"--mp-size {cfg.mp_size} --dp-size {cfg.dp_size}: the drivers "
            "run one process; the tensor-parallel drivers are the next "
            "ROADMAP item")
    if cfg.dist_coordinator or os.environ.get("GRAFT_COORDINATOR"):
        raise NotImplementedError(
            "--dist-coordinator: the drivers run one process; the "
            "multi-process drivers are the next ROADMAP item")
    if train and cfg.train_multi_k > 1:
        raise NotImplementedError(
            f"--train-multi-k {cfg.train_multi_k}: several optimizer steps "
            "per dispatch are ROADMAP Queue 1 item 4 (CUDA graphs); 0 or 1 "
            "run one step per batch")


def set_seeds(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def run_eval(trainer, loader, evaluator) -> float:
    """Eval steps over ``loader`` into ``evaluator``; the mean loss. Sample
    order does not matter in eval (targets travel in the batch), so pooled
    batches are sorted by TIE length (--eval-length-rebatch) to reach the
    small --tie-buckets."""
    evaluator.reset()
    total, n = 0.0, 0
    for batch in length_rebatch(loader, trainer.cfg.eval_length_rebatch):
        probs, loss, rmse = trainer.eval_step(batch)
        evaluator.add_batch(batch["target"], probs, rmse=rmse)
        total += loss
        n += 1
    return total / max(n, 1)


def first_batch(loader) -> Optional[dict]:
    """Draw one batch as the JAX drivers do for their model's init, and
    nothing else: the loaders' random streams (the sampler's and the
    datasets') then advance as the JAX drivers' do, so both drivers see
    the same batches after it."""
    return next(iter(loader), None)
