"""What the train and test drivers share: the device and the process
group, the flags they refuse, the seeds, the eval loop, and the output
only process 0 prints."""
from __future__ import annotations

import os
import random
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config
from ..data.pipeline import length_rebatch
from ..parallel.distributed import is_primary, maybe_init_distributed
from ..parallel.mesh import Mesh, make_mesh


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
    if cfg.dp_size > 1:
        raise NotImplementedError(
            f"--dp-size {cfg.dp_size}: data parallelism is ROADMAP Queue 1 "
            "item 8b; the drivers run --mp-size N with --dp-size 1")
    if train and cfg.train_multi_k > 1:
        raise NotImplementedError(
            f"--train-multi-k {cfg.train_multi_k}: several optimizer steps "
            "per dispatch are ROADMAP Queue 1 item 4 (CUDA graphs); 0 or 1 "
            "run one step per batch")


def say(*args, **kwargs) -> None:
    """print on process 0 only: every process computes the same lines."""
    if is_primary():
        print(*args, **kwargs)


def setup_distributed(cfg: Config, device=None
                      ) -> Tuple[torch.device, Optional[Mesh]]:
    """Join the process group when one is configured (``--dist-*`` or the
    launcher's GRAFT_* environment: 2_train.py:80-83) and build the mesh
    (``make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)``). Returns
    this process's device and the mesh, None for a single process. The
    backend follows from the hardware: nccl when this host shows a card
    per rank (rank r on ``cuda:r``), gloo when the ranks share one card
    (all on ``cuda:0``, the collectives staged through the host) or run
    on the CPU (``device="cpu"``). Process 0 prints the backend and the
    mesh."""
    coord = cfg.dist_coordinator or os.environ.get("GRAFT_COORDINATOR", "")
    if not coord:
        if cfg.mp_size > 1:
            raise ValueError(
                f"--mp-size {cfg.mp_size} needs {cfg.mp_size} processes: "
                "start them with parallel.launch or --dist-coordinator, "
                "--dist-num-processes and --dist-process-id")
        return resolve_device(device), None
    on_cpu = resolve_device(device).type == "cpu"
    if not dist.is_initialized():     # else a later run in these processes
        num = cfg.dist_num_processes
        if num < 0:
            num = int(os.environ.get("GRAFT_NUM_PROCESSES", "0") or 0)
        cards = 0 if on_cpu else torch.cuda.device_count()
        maybe_init_distributed(cfg, "nccl" if 0 < num <= cards else "gloo")
    if on_cpu:
        dev = torch.device("cpu")
    elif dist.get_backend() == "nccl":
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cuda", 0)
    mesh = make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)
    say(f"[dist] {dist.get_world_size()} processes over "
        f"{dist.get_backend()}, mesh (dp {mesh.dp}, mp {mesh.mp}), rank 0 "
        f"on {dev}", flush=True)
    return dev, mesh


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
