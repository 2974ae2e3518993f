"""Process-group start-up from the command line or the environment
(counterpart of medical_tri_modal_pilot_tpu/parallel/distributed.py).

Configuration, in order of precedence:
  * ``--dist-coordinator`` with ``--dist-num-processes`` and
    ``--dist-process-id``: ``host:port`` (a TCP rendezvous), a ``tcp://``
    or ``file://`` init method as it is, or ``auto`` (``env://``: the
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK that torchrun sets);
  * the environment ``GRAFT_COORDINATOR``, ``GRAFT_NUM_PROCESSES`` and
    ``GRAFT_PROCESS_ID``, for launchers that do not touch the command line
    (``parallel/launch.py`` sets them).

The backend is the caller's explicit choice. ``nccl`` needs one visible
card per rank on this host and raises otherwise; ``gloo`` serves the CPU
and ranks that share one card (its collectives stage CUDA tensors through
the host). Every process runs the same seeded pipeline and holds the same
batch; process 0 writes files.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _pick(cfg, attr: str, env: str) -> Optional[int]:
    v = getattr(cfg, attr, None) if cfg is not None else None
    if v is None or int(v) < 0:
        ev = os.environ.get(env, "")
        v = int(ev) if ev else -1
    return int(v) if int(v) >= 0 else None


def init_method(coordinator: str) -> str:
    """The torch init method of a ``--dist-coordinator`` value."""
    if coordinator == "auto":
        return "env://"
    if "://" in coordinator:
        return coordinator
    return f"tcp://{coordinator}"


def maybe_init_distributed(cfg=None, backend: str = "gloo"
                           ) -> Tuple[int, int]:
    """Join the process group when configured (module docstring); a no-op
    otherwise. Returns (rank, world size)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: not one of {BACKENDS}")
    coord = (getattr(cfg, "dist_coordinator", "") or "") if cfg else ""
    coord = coord or os.environ.get("GRAFT_COORDINATOR", "")
    if not coord:
        return 0, 1
    num = _pick(cfg, "dist_num_processes", "GRAFT_NUM_PROCESSES")
    pid = _pick(cfg, "dist_process_id", "GRAFT_PROCESS_ID")
    if coord != "auto" and (num is None or pid is None):
        raise ValueError(f"--dist-coordinator {coord}: give the process "
                         "count and this process's rank (--dist-num-"
                         "processes, --dist-process-id, or GRAFT_NUM_"
                         "PROCESSES, GRAFT_PROCESS_ID)")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if num is None or cards < num:
            raise RuntimeError(
                f"nccl needs one visible card per rank: {num} ranks, {cards} "
                "cards; ranks that share a card take gloo (NCCL across "
                "several cards is ROADMAP Queue 1 item 8)")
    dist.init_process_group(backend, init_method=init_method(coord),
                            world_size=-1 if num is None else num,
                            rank=-1 if pid is None else pid)
    return dist.get_rank(), dist.get_world_size()


def is_primary() -> bool:
    """True on the process that writes files. Always True single-process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Every process waits for the others (a no-op single-process): orders
    process 0's checkpoint write before any process reads it."""
    if dist.is_initialized():
        dist.barrier()
