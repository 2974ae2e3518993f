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
the host). Process 0 draws the batches and the others receive them
(``BroadcastLoader``), so every process holds the same batch; process 0
writes files.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Tuple, TypeVar

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
T = TypeVar("T")


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


def assert_agreement(tag: str, value) -> None:
    """Raise when a small scalar decision differs between the processes
    (JAX parallel/distributed.py:105-123): each process finds and reads
    checkpoints in its own file system, and ranks that restored different
    states would go on silently apart inside the collectives. An
    all-gather of one float64; a no-op in one process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    t = torch.tensor([float(value)], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    vals = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(vals, t)
    vals = [float(v.item()) for v in vals]
    if any(v != vals[0] for v in vals):
        raise RuntimeError(
            f"the processes disagree on {tag}: per-process values {vals}; "
            "the checkpoint and results directory must be shared (or "
            "populated alike) by every process")


def barrier() -> None:
    """Every process waits for the others (a no-op single-process): orders
    process 0's checkpoint write before any process reads it."""
    if dist.is_initialized():
        dist.barrier()


def primary_first(make: Callable[[], T]) -> T:
    """``make()`` on process 0, then, after it, on the others: what process
    0 writes on the way (the eval index caches of ``./data/testIndexes``)
    the others then read. ``make()`` alone in one process."""
    if is_primary():
        out = make()
    barrier()
    if not is_primary():
        out = make()
    return out


def _broadcast(obj):
    """Process 0's ``obj`` on every process (pickled; over nccl through
    this process's current card)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


class BroadcastLoader:
    """A loader of which only process 0 draws batches; each is broadcast to
    the other processes of the group, which yield it in step. Under tensor
    parallelism every process must compute on the same batch, and a
    loader's draws need not repeat from one process to the next: the
    dataset's items come from one ``random.Random`` that its worker threads
    share, in whatever order they run. The length, and every other
    attribute (``dataset``, ``sampler``, ``batch_size``), are the wrapped
    loader's; the processes agree on the length. Every process must begin
    and give up each pass at the same batch, as the drivers do."""

    def __init__(self, loader):
        self.loader = loader
        assert_agreement("batches a pass", len(loader))

    def __len__(self) -> int:
        return len(self.loader)

    def __getattr__(self, name):
        if name == "loader":        # not set yet (unpickling)
            raise AttributeError(name)
        return getattr(self.loader, name)

    def __iter__(self):
        if is_primary():
            for batch in self.loader:
                _broadcast(batch)
                yield batch
            _broadcast(None)        # the pass ended
            return
        while True:
            batch = _broadcast(None)
            if batch is None:
                return
            yield batch
