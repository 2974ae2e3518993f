"""Checkpoint save/load with the reference's directory contract
(logger.py:166-177; counterpart of medical_tri_modal_pilot_tpu/train/
checkpoints.py): single-file checkpoints named
``{dir_result}/{project}/ckpts/{best,last}_fold{k}_seed{s}.pth`` holding
{'model', 'optimizer', 'best_step', 'last_step', 'score', 'epoch',
'step'}: here a torch ``.pth`` whose model entry is the port's state_dict
(the reference's names) and whose optimizer entry is the Trainer's
optimizer state_dict.

The JAX package writes the same names as a pickle of numpy flax trees.
``load_checkpoint`` reads both: a torch file is a zip archive, a JAX file
a pickle, read without jax or optax (``read_jax_checkpoint``), and
``restore`` converts its trees through the weight bridge
(``models/convert.py``). So the port's test driver scores a JAX run and a
JAX run resumes in the port.

``AsyncCheckpointer`` writes off the training thread. torch updates
parameters in place, so a thread that read the live state while the next
step runs would save a torn state: the snapshot is taken on the caller's
thread as device copies in the current stream (one flat buffer per
dtype), copied to pinned host memory without blocking, and the writer
thread waits on an event before it unpacks and writes.

Under tensor parallelism every rank takes part in the save (the state is
gathered from the model group) and rank 0 writes the same whole-model file
a single process writes, Adam moments included; a restore cuts it to each
rank's shard. So a run resumes across the two. Under data parallelism the
data ranks hold the same state, which each save and restore checks
(``Trainer.check_replicas``) before process 0 writes or after every rank
has read.
"""
from __future__ import annotations

import collections
import importlib
import os
import pickle
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.distributed import barrier, is_primary


def ckpt_path(dir_result: str, project: str, kind: str, fold, seed) -> str:
    return os.path.join(dir_result, project, "ckpts",
                        f"{kind}_fold{fold}_seed{seed}.pth")


def ckpt_exists(path: str) -> bool:
    """True if the checkpoint file exists (or the JAX package's orbax
    directory, which ``load_checkpoint_any`` then refuses by name)."""
    return os.path.exists(path) or os.path.isdir(path + ".orbax")


def _payload(model_sd, opt_sd, step: int, score: float, epoch: int,
             best_step: int, last_step: int) -> Dict[str, Any]:
    return {
        "model": model_sd,
        "optimizer": opt_sd,
        "best_step": int(best_step),
        "last_step": int(last_step),
        "score": float(score),
        "epoch": int(epoch),
        "step": int(step),
    }


def _write(path: str, payload: Dict[str, Any]) -> None:
    """torch.save to a temporary file renamed over ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, trainer, score: float, epoch: int,
                    best_step: int = 0, last_step: int = 0) -> None:
    """Write the trainer's model, optimizer and step atomically: on process
    0 only, after every process has given its shards; every process
    returns once the file is in place."""
    trainer.check_replicas(f"the save of {os.path.basename(path)}")
    model_sd, opt_sd = trainer.state_dicts()
    if not is_primary():
        barrier()
        return
    _write(path, _payload(model_sd, opt_sd, trainer.step, score, epoch,
                          best_step, last_step))
    barrier()


# ------------------------------------------------------------ JAX format

# The classes a JAX checkpoint's pickle names, besides numpy's: the optax
# states of every --optim form (adamw, adam, sgd, each with _lars, each
# under optax.masked or not; the table was read by pickling one state of
# each) with their fields in order, and flax's FrozenDict. A namedtuple
# pickles as its class and its positional values, so a stand-in with the
# same fields restores it. Older optax releases name the empty states of
# the trust ratio and the weight decay.
OPTAX_STATES = {
    "EmptyState": (),
    "ScaleByAdamState": ("count", "mu", "nu"),
    "ScaleByScheduleState": ("count",),
    "TraceState": ("trace",),
    "MaskedNode": (),
    "MaskedState": ("inner_state",),
    "ScaleByTrustRatioState": (),
    "AddDecayedWeightsState": (),
}
_STANDINS = {name: collections.namedtuple(name, fields)
             for name, fields in OPTAX_STATES.items()}
# numpy's array and scalar reconstructors, under numpy 2 (numpy._core) and
# numpy 1 (numpy.core) module names
_NUMPY = {("numpy", "dtype"), ("numpy", "ndarray"),
          ("numpy.core.numeric", "_frombuffer"),
          ("numpy.core.multiarray", "_reconstruct"),
          ("numpy.core.multiarray", "scalar")}


class JaxCheckpointUnpickler(pickle.Unpickler):
    """Reads a JAX checkpoint's pickle with no jax, flax or optax: optax
    states become stand-in namedtuples with the same fields (OPTAX_STATES),
    FrozenDict a dict, numpy's reconstructors numpy's (``numpy._core``
    mapped to ``numpy.core`` where the installed numpy lacks it). Any
    other class is refused by name."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "optax" and name in _STANDINS:
            return _STANDINS[name]
        if module.startswith("flax.") and name == "FrozenDict":
            return dict
        norm = module.replace("numpy._core", "numpy.core", 1)
        if (norm, name) in _NUMPY:
            try:
                mod = importlib.import_module(module)
            except ImportError:
                mod = importlib.import_module(norm)
            return getattr(mod, name)
        raise pickle.UnpicklingError(
            f"JAX checkpoint names {module}.{name}, which the port's reader "
            "does not know (train/checkpoints.py OPTAX_STATES)")


def read_jax_checkpoint(path: str) -> Dict[str, Any]:
    """The JAX package's checkpoint payload as it was pickled: numpy trees
    under "model" ({"params", "batch_stats"}) and "optimizer" (stand-in
    optax states), and the scalars."""
    with open(path, "rb") as f:
        return JaxCheckpointUnpickler(f).load()


def is_torch_file(path: str) -> bool:
    """A torch .pth is a zip archive; a JAX one a pickle (\\x80)."""
    with open(path, "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint of either format, tensors on the CPU. A
    JAX file's payload keeps its numpy trees and says ``"format": "jax"``;
    ``restore`` converts it for the trainer it goes into."""
    if is_torch_file(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    payload = read_jax_checkpoint(path)
    if not isinstance(payload, dict) or "model" not in payload:
        raise ValueError(f"{path}: neither a torch nor a JAX checkpoint")
    out = {k: int(payload.get(k, 0) or 0)
           for k in ("best_step", "last_step", "epoch", "step")}
    out.update(score=float(payload.get("score", 0.0)), format="jax",
               model=payload["model"], optimizer=payload.get("optimizer"))
    return out


def load_checkpoint_any(backend: str, path: str) -> Dict[str, Any]:
    """``load_checkpoint`` under ``--ckpt-backend``: the JAX package's orbax
    directories are not read by the port."""
    if backend == "orbax" or (os.path.isdir(path + ".orbax")
                              and not os.path.isfile(path)):
        raise NotImplementedError(
            f"--ckpt-backend orbax ({path}.orbax): the port reads and writes "
            "single-file checkpoints only (torch .pth, and the JAX "
            "package's pickled .pth)")
    return load_checkpoint(path)


def _adam_count(state) -> Optional[int]:
    """The update count of an optax adam state in a stand-in tree."""
    if getattr(state, "_fields", None) == OPTAX_STATES["ScaleByAdamState"]:
        return int(state.count)
    if isinstance(state, (tuple, list)):
        for s in state:
            n = _adam_count(s)
            if n is not None:
                return n
    return None


def convert_jax_payload(trainer, payload: Dict[str, Any]
                        ) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """A JAX payload's trees as the trainer's (model state_dict, optimizer
    state_dict): parameters and BatchNorm statistics through
    ``from_jax_variables``, Adam moments or the SGD trace through
    ``optimizer_state_from_jax`` in the optimizer's parameter order, and
    Adam's step from optax's count. The optimizer entry is None for an
    eval-only trainer or a payload without one."""
    from ..models.convert import from_jax_variables, optimizer_state_from_jax
    cfg = trainer.cfg
    variables = payload["model"]
    model_sd = from_jax_variables(cfg, variables)
    opt = payload.get("optimizer")
    if trainer.optimizer is None or opt is None:
        return model_sd, None
    moments = optimizer_state_from_jax(cfg, opt, variables["params"])
    count = _adam_count(opt)
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    template = trainer.optimizer.state_dict()
    state = {}
    for i, p in enumerate(trainer.optimizer.params):
        st = {k: tree[names[id(p)]].clone() for k, tree in moments.items()}
        if count is not None:
            st["step"] = torch.tensor(float(count))
        state[i] = st
    return model_sd, dict(template, state=state)


def restore(trainer, payload: Dict[str, Any],
            with_optimizer: bool = True) -> None:
    """Bring a checkpoint's model, optimizer and step back into
    ``trainer`` (a JAX payload converted first), so that its next step goes
    on from the point of the save (the dropout seeds follow the step)."""
    if payload.get("format") == "jax":
        model_sd, opt_sd = convert_jax_payload(trainer, payload)
    else:
        model_sd, opt_sd = payload["model"], payload.get("optimizer")
    trainer.load_state_dicts(model_sd, opt_sd if with_optimizer else None)
    trainer.step = int(payload.get("step", 0))
    trainer.check_replicas(f"the restore of step {trainer.step}")


# ---------------------------------------------------------- async saver

def _flatten(tree, prefix=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _flatten(v, prefix + (i,))]
    return [(prefix, tree)]


def _unflatten(tree, leaves: Dict[tuple, Any], prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten(v, leaves, prefix + (i,))
                for i, v in enumerate(tree)]
    return leaves.get(prefix, tree)


class _Snapshot:
    """The trainer's state at the moment of the call, in flat buffers: the
    device tensors of each dtype concatenated on the device (in the current
    stream, so ahead of any later in-place update), then copied to pinned
    host memory without blocking; CPU tensors cloned. ``result()`` waits
    for the copies and rebuilds the (model, optimizer) state_dicts as views
    of the host buffers, so the file holds one storage per dtype: a clone
    per tensor (about a thousand) slowed the train steps the writer
    overlapped (PERF.md §6, PR 12)."""

    def __init__(self, trainer):
        model_sd = trainer.model.state_dict()
        opt_sd = (None if trainer.optimizer is None
                  else trainer.optimizer.state_dict())
        self.tree = {"model": model_sd, "optimizer": opt_sd}
        leaves = [(p, t) for p, t in _flatten(self.tree)
                  if torch.is_tensor(t)]
        self.cpu = {p: t.detach().clone() for p, t in leaves
                    if t.device.type == "cpu"}
        groups: Dict[torch.dtype, list] = {}
        for p, t in leaves:
            if t.device.type != "cpu":
                groups.setdefault(t.dtype, []).append((p, t))
        self.groups = []
        self.event = None
        for dtype, items in groups.items():
            flat = torch.cat([t.detach().reshape(-1) for _, t in items])
            host = torch.empty(flat.shape, dtype=dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            self.groups.append((host, flat,
                                [(p, t.shape) for p, t in items]))
        if self.groups:
            self.event = torch.cuda.Event()
            self.event.record()

    def result(self):
        if self.event is not None:
            self.event.synchronize()
        # the copies are done: free the device buffers before the unpacking
        groups = [(host, items) for host, _flat, items in self.groups]
        self.groups = []
        leaves = dict(self.cpu)
        for host, items in groups:
            off = 0
            for p, shape in items:
                n = shape.numel()
                leaves[p] = host[off:off + n].view(shape)
                off += n
        tree = _unflatten(self.tree, leaves)
        return tree["model"], tree["optimizer"]


class AsyncCheckpointer:
    """Saves off the training thread (JAX checkpoints.py:191-256; the
    step-granular ``--checkpoint-every`` saves and the Logger's epoch
    saves). The caller pays for the device snapshot (``_Snapshot``); the
    copy's wait, the unpacking and the disk write run in a thread. At most
    one save is in flight: a new one joins the last first. Under tensor
    parallelism the state is gathered from the model group on the calling
    thread (a collective every rank joins) and only the write is
    deferred."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, trainer, score: float, epoch: int,
             best_step: int = 0, last_step: int = 0) -> None:
        self.save_multi([(path, best_step, last_step)], trainer, score,
                        epoch)

    def save_multi(self, jobs, trainer, score: float, epoch: int) -> None:
        """``jobs``: [(path, best_step, last_step), ...] written from one
        snapshot (the epoch save writes 'last' and, on a validation
        improvement, 'best' from the same state)."""
        self.wait()
        step = int(trainer.step)
        trainer.check_replicas(f"the save of step {step}")
        if trainer.split:
            state = trainer.state_dicts()
            get = lambda: state
        else:
            snap = _Snapshot(trainer)
            get = snap.result
        if not is_primary():
            return

        def work():
            try:
                model_sd, opt_sd = get()
                for path, best_step, last_step in jobs:
                    _write(path, _payload(model_sd, opt_sd, step, score,
                                          epoch, best_step, last_step))
            except BaseException as e:      # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise its error if it failed."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        err, self._error = self._error, None
        if err is not None:
            raise err
