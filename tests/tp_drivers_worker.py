"""Rank bodies of the tensor-parallel driver tests (tests/test_torch_tp_drivers.py
and tests/test_torch_drivers.py), started by
``medical_tri_modal_pilot_tpu_torch.parallel.launch`` over gloo on the CPU.
Imports no jax: the launcher blocks it in every rank. Each body reads the
argv it runs from ``argv.json`` in the directory it is given; process 0
writes the results there. On every other process a guard makes any write
under the run's results directory raise, so a rank that writes fails the
launch."""
import builtins
import hashlib
import json
import os
import sys

import numpy as np
import torch

# the results a body writes, by process 0
RESULTS = "results.json"


def _rank() -> int:
    return int(os.environ["GRAFT_PROCESS_ID"])


def _argv(out: str):
    with open(os.path.join(out, "argv.json")) as f:
        return json.load(f)


def _under(path, root: str) -> bool:
    try:
        p = os.path.abspath(os.fspath(path))
    except TypeError:
        return False
    return p == root or p.startswith(root + os.sep)


def guard_writes(root: str) -> None:
    """Make every file write, directory creation and rename under ``root``
    raise in this process."""
    root = os.path.abspath(root)
    opened, makedirs, replace = builtins.open, os.makedirs, os.replace
    save = torch.save

    def refuse(what, path):
        raise PermissionError(f"process {_rank()} {what} {path} under the "
                              f"results directory {root}")

    def guarded_open(file, mode="r", *args, **kwargs):
        if any(c in mode for c in "wax+") and _under(file, root):
            refuse("opened for writing", file)
        return opened(file, mode, *args, **kwargs)

    def guarded_makedirs(name, *args, **kwargs):
        if _under(name, root) and not os.path.isdir(name):
            refuse("made the directory", name)
        return makedirs(name, *args, **kwargs)

    def guarded_replace(src, dst, *args, **kwargs):
        if _under(dst, root):
            refuse("renamed onto", dst)
        return replace(src, dst, *args, **kwargs)

    def guarded_save(obj, f, *args, **kwargs):
        if isinstance(f, (str, os.PathLike)) and _under(f, root):
            refuse("saved", f)
        return save(obj, f, *args, **kwargs)

    builtins.open = guarded_open
    os.makedirs = guarded_makedirs
    os.replace = guarded_replace
    torch.save = guarded_save


def record_probs():
    """Make every Evaluator.add_batch of this process also append its
    probabilities to the returned list (the metrics' inputs)."""
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    seen = []
    add = Evaluator.add_batch

    def recorded(self, y_true, y_prob, *args, **kwargs):
        seen.extend(float(p) for p in torch.as_tensor(y_prob).reshape(-1))
        return add(self, y_true, y_prob, *args, **kwargs)

    Evaluator.add_batch = recorded
    return seen


def record_steps():
    """Make every Trainer.train_step of this process also append (a digest
    of its batch, its loss) to the returned list."""
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    seen = []
    step = Trainer.train_step

    def recorded(self, batch, *args, **kwargs):
        loss = step(self, batch, *args, **kwargs)
        h = hashlib.sha256()
        for k in sorted(batch):
            v = np.ascontiguousarray(batch[k])
            h.update(f"{k}{v.dtype}{v.shape}".encode())
            h.update(v.tobytes())
        seen.append((h.hexdigest(), float(loss)))
        return loss

    Trainer.train_step = recorded
    return seen


def _start(argv):
    assert sys.modules.get("jax") is None
    torch.set_num_threads(1)
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    if _rank() != 0:
        guard_writes(parse_config(argv).dir_result)


def _dump(out: str, results) -> None:
    if _rank() == 0:
        with open(os.path.join(out, RESULTS), "w") as f:
            json.dump(results, f)


def fold_resume_walk(cfg, loaders, device, mesh=None) -> dict:
    """The drivers' bodies over fixed batches: ``train.run_fold`` (a step
    save and the epoch save), ``run_fold`` again under ``--resume last``
    (the saved epoch runs again from its checkpoint), then
    ``test.run_checkpoints`` over the fold's checkpoints and the test
    batches. ``loaders()`` gives fresh (train, val, test) loaders. Every
    aggregate."""
    from medical_tri_modal_pilot_tpu_torch.drivers import test, train
    val, tst = train.run_fold(cfg, 0, *loaders(), device=device, mesh=mesh)
    rval, rtst = train.run_fold(cfg.replace(resume="last"), 0, *loaders(),
                                device=device, mesh=mesh)
    walk = test.run_checkpoints(cfg, test.checkpoints_of(cfg),
                                loaders()[2], device=device, mesh=mesh)
    return {"val": val, "test": tst, "resumed_val": rval,
            "resumed_test": rtst, "walk": [m for _, m in walk]}


def fold(out: str) -> None:
    """fold_resume_walk in the ranks over the batches of batches.pt (each
    process reads the same), on process 0 with every probability the
    Evaluators were given."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import BatchList
    from medical_tri_modal_pilot_tpu_torch.drivers import common
    argv = _argv(out)
    _start(argv)
    probs = record_probs()
    cfg = parse_config(argv)
    dev, mesh = common.setup_distributed(cfg, "cpu")
    batches = torch.load(os.path.join(out, "batches.pt"), weights_only=False)
    res = fold_resume_walk(cfg, lambda: [BatchList(b) for b in batches], dev,
                           mesh)
    _dump(out, dict(res, probs=probs))


def run_driver(out: str, driver: str, dist_flags: str) -> None:
    """One driver over argv.json; with ``dist_flags`` "1" the group is
    joined through --dist-coordinator, --dist-num-processes and
    --dist-process-id (the launcher's environment names the same
    rendezvous) instead of the environment alone."""
    from medical_tri_modal_pilot_tpu_torch.drivers import test, train
    argv = _argv(out)
    if dist_flags == "1":
        argv += ["--dist-coordinator", os.environ["GRAFT_COORDINATOR"],
                 "--dist-num-processes", os.environ["GRAFT_NUM_PROCESSES"],
                 "--dist-process-id", str(_rank())]
    _start(argv)
    probs = record_probs()
    main = (train if driver == "train" else test).main
    _dump(out, {"result": main(argv, device="cpu"), "probs": probs})


def disagree(out: str) -> None:
    """assert_agreement: equal values pass; then the test driver with each
    process walking its own results directory, process 0's holding the
    checkpoint and process 1's none: each process's error names the
    checkpoint count and both values."""
    from medical_tri_modal_pilot_tpu_torch.drivers import test
    from medical_tri_modal_pilot_tpu_torch.parallel.distributed import (
        assert_agreement, maybe_init_distributed)
    assert sys.modules.get("jax") is None
    torch.set_num_threads(1)
    maybe_init_distributed(None, "gloo")
    assert_agreement("equal values", 3)
    argv = _argv(out)
    argv += ["--dir-result", os.path.join(out, f"results{_rank()}")]
    try:
        test.main(argv, device="cpu")
        message = None
    except RuntimeError as e:
        message = str(e)
    with open(os.path.join(out, f"error{_rank()}.txt"), "w") as f:
        f.write(message or "")


def main_steps(out: str) -> None:
    """The train driver's ``main`` over argv.json, every process writing
    its steps (batch digest, loss) and every probability its Evaluators
    were given to steps{rank}.json in ``out``; on the processes other than
    0 a guard also refuses writes under ./data, where process 0 builds the
    eval index caches."""
    from medical_tri_modal_pilot_tpu_torch.drivers import train
    argv = _argv(out)
    _start(argv)
    if _rank() != 0:
        guard_writes("data")
    probs, steps = record_probs(), record_steps()
    train.main(argv, device="cpu")
    with open(os.path.join(out, f"steps{_rank()}.json"), "w") as f:
        json.dump({"steps": steps, "probs": probs}, f)
