"""Start N ranks of one function on this host and wait for them.

    python -m medical_tri_modal_pilot_tpu_torch.parallel.launch \\
        --nproc 2 --init file:///path/to/rendezvous module:function [args...]

Each rank is a fresh interpreter running ``module:function(*args)`` with
GRAFT_COORDINATOR (the init method), GRAFT_NUM_PROCESSES and
GRAFT_PROCESS_ID set, so that ``distributed.maybe_init_distributed`` joins
it to the group. A rank imports nothing of jax, flax or the JAX package:
the child entry blocks those names before it imports the target. When one
rank fails, the others (which would wait in a collective for it) are
stopped and the launch raises with the failing rank's error output.
"""
from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

# what a rank must not import: the port runs without them
BLOCKED = ("jax", "jaxlib", "flax", "optax", "medical_tri_modal_pilot_tpu")
MODULE = "medical_tri_modal_pilot_tpu_torch.parallel.launch"


def launch(target: str, nproc: int, init: str, args: Sequence[str] = (),
           pythonpath: Sequence[str] = (), timeout: Optional[float] = None,
           capture: bool = False) -> None:
    """Run ``target`` ("module:function") in ``nproc`` ranks joined through
    the init method ``init`` (``file://`` or ``tcp://``); ``pythonpath``
    entries go in front of the ranks' PYTHONPATH. ``capture``: keep the
    ranks' output for the error message instead of passing it through.
    Raises if a rank fails or the ranks outlive ``timeout`` seconds."""
    env = dict(os.environ, GRAFT_COORDINATOR=init,
               GRAFT_NUM_PROCESSES=str(nproc))
    path = [os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))] + list(pythonpath)
    if env.get("PYTHONPATH"):
        path.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(path)
    # captured output goes to files: a pipe nobody reads would block a
    # rank that writes more than its buffer
    logs = [tempfile.TemporaryFile("w+") if capture else None
            for _ in range(nproc)]
    procs = []
    for rank in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", MODULE, "--child", target, *args],
            env=dict(env, GRAFT_PROCESS_ID=str(rank)), stdout=logs[rank],
            stderr=subprocess.STDOUT if capture else None, text=True))
    deadline = None if timeout is None else time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{target}: the ranks outlived {timeout} s")
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = bad[0] if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        text = []
        for log in logs:
            if log is not None:
                log.seek(0)
                text.append(log.read())
                log.close()
    if failed is not None:
        log = text[failed][-8000:] if capture else ""
        raise RuntimeError(f"{target}: rank {failed} exited with "
                           f"{procs[failed].returncode}\n{log}")


def _child(target: str, args: Sequence[str]) -> None:
    for name in BLOCKED:
        sys.modules[name] = None
    module, _, fn = target.partition(":")
    getattr(importlib.import_module(module), fn)(*args)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--nproc", type=int, default=2)
    parser.add_argument("--init", default="")
    parser.add_argument("target")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)
    if ns.child:
        _child(ns.target, ns.args)
        return
    if not ns.init:
        parser.error("--init: give a file:// or tcp:// init method")
    launch(ns.target, ns.nproc, ns.init, ns.args)


if __name__ == "__main__":
    main()
