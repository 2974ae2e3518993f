"""Rank bodies of the data-parallel CPU tests (tests/test_torch_dp.py),
started by ``medical_tri_modal_pilot_tpu_torch.parallel.launch`` over gloo.
Imports no jax: the launcher blocks it in every rank. A body reads the
runs it makes from ``runs.pt`` in the directory it is given; rank 0
writes the results there, every rank its own state."""
import contextlib
import functools
import os
import sys

import torch

from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import get_model, models, swin
from medical_tri_modal_pilot_tpu_torch.parallel import mesh as M
from medical_tri_modal_pilot_tpu_torch.parallel.distributed import (
    maybe_init_distributed)
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer


def run_config(run: dict):
    """The Config of a run: its argv, then its ``replace`` fields (the
    auxiliary loss types the command line does not take)."""
    return parse_config(run["argv"]).replace(**run.get("replace", {}))


@contextlib.contextmanager
def narrow_trunk(kwargs):
    """The MBT models' Swin-T built with ``kwargs`` (a reduced trunk) for
    the duration; nothing when None."""
    if kwargs is None:
        yield
        return
    orig = models.SwinTransformer
    models.SwinTransformer = functools.partial(swin.SwinTransformer,
                                               **kwargs)
    try:
        yield
    finally:
        models.SwinTransformer = orig


def execute(run: dict, mesh=None, keep_trainer: bool = False) -> dict:
    """A run from its initial state: the eval step on its eval batch, a
    train step per batch, the eval step again; the losses, the eval
    outputs (``probs0`` before the steps) and the whole (gathered) state
    after them, the trainable parameters' names in the optimizer's order
    (and the Trainer itself under ``trainer`` with
    ``keep_trainer``). ``mesh`` None: one process."""
    cfg = run_config(run)
    with narrow_trunk(run.get("trunk")):
        model = get_model(cfg)
    model.load_state_dict(run["init"])
    tr = Trainer(cfg, model, "cpu", eval_only=False, seed=7, mesh=mesh)
    probs0 = tr.eval_step(run["eval"])[0]
    losses = [tr.train_step(b) for b in run["batches"]]
    probs, eval_loss, eval_rmse = tr.eval_step(run["eval"])
    model_sd, opt_sd = tr.state_dicts()
    res = {"losses": losses, "probs0": probs0, "probs": probs,
           "eval_loss": eval_loss,
           "eval_rmse": eval_rmse, "model": model_sd, "optimizer": opt_sd,
           "lr_sum": sum(tr.schedule(k) for k in range(len(losses))),
           "names": tr._param_names()}
    if keep_trainer:
        res["trainer"] = tr
    return res


def runs(out: str) -> None:
    """Every run of ``runs.pt`` on the mesh its flags give (--dp-size,
    --mp-size); rank 0 writes the results to ``dp.pt``, every rank its
    state after each run to ``state{rank}.pt``."""
    assert sys.modules.get("jax") is None
    torch.set_num_threads(1)
    rank, _ = maybe_init_distributed(None, "gloo")
    spec = torch.load(os.path.join(out, "runs.pt"), weights_only=False)
    results, states = {}, {}
    for run in spec:
        cfg = run_config(run)
        mesh = M.make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)
        res = execute(run, mesh)
        results[run["name"]] = res
        states[run["name"]] = {"model": res["model"],
                               "optimizer": res["optimizer"]}
    torch.save(states, os.path.join(out, f"state{rank}.pt"))
    if rank == 0:
        torch.save(results, os.path.join(out, "dp.pt"))
