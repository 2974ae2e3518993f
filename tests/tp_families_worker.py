"""Rank bodies of the tensor-parallel family tests
(tests/test_torch_tp_families.py), started by
``medical_tri_modal_pilot_tpu_torch.parallel.launch`` over gloo. Imports no
jax: the launcher blocks it in every rank. ``runs`` reads the runs it makes
from ``runs.pt`` in the directory it is given (dp_worker's format); rank 0
writes the results there, every rank its own whole state after each run."""
import os
import sys

import torch

from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.parallel import mesh as M
from medical_tri_modal_pilot_tpu_torch.parallel.distributed import (
    maybe_init_distributed)
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
from dp_worker import execute, narrow_trunk, run_config


def _drift_is_caught(tr) -> bool:
    """Rank 1 of each model group moves one replicated parameter by a
    rounding step: Trainer.check_replicas must then raise on every rank
    (its checksum differs across the model group); restored after."""
    mesh = tr.mesh
    name = next(n for n, p in tr.model.named_parameters()
                if n not in tr.split and p.is_floating_point())
    p = dict(tr.model.named_parameters())[name]
    keep = p.detach().clone()
    if mesh.model_index == 1:
        with torch.no_grad():
            p.view(-1)[0] = torch.nextafter(p.view(-1)[0],
                                            p.view(-1)[0] + 1)
    try:
        tr.check_replicas("a planted drift")
        caught = False
    except RuntimeError as e:
        caught = "replicated model state" in str(e)
    with torch.no_grad():
        p.copy_(keep)
    tr.check_replicas("the drift undone")
    return caught


def _reloads(run, mesh, model_sd, opt_sd) -> bool:
    """The whole state ``model_sd`` / ``opt_sd`` loaded into a new Trainer
    on the mesh (load_state_dicts cuts this rank's shards of the
    parameters and of their moments) and gathered again is the same."""
    cfg = run_config(run)
    with narrow_trunk(run.get("trunk")):
        model = get_model(cfg)
    tr = Trainer(cfg, model, "cpu", eval_only=False, mesh=mesh)
    tr.load_state_dicts(model_sd, opt_sd)
    got_sd, got_opt = tr.state_dicts()
    same = got_sd.keys() == model_sd.keys() and all(
        torch.equal(got_sd[k], v) for k, v in model_sd.items())
    for i, st in opt_sd["state"].items():
        same = same and all(torch.equal(torch.as_tensor(got_opt["state"][i][k]),
                                        torch.as_tensor(v))
                            for k, v in st.items())
    return same


def runs(out: str) -> None:
    """Every run of ``runs.pt`` on the mesh its flags give (--dp-size,
    --mp-size): dp_worker.execute, then Trainer.check_replicas, and a
    replicated parameter moved on one model rank must fail it; the whole
    state after the run reloaded (_reloads). Rank 0
    writes the results to ``tp.pt``, every rank its state after each run
    to ``state{rank}.pt``."""
    assert sys.modules.get("jax") is None
    torch.set_num_threads(1)
    rank, _ = maybe_init_distributed(None, "gloo")
    spec = torch.load(os.path.join(out, "runs.pt"), weights_only=False)
    results, states = {}, {}
    for run in spec:
        cfg = run_config(run)
        mesh = M.make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)
        res = execute(run, mesh, keep_trainer=True)
        tr = res.pop("trainer")
        tr.check_replicas("the end of the run")
        res["drift_caught"] = _drift_is_caught(tr)
        res["split"] = sorted(tr.split)
        res["reloaded"] = _reloads(run, mesh, res["model"], res["optimizer"])
        results[run["name"]] = res
        states[run["name"]] = {"model": res["model"],
                               "optimizer": res["optimizer"]}
    torch.save(states, os.path.join(out, f"state{rank}.pt"))
    if rank == 0:
        torch.save(results, os.path.join(out, "tp.pt"))
