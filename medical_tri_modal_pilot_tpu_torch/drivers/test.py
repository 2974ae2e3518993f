"""The port's test driver: the checkpoint walk of ``3_test.py``.

    python -m medical_tri_modal_pilot_tpu_torch.drivers.test <3_test.py's flags>

Walks ``{dir_result}/{project}/ckpts`` for ``*.pth`` files (only the best
ones under ``--best`` without ``--last``), of either format: the port's
torch files and the JAX package's pickles. Each is loaded into one
eval-only ``Trainer`` and scored on the test split, whose batches are
assembled once and replayed (unless ``--*-observed-prop`` < 100 redraws
them); then the aggregate over the checkpoints. ``run_checkpoints`` walks
over a test loader and note table its caller gives (``main`` builds them
from the data paths). Under ``--mp-size N --dp-size 1`` it runs in N
processes as the train driver does (process 0 draws the batches and
builds the index cache first); they agree on the number of checkpoints
and on each one's step before they score it (3_test.py:65, 102), and
only process 0 prints and writes.
"""
from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

from ..config import Config, parse_config
from ..data.pipeline import get_test_data_loader, maybe_replay
from ..data.txt_table import build_txt_table
from ..models import get_model
from ..parallel.distributed import (BroadcastLoader, assert_agreement,
                                    primary_first)
from ..train import checkpoints as ckpt
from ..train.logger import Logger, ResultsAggregator
from ..train.trainer import Trainer
from .common import (check_flags, first_batch, resolve_device, run_eval, say,
                     set_seeds, setup_distributed)


def search_ckpts(root: str):
    """Every ``.pth`` under ``root`` (and the JAX package's ``.pth.orbax``
    directories, which the loader then refuses by name), sorted."""
    found = []
    for path, dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(".pth"):
                found.append(os.path.join(path, fn))
        for dn in dirs:
            if dn.endswith(".pth.orbax"):
                found.append(os.path.join(path, dn[:-len(".orbax")]))
    return sorted(set(found))


def checkpoints_of(cfg: Config):
    """The checkpoints the walk scores (3_test.py:49-52)."""
    ckpt_dir = os.path.join(cfg.dir_result, cfg.project_name, "ckpts")
    return [p for p in search_ckpts(ckpt_dir)
            if ("best" in os.path.basename(p) if cfg.best and not cfg.last
                else True)]


def run_checkpoints(cfg: Config, paths, test_loader, txt_table=None,
                    device=None, mesh=None):
    """Score each checkpoint of ``paths`` on ``test_loader`` with one
    eval-only Trainer (sharded over ``mesh`` under ``--mp-size``). Returns
    [(path, test metrics)]."""
    dev = resolve_device(device)
    check_flags(cfg, train=False)
    if mesh is not None:
        test_loader = BroadcastLoader(test_loader)
    test_loader = maybe_replay(test_loader, cfg)
    out = []
    trainer = None
    for k_indx, path in enumerate(paths):
        set_seeds(cfg.seed)
        logger = Logger(cfg, fold=k_indx)
        if len(test_loader) == 0:
            say("empty test loader")
            continue
        if trainer is None:
            model = get_model(cfg)
            first_batch(test_loader)
            trainer = Trainer(cfg, model, dev, eval_only=True,
                              seed=cfg.seed, mesh=mesh, txt_table=txt_table)
        payload = ckpt.load_checkpoint_any(cfg.ckpt_backend, path)
        assert_agreement(f"checkpoint {k_indx} step",
                         int(payload.get("step", 0)))
        ckpt.restore(trainer, payload, with_optimizer=False)
        run_eval(trainer, test_loader, logger.evaluator)
        say(f"ckpt: {path}")
        out.append((path, logger.test_result_only()))
        logger.close()
    return out


def main(argv: Optional[Sequence[str]] = None, device=None):
    """The walk over ``argv`` (sys.argv when None). Returns the aggregate
    over the checkpoints; exits 1 when there is none."""
    cfg = parse_config(argv)
    check_flags(cfg, train=False)
    dev, mesh = setup_distributed(cfg, device)
    paths = checkpoints_of(cfg)
    assert_agreement("checkpoint count", len(paths))
    if not paths:
        say("no checkpoints under "
            f"{os.path.join(cfg.dir_result, cfg.project_name, 'ckpts')}")
        sys.exit(1)
    set_seeds(cfg.seed)
    test_loader = primary_first(lambda: get_test_data_loader(cfg))
    txt_table = build_txt_table(cfg, (test_loader.dataset,))
    agg = ResultsAggregator("test (all ckpts)")
    for _, metrics in run_checkpoints(cfg, paths, test_loader, txt_table,
                                      dev, mesh):
        agg.add(metrics)
    return agg.summarize()


if __name__ == "__main__":
    main(sys.argv[1:])
