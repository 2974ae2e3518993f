"""Experiment logging + best-checkpoint tracking (reference
builder/utils/logger.py:31-217 and utils.py:75-86; the port's counterpart
of ``medical_tri_modal_pilot_tpu/train/logger.py``, on the port's
checkpoints and metrics).

Scalars go to a JSONL event file (and TensorBoard when tensorboardX is
importable — it isn't baked into this image); the full config snapshot is
written to settings.txt with the reference's "key # value" format; best
model selection anchors on val AUROC + AUPRC (logger.py:115-118)."""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional

from ..config import Config
from ..parallel.distributed import assert_agreement, is_primary
from .checkpoints import AsyncCheckpointer, ckpt_path
from .metrics import Evaluator


def make_setting_file(cfg: Config) -> None:
    if not is_primary():        # multi-host: process 0 owns file output
        return
    log_dir = os.path.join(cfg.dir_result, cfg.project_name)
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "settings.txt"), "w") as f:
        for k, v in dataclasses.asdict(cfg).items():
            f.write(f"{k} # {v}\n")


class Logger:
    def __init__(self, cfg: Config, fold: int = 0, seed: Optional[int] = None):
        self.cfg = cfg
        self.fold = fold
        self.seed = cfg.seed if seed is None else seed
        self.dir_log = os.path.join(cfg.dir_result, cfg.project_name,
                                    f"logs_{fold}")
        self.dir_save = os.path.join(cfg.dir_result, cfg.project_name)
        # multi-process: every process tracks metrics/best-score state (the
        # eval outputs are identical on all processes, so decisions agree),
        # but only process 0 touches the filesystem
        self.primary = is_primary()
        if self.primary:
            os.makedirs(self.dir_log, exist_ok=True)
        self.evaluator = Evaluator()
        self.loss = 0.0
        self.val_loss = 0.0
        self.best_score = 0.0
        self.best_auc = 0.0
        self.best_iter = 0
        # explicit first-save tracking, identical on every process (a
        # filesystem probe would diverge across hosts without a shared
        # results dir); mark_restored() sets it on resume so a restored
        # best checkpoint is never clobbered by the first post-resume save
        self._saved_once = False
        self._saver = AsyncCheckpointer()
        self.val_results = None
        self.test_results = None
        self._events = open(
            os.path.join(self.dir_log, "events.jsonl") if self.primary
            else os.devnull, "a")
        self._tb = None
        if self.primary:
            try:
                from tensorboardX import SummaryWriter  # optional
                self._tb = SummaryWriter(logdir=self.dir_log)
            except Exception:
                pass

    def log_scalar(self, tag: str, value: float, step: int) -> None:
        self._events.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")
        self._events.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def log_train(self, loss: float, lr: float, step: int) -> None:
        self.log_scalar("train/loss", loss, step)
        self.log_scalar("train/lr", lr, step)

    def add_validation_logs(self, step: int, val_loss: float):
        m = self.evaluator.performance_metric()
        self.log_scalar("val/loss", val_loss, step)
        for k in ("auc", "apr", "f1"):
            self.log_scalar(f"val/{k}", m[k], step)
        # aux-rmse runs report the rmse aggregate next to auc/apr/f1
        # (reference logger.py:95-99)
        rmse_txt = ""
        if "rmse" in m:
            self.log_scalar("val/rmse", m["rmse"], step)
            rmse_txt = f" rmse={m['rmse']:.4f}"
        self.val_results = m
        if self.primary:
            print(f"[val @ {step}] loss={val_loss:.4f} auc={m['auc']:.4f} "
                  f"apr={m['apr']:.4f} f1={m['f1']:.4f}" + rmse_txt)
        return m

    def save(self, trainer, step: int, epoch: int) -> bool:
        """Save 'last'; promote to 'best' when auc+apr improves
        (logger.py:115-127,166-177). Returns True if best improved.

        Both files are written asynchronously from one snapshot of the
        trainer (checkpoints.AsyncCheckpointer); join via wait_saves()
        before reading the files back."""
        if self.cfg.ckpt_backend == "orbax":
            raise NotImplementedError(
                "--ckpt-backend orbax: the port writes single-file .pth "
                "checkpoints only")
        m = self.val_results or {"auc": 0.0, "apr": 0.0}
        score = (m["auc"] or 0.0) + (m["apr"] or 0.0)
        if score != score:          # nan val metrics (e.g. empty val split)
            score = 0.0
        last = ckpt_path(self.cfg.dir_result, self.cfg.project_name, "last",
                         self.fold, self.seed)
        best = ckpt_path(self.cfg.dir_result, self.cfg.project_name,
                         "best", self.fold, self.seed)
        # always promote the first save so a best ckpt exists even when
        # validation never ran (3_test defaults to best_*.pth). Tracked by
        # an explicit per-process flag — NOT the filesystem, which only the
        # primary can see — so the best-score state stays replicated across
        # hosts (every process runs this method on identical metrics).
        first = not self._saved_once
        self._saved_once = True
        improved = score > self.best_score or first
        # under tensor parallelism every process takes part in each save
        # (a collective): a process that decided otherwise would hang it
        assert_agreement("the best-checkpoint decision", improved)
        jobs = [(last, self.best_iter, step)]
        if improved:
            self.best_score = score
            self.best_auc = m["auc"] or 0.0
            self.best_iter = step
            jobs.append((best, step, step))
        # every process calls: under tensor parallelism the snapshot is a
        # collective; only the primary writes
        self._saver.save_multi(jobs, trainer, score, epoch)
        return improved

    def wait_saves(self) -> None:
        """Join any in-flight async checkpoint write (call before reading
        best/last back, and before process exit)."""
        self._saver.wait()

    def mark_restored(self):
        """Resume restored a prior best checkpoint: suppress the
        promote-first-save rule so it is not overwritten by a worse state."""
        self._saved_once = True

    def test_result_only(self):
        m = self.evaluator.performance_metric()
        self.test_results = m
        rmse_txt = f" rmse={m['rmse']:.4f}" if "rmse" in m else ""
        if self.primary:
            print(f"[test] auc={m['auc']:.4f} apr={m['apr']:.4f} "
                  f"f1={m['f1']:.4f}" + rmse_txt)
        return m

    def val_result_only(self):
        return self.val_results

    def close(self):
        self.wait_saves()
        self._events.close()
        if self._tb is not None:
            self._tb.close()


class ResultsAggregator:
    """mean/std across seeds/folds (result_utils.py:7-128)."""

    def __init__(self, name: str):
        self.name = name
        self.rows = []

    def add(self, metrics: Dict[str, float]):
        if metrics:
            self.rows.append(metrics)

    def summarize(self):
        import numpy as np
        if not self.rows:
            if is_primary():
                print(f"[{self.name}] no results")
            return {}
        out = {}
        for k in ("auc", "apr", "f1"):
            vals = np.array([r[k] for r in self.rows if r.get(k) == r.get(k)])
            if len(vals):
                out[k] = (float(vals.mean()), float(vals.std()))
        if is_primary():
            print(f"[{self.name}] " + "  ".join(
                f"{k}={m:.4f}±{s:.4f}" for k, (m, s) in out.items()))
        return out
