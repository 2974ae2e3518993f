"""The port's train driver: the flow and flags of ``2_train.py``.

    python -m medical_tri_modal_pilot_tpu_torch.drivers.train <2_train.py's flags>

Seeds, the settings file and the patient split; then per seed (or fold):
the loaders, the device-resident note table, the model and the
``Trainer``; ``--resume``; the epoch loop with ``--log-iter`` and
``--checkpoint-every`` (asynchronous) saves; validation and the last/best
saves each epoch; the final test of the best checkpoint; the aggregates
over seeds. ``run_fold`` is one seed's body, over loaders and a note
table its caller gives (``main`` builds them from the data paths).

It runs on the GPU and raises when there is none, unless the caller passes
``device="cpu"`` to ``main`` or ``run_fold``. Under ``--mp-size N
--dp-size 1`` it runs in N processes (started by ``parallel.launch`` or
given ``--dist-coordinator``, ``--dist-num-processes`` and
``--dist-process-id``): each joins the group, builds the mesh and a
sharded ``Trainer``, computes on the batches process 0 draws (each one
broadcast to the others) and takes part in every save (the state is
gathered from the model group); process 0 builds the index caches before
the others read them, the processes agree on the checkpoint they resume
from, on each best-checkpoint decision and on the one they test, and only
process 0 prints and writes files. ``--profile-dir`` writes a
``torch.profiler`` trace of the first 10 steps there (``trace.json``);
``--debug-nans 1`` turns on autograd's anomaly mode and raises on a
non-finite train loss. ``--resume`` restores the saved epoch's number and
runs that epoch again, as the JAX driver does.
"""
from __future__ import annotations

import math
import os
import sys
import time
from typing import Optional, Sequence, Tuple

import torch

from ..config import Config, parse_config
from ..data.pipeline import (auto_img_pack_frac, get_data_loaders,
                             length_rebatch, maybe_replay)
from ..data.indexer import patient_wise_ordering
from ..data.txt_table import build_txt_table
from ..models import get_model
from ..parallel.distributed import (BroadcastLoader, assert_agreement,
                                    barrier, is_primary, primary_first)
from ..train import checkpoints as ckpt
from ..train.logger import Logger, ResultsAggregator, make_setting_file
from ..train.trainer import Trainer
from .common import (check_flags, first_batch, resolve_device, run_eval, say,
                     set_seeds, setup_distributed)

# the steps a --profile-dir trace holds (2_train.py:225)
PROFILE_STEPS = 10


class StepProfiler:
    """``--profile-dir``: a torch.profiler trace from the start of the run
    to step PROFILE_STEPS (or the end of training), written to
    ``{profile_dir}/trace.json``."""

    def __init__(self, profile_dir: Optional[str], device: torch.device):
        self.dir = profile_dir
        self.prof = None
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def step(self, iteration: int) -> None:
        if iteration == PROFILE_STEPS:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        prof.export_chrome_trace(path)
        say(f"profile trace: {path}", flush=True)


def restore_for_resume(cfg: Config, k_indx: int, trainer, logger
                       ) -> Tuple[int, int, Optional[str]]:
    """``--resume auto|best|last`` and ``--checkpoint --last/--best``
    (2_train.py:155-195): restore the chosen checkpoint of this fold and
    seed into ``trainer`` and ``logger``. ``auto`` takes the newest of last
    and best by optimizer step. Every process finds and reads its own, and
    they must agree on its step (none: -1) before any restores it
    (2_train.py:182-186). Returns (start epoch, iteration, the path
    restored or None)."""
    resume = cfg.resume
    payload, path = None, None
    if resume == "auto":
        cands = []
        for kind in ("last", "best"):
            p = ckpt.ckpt_path(cfg.dir_result, cfg.project_name, kind,
                               k_indx, cfg.seed)
            if ckpt.ckpt_exists(p):
                pay = ckpt.load_checkpoint_any(cfg.ckpt_backend, p)
                cands.append((int(pay.get("step", 0)), p, pay))
        if cands:
            _, path, payload = max(cands, key=lambda c: c[0])
    elif resume in ("best", "last") or cfg.checkpoint:
        kind = resume if resume in ("best", "last") else \
            ("last" if cfg.last else "best")
        p = ckpt.ckpt_path(cfg.dir_result, cfg.project_name, kind, k_indx,
                           cfg.seed)
        if ckpt.ckpt_exists(p):
            payload = ckpt.load_checkpoint_any(cfg.ckpt_backend, p)
            path = p
    assert_agreement("resume checkpoint step",
                     -1 if payload is None else int(payload.get("step", 0)))
    if payload is None:
        return 1, 0, None
    ckpt.restore(trainer, payload)
    logger.best_auc = payload["score"]
    logger.best_score = payload["score"]
    logger.mark_restored()
    start_epoch = int(payload["epoch"])
    iteration = int(payload.get("last_step", 0))
    say(f"resumed from {path} (epoch {start_epoch}, iteration "
        f"{iteration})")
    return start_epoch, iteration, path


def run_fold(cfg: Config, k_indx: int, train_loader, val_loader,
             test_loader, txt_table=None, device=None,
             profiler: Optional[StepProfiler] = None, mesh=None):
    """One seed's run (2_train.py:100-349) over the given loaders (``len``
    and iteration of numpy batches; val and test need no ``dataset``) and
    the note table their batches' ``txt_id`` rows index; under ``--mp-size``
    on this process's device and ``mesh`` (``common.setup_distributed``),
    where every process computes on the batches process 0 draws.
    Returns the last validation metrics and the test metrics of the best
    checkpoint (None where there was nothing to run)."""
    dev = resolve_device(device)
    check_flags(cfg)
    if mesh is not None:
        train_loader, val_loader, test_loader = (
            BroadcastLoader(ld) for ld in (train_loader, val_loader,
                                           test_loader))
    logger = Logger(cfg, fold=k_indx, seed=cfg.seed)
    say("########## Experiment Begins ##########")
    say(cfg.input_types, cfg.modality_inclusion, cfg.model)
    # validation runs every epoch over identical batches: replay them from
    # memory after the first pass (a no-op under --*-observed-prop < 100)
    val_loader = maybe_replay(val_loader, cfg)
    iters_per_epoch = len(train_loader)
    say("# of Iterations (per epoch): ", iters_per_epoch)
    if iters_per_epoch == 0:
        say("empty train loader — reduce batch size or add data")
        logger.close()
        return None, None
    if cfg.img_pack_frac < 0:
        cfg = cfg.replace(img_pack_frac=auto_img_pack_frac(train_loader))
        say("auto img-pack capacity fraction: "
            f"{cfg.img_pack_frac:.3f}")
    model = get_model(cfg)
    first_batch(train_loader)
    trainer = Trainer(cfg, model, dev, eval_only=False,
                      iters_per_epoch=iters_per_epoch, seed=cfg.seed,
                      mesh=mesh, txt_table=txt_table)
    start_epoch, iteration, _ = restore_for_resume(cfg, k_indx, trainer,
                                                   logger)
    t_start = time.time()
    saver = ckpt.AsyncCheckpointer()
    step_path = ckpt.ckpt_path(cfg.dir_result, cfg.project_name, "last",
                               k_indx, cfg.seed)
    with torch.autograd.set_detect_anomaly(bool(cfg.debug_nans)):
        for epoch in range(start_epoch, cfg.epochs + 1):
            for batch in length_rebatch(train_loader, cfg.length_rebatch):
                loss = trainer.train_step(batch)
                iteration += 1
                if cfg.debug_nans and not math.isfinite(loss):
                    raise FloatingPointError(
                        f"--debug-nans: train loss {loss} at iteration "
                        f"{iteration}")
                if profiler is not None:
                    profiler.step(iteration)
                if iteration % cfg.log_iter == 0:
                    logger.log_train(loss, trainer.current_lr(), iteration)
                if (cfg.checkpoint_every > 0
                        and iteration % cfg.checkpoint_every == 0):
                    saver.save(step_path, trainer, logger.best_score, epoch,
                               logger.best_iter, iteration)
            if len(val_loader) > 0:
                val_loss = run_eval(trainer, val_loader, logger.evaluator)
                logger.add_validation_logs(iteration, val_loss)
            saver.wait()        # the epoch's 'last' save comes after it
            logger.save(trainer, iteration, epoch)
            barrier()
            say(f"epoch {epoch}/{cfg.epochs} done ({iteration} iters, "
                f"{time.time() - t_start:.1f}s elapsed)", flush=True)
    if profiler is not None:
        profiler.stop()
    val_results = logger.val_results

    # the final test with the best checkpoint (2_train.py:298-349): process
    # 0's writes are done before any process reads, and every process
    # restores the same state (or none)
    kind = "last" if cfg.last and not cfg.best else "best"
    path = ckpt.ckpt_path(cfg.dir_result, cfg.project_name, kind, k_indx,
                          cfg.seed)
    logger.wait_saves()
    barrier()
    payload = (ckpt.load_checkpoint_any(cfg.ckpt_backend, path)
               if ckpt.ckpt_exists(path) else None)
    assert_agreement(f"final {kind} checkpoint step",
                     -1 if payload is None else int(payload.get("step", 0)))
    if payload is not None:
        ckpt.restore(trainer, payload, with_optimizer=False)
    test_results = None
    if len(test_loader) > 0:
        run_eval(trainer, test_loader, logger.evaluator)
        test_results = logger.test_result_only()
    logger.close()
    return val_results, test_results


def main(argv: Optional[Sequence[str]] = None, device=None):
    """The whole run over ``argv`` (sys.argv when None). Returns the
    aggregates (validation, test) over the seeds."""
    cfg = parse_config(argv)
    check_flags(cfg)
    dev, mesh = setup_distributed(cfg, device)
    make_setting_file(cfg)
    profiler = StepProfiler(cfg.profile_dir if is_primary() else None, dev)
    save_valid = ResultsAggregator("validation (all seeds)")
    save_test = ResultsAggregator("test (all seeds)")
    patient_dict, keys_list = patient_wise_ordering(cfg)
    say("Selected Dataset: ", cfg.train_data_path.split("/")[-2])
    for k_indx, seed_num in enumerate(cfg.seed_list):
        seed_cfg = cfg.replace(
            seed=seed_num if cfg.cross_fold_val != 1 else cfg.seed,
            log_fold=k_indx)
        set_seeds(seed_cfg.seed)
        loaders = primary_first(lambda: get_data_loaders(
            seed_cfg, patient_dict, keys_list, k_indx))
        t_tab = time.time()
        txt_table = build_txt_table(seed_cfg,
                                    [ld.dataset for ld in loaders])
        if txt_table is not None:
            say(f"txt device table: {len(txt_table.lengths)} rows, "
                f"{txt_table.nbytes / 2**20:.0f} MB "
                f"({time.time() - t_tab:.1f}s build)", flush=True)
        val, test = run_fold(seed_cfg, k_indx, *loaders, txt_table=txt_table,
                             device=dev, profiler=profiler, mesh=mesh)
        save_valid.add(val)
        save_test.add(test)
    profiler.stop()
    return save_valid.summarize(), save_test.summarize()


if __name__ == "__main__":
    main(sys.argv[1:])
