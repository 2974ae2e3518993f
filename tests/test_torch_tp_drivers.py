"""The drivers under tensor parallelism (--mp-size 2 --dp-size 1) on the
CPU: two gloo ranks started by parallel.launch (rank bodies in
tests/tp_drivers_worker.py, which imports no jax) train, save, resume and
test through the drivers' bodies, against the single process on the same
batches; process 0 alone writes (a guard makes any write under the
results directory by the other rank raise); TP's checkpoints load into the
single process; the processes must agree on the checkpoints they read.
tests/test_torch_drivers.py runs both drivers' ``main`` under the flags."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.drivers import common
from medical_tri_modal_pilot_tpu_torch.drivers import test as test_driver
from medical_tri_modal_pilot_tpu_torch.drivers import train as train_driver
from medical_tri_modal_pilot_tpu_torch.parallel import distributed
from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
from medical_tri_modal_pilot_tpu_torch.train import checkpoints
from medical_tri_modal_pilot_tpu_torch.data.synthetic import (BatchList,
                                                          synthetic_batch)
from test_torch_drivers import (B, CONFIG2, TP_FLAGS, _losses,
                                _well_separated)
from tp_drivers_worker import record_probs

TESTS = Path(__file__).resolve().parent
# two ranks against one process over the fold's eight train steps (two
# runs of four): besides the sums split over the model group, Adam turns
# a parameter's near-zero gradient into a step of its own sign, lr in
# size, whatever its magnitude, and such steps add up (ROADMAP Queue 3:
# the JAX package's single and TP steps differ so, and a run's bound
# grows with the run); measured 1.0e-3 on the probabilities
TP_RUN_TOL = 5e-3


@pytest.fixture
def fixtures(tmp_path):
    """Synthetic vslt + BioBERT fixtures and the argv over them (no
    --dir-result); one intra-op thread, as the ranks."""
    from tools.make_synthetic_fixtures import main as make
    synth = tmp_path / "synth"
    make(["--out", str(synth), "--n-train", "12", "--n-test", "6",
          "--seed", "5"])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield CONFIG2 + [
        "--train-data-path", f"{synth}/train",
        "--test-data-path", f"{synth}/test",
        "--biobert-path", f"{synth}/mimic4_embeddings.h5",
        "--dir-root", str(synth), "--num-workers", "1", "--epochs", "1",
        "--seed-list", "7", "--transformer-num-head", "4",
        "--checkpoint-every", "2", "--log-iter", "1"]
    torch.set_num_threads(threads)


@pytest.fixture
def probs(monkeypatch):
    """The probabilities every Evaluator of this process is given, in
    order (the patch is undone after the test)."""
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    monkeypatch.setattr(Evaluator, "add_batch", Evaluator.add_batch)
    return record_probs()


def _files(root: Path):
    """The files under root; tensorboard event files (named by the second
    their writer opened and the host, so two writers in one second share
    one file) as their directory and kind, once."""
    names = set()
    for p in root.rglob("*"):
        if p.is_file():
            rel = str(p.relative_to(root))
            if "events.out.tfevents." in p.name:
                rel = str(p.parent.relative_to(root) / "events.out.tfevents")
            names.add(rel)
    return sorted(names)


def _launch(tmp_path, body, out):
    launch(f"tp_drivers_worker:{body}", 2,
           f"file://{tmp_path / ('rendezvous_' + body)}", [str(out)],
           pythonpath=[str(TESTS)], timeout=300, capture=True)


# the fold's batches: (count, first seed) of train, validation and test;
# the evaluated ones hold both classes
FOLD = ((4, 10), (2, 20), (2, 30))


def _fold_batches(cfg):
    out = []
    for n, seed in FOLD:
        batches = [synthetic_batch(cfg, B, seed=seed + i) for i in range(n)]
        if seed != FOLD[0][1]:
            for b in batches:
                b["target"][:] = [1, 0, 1, 0]
        out.append(batches)
    return out


def test_tp_drivers_train_resume_and_test_as_one_process(tmp_path, probs):
    """Two ranks through the drivers' bodies over fixed batches (the
    loaders of ``main`` draw their items from one RNG that the worker
    threads share, ROADMAP Queue 3, so two ``main`` runs need not see the
    same batches): ``run_fold`` for an epoch with a step save and the epoch
    save, ``run_fold`` again under --resume last, then the test driver's
    ``run_checkpoints`` walk. Against the single process running the same
    three: every probability the metrics read and every logged loss
    within TP_RUN_TOL, the aggregates where the probabilities lie well
    apart; the same files, all written by process 0 (process 1 writes
    nothing: its guard would fail the launch); TP's checkpoints hold the
    single process's steps, keys and shapes, and a single process scores
    them to TP's own walk within 1e-5."""
    from tp_drivers_worker import fold_resume_walk
    argv = CONFIG2 + ["--epochs", "1", "--checkpoint-every", "2",
                      "--img-pack-frac", "0.5",
                      "--log-iter", "1", "--transformer-num-head", "4"]
    single = tmp_path / "single"
    cfg = parse_config(argv + ["--dir-result", str(single)])
    batches = _fold_batches(cfg)
    loaders = lambda: [BatchList(b) for b in batches]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # as the ranks
    try:
        want = fold_resume_walk(cfg, loaders, "cpu")
        tp = tmp_path / "tp"
        out = tmp_path / "out"
        out.mkdir()
        (out / "argv.json").write_text(json.dumps(
            argv + TP_FLAGS + ["--dir-result", str(tp)]))
        torch.save(batches, out / "batches.pt")
        _launch(tmp_path, "fold", out)
        got = json.loads((out / "results.json").read_text())
        np.testing.assert_allclose(got["probs"], probs, rtol=0,
                                   atol=TP_RUN_TOL)
        want_losses, got_losses = _losses(single), _losses(tp)
        assert got_losses.keys() == want_losses.keys()
        assert sum(tag == "train/loss" for tag, _ in got_losses) == 8
        np.testing.assert_allclose(list(got_losses.values()),
                                   list(want_losses.values()), rtol=0,
                                   atol=TP_RUN_TOL)
        if _well_separated(probs, TP_RUN_TOL):
            for key, w in want.items():
                for g1, w1 in zip(got[key] if key == "walk" else [got[key]],
                                  w if key == "walk" else [w]):
                    np.testing.assert_allclose(
                        [g1[k] for k in sorted(w1)],
                        [w1[k] for k in sorted(w1)], rtol=0, atol=1e-4,
                        equal_nan=True, err_msg=key)
        assert _files(tp) == _files(single)
        ckpts = sorted((tp / "small1" / "ckpts").glob("*.pth"))
        assert [p.name for p in ckpts] == ["best_fold0_seed0.pth",
                                           "last_fold0_seed0.pth"]
        for path in ckpts:
            a = checkpoints.load_checkpoint(str(path))
            b = checkpoints.load_checkpoint(
                str(single / "small1" / "ckpts" / path.name))
            assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
            assert {k: v.shape for k, v in a["model"].items()} == \
                {k: v.shape for k, v in b["model"].items()}
        # TP's checkpoints in a single process: TP's own walk (the same
        # weights; the sums split over the ranks, 1e-5 as in
        # tests/test_torch_tp.py)
        n = len(probs)
        tp_cfg = parse_config(argv + ["--dir-result", str(tp)])
        paths = test_driver.checkpoints_of(tp_cfg)
        test_driver.run_checkpoints(tp_cfg, paths, loaders()[2],
                                    device="cpu")
        walked = probs[n:]
        assert paths and len(walked) == len(paths) * FOLD[2][0] * B
        np.testing.assert_allclose(walked, got["probs"][-len(walked):],
                                   rtol=0, atol=1e-5)
    finally:
        torch.set_num_threads(threads)


def test_train_main_ranks_compute_on_one_batch_stream(tmp_path, fixtures):
    """The train driver's ``main`` in two ranks with three loader worker
    threads, whose draws from the dataset's shared RNG need not repeat
    from one process to the next: process 0 draws every batch and the
    other computes on the same one (the same digest at every step, the
    same loss), both give the metrics the same probabilities, and process
    1 writes nothing, under the results directory nor the eval index
    caches' ./data, which process 0 builds first."""
    out = tmp_path / "out"
    out.mkdir()
    (out / "argv.json").write_text(json.dumps(
        fixtures + TP_FLAGS + ["--num-workers", "3", "--dir-result",
                               str(tmp_path / "res")]))
    _launch(tmp_path, "main_steps", out)
    ranks = [json.loads((out / f"steps{r}.json").read_text())
             for r in (0, 1)]
    steps = [r["steps"] for r in ranks]
    assert len(steps[0]) == len(steps[1]) >= 2
    assert [d for d, _ in steps[1]] == [d for d, _ in steps[0]]
    assert len({d for d, _ in steps[0]}) == len(steps[0])
    np.testing.assert_array_equal([x for _, x in steps[1]],
                                  [x for _, x in steps[0]])
    assert ranks[0]["probs"] and ranks[1]["probs"] == ranks[0]["probs"]
    assert (tmp_path / "data" / "testIndexes").is_dir()


def test_ranks_must_agree_on_the_checkpoints(tmp_path, fixtures):
    """assert_agreement passes equal values across the ranks; the test
    driver with process 0 seeing a checkpoint and process 1 none raises
    on both, naming the count and every process's value."""
    res = tmp_path / "out" / "results0"
    train_driver.main(fixtures + ["--dir-result", str(res)], device="cpu")
    out = tmp_path / "out"
    (out / "argv.json").write_text(json.dumps(fixtures + TP_FLAGS))
    _launch(tmp_path, "disagree", out)
    for rank in (0, 1):
        message = (out / f"error{rank}.txt").read_text()
        assert "checkpoint count" in message, message
        assert "[1.0, 0.0]" in message, message


def test_one_process_needs_no_group():
    """In one process assert_agreement passes any value, and --mp-size 2
    or --dp-size 2 without a process group is refused by name before a
    model is built (the flags pass check_flags: the drivers run them in
    their processes)."""
    distributed.assert_agreement("anything", 3.5)
    with pytest.raises(ValueError, match="--mp-size 2 needs 2 processes"):
        common.setup_distributed(parse_config(CONFIG2 + TP_FLAGS), "cpu")
    dp = parse_config(CONFIG2 + ["--dp-size", "2"])
    common.check_flags(dp)
    with pytest.raises(ValueError, match="--dp-size 2 needs 2 processes"):
        common.setup_distributed(dp, "cpu")
    assert not os.environ.get("GRAFT_COORDINATOR")
