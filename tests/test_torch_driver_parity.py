"""The JAX drivers against the port's, on the CPU, in fp32 at --dropout 0,
config 2 (tri_mbt_vsltcls, vslt+txt, TIE) at a small width on the
synthetic fixtures: ``2_train.py`` runs one epoch in this process; its
checkpoints, scored by ``3_test.py`` and by the port's test driver (in a
fresh interpreter where jax, flax and optax cannot be imported), give the
same metrics; then both drivers resume from that one JAX checkpoint, each
in a copy of the result directory, and end in the same state.

The JAX epoch runs at the full learning rate from its first step
(--t_up 0), so that the test scores spread: an untrained model scores one
stay's windows within 1e-6 of each other, and a difference in the last
digit then reorders a positive and a negative and moves the AUPRC. The
resumed runs take the default warm-up (--t_up 5) at a tenth of the
default learning rate (--lr-init 1e-4): Adam walks the head's bias, which
the BatchNorm cancels, by up to the learning rate a step on each side,
and at the default rate that walk moves the validation loss of ten steps
by about 1e-3 (measured: 1.1e-3 with 2 torch threads), where the
comparison has to resolve 1e-3; at a tenth it moves it by 1e-4 to 4e-4
(2 and 8 threads)."""
import json
import os
import pickle
import re
import runpy
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.drivers import train as port_train
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.train import checkpoints
from medical_tri_modal_pilot_tpu_torch.train.trainer import (Trainer,
                                                             build_schedule)
from test_torch_train import compare_train_state

REPO = Path(__file__).resolve().parent.parent
# metrics of one checkpoint, printed by both drivers as
# "[test] auc=... apr=... f1=..." (4 decimals); 1e-3 apart at most
METRIC_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite's workers share the machine, and a
    pool of one thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _argv(synth, extra=()):
    return ["--train-data-path", f"{synth}/train",
            "--test-data-path", f"{synth}/test",
            "--image-data-path", f"{synth}/images/",
            "--biobert-path", f"{synth}/mimic4_embeddings.h5",
            "--dir-root", synth, "--input-types", "vslt_txt",
            "--output-type", "intubation",
            "--modality-inclusion", "train-missing_test-missing",
            "--model", "tri_mbt_vsltcls", "--vslt-type", "TIE",
            "--imgtxt-time", "1", "--batch-size", "4",
            "--num-workers", "1", "--TIE-len", "64",
            "--transformer-num-layers", "2", "--transformer-dim", "64",
            "--transformer-num-head", "2", "--precision", "fp32",
            "--dropout", "0", "--t_up", "0", "--seed-list", "412",
            "--train-multi-k", "1",
            "--dir-result", "res", "--project-name", "p"] + list(extra)


def _run_jax(script, argv, monkeypatch):
    monkeypatch.setenv("GRAFT_COMPILE_CACHE", "0")
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(str(REPO / script), run_name="__main__")


def _test_lines(out: str):
    """{checkpoint file name: (auc, apr, f1)} from a test driver's output."""
    got, path = {}, None
    for line in out.splitlines():
        if line.startswith("ckpt: "):
            path = os.path.basename(line[6:].strip())
        m = re.match(r"\[test\] auc=(\S+) apr=(\S+) f1=(\S+)", line)
        if m and path:
            got[path] = tuple(float(x) for x in m.groups())
            path = None
    return got


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Fixtures and one JAX epoch, in a directory of their own."""
    root = tmp_path_factory.mktemp("driver_parity")
    from tools.make_synthetic_fixtures import main as make
    make(["--out", str(root / "synth"), "--n-train", "12", "--n-test", "6",
          "--seed", "3"])
    cwd = os.getcwd()
    os.chdir(root)
    mp = pytest.MonkeyPatch()
    try:
        (root / "data").mkdir(exist_ok=True)
        _run_jax("2_train.py", _argv(str(root / "synth"), ["--epochs", "1"]),
                 mp)
    finally:
        mp.undo()
        os.chdir(cwd)
    return root


def test_port_test_driver_scores_jax_checkpoints(jax_run, monkeypatch,
                                                 capsys):
    """JAX 3_test.py and the port's test driver, read without jax, over
    the JAX run's best and last pickles."""
    monkeypatch.chdir(jax_run)
    argv = _argv(str(jax_run / "synth"), ["--last"])
    capsys.readouterr()
    _run_jax("3_test.py", argv, monkeypatch)
    want = _test_lines(capsys.readouterr().out)
    assert sorted(want) == ["best_fold0_seed412.pth",
                            "last_fold0_seed412.pth"]
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax",
                     "medical_tri_modal_pilot_tpu"):
            sys.modules[name] = None
        from medical_tri_modal_pilot_tpu_torch.drivers import test
        test.main({argv!r}, device="cpu")
    """)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=jax_run, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = _test_lines(r.stdout)
    assert got.keys() == want.keys(), r.stdout
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=METRIC_TOL,
                                   err_msg=name)


def _last_val(events: Path):
    """The last validation block of an events.jsonl: {tag: value}."""
    rows = [json.loads(l) for l in events.read_text().splitlines()]
    last = max(r["step"] for r in rows if r["tag"] == "val/loss")
    return {r["tag"]: r["value"] for r in rows
            if r["tag"].startswith("val/") and r["step"] == last}, last


def test_both_drivers_resume_from_one_jax_checkpoint(jax_run, tmp_path,
                                                     monkeypatch):
    """--resume last --epochs 2 from the JAX epoch's 'last' pickle, in two
    copies of its result directory: the validation metrics of the run's
    last epoch within 1e-3, and the final parameters, Adam moments and
    BatchNorm statistics within compare_train_state's bounds over the
    summed learning rates of the resumed steps (the JAX driver runs the
    saved epoch again, and so does the port's)."""
    synth = str(jax_run / "synth")
    argv = _argv(synth, ["--epochs", "2", "--resume", "last", "--t_up", "5",
                         "--lr-init", "1e-4"])
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        (d / "data").mkdir(parents=True)
        shutil.copytree(jax_run / "res", d / "res")
        dirs[side] = d
    monkeypatch.chdir(dirs["jax"])
    _run_jax("2_train.py", argv, monkeypatch)
    monkeypatch.chdir(dirs["port"])
    port_train.main(argv, device="cpu")

    logs = Path("res") / "p" / "logs_0" / "events.jsonl"
    (want, step_j), (got, step_p) = (_last_val(dirs[s] / logs)
                                     for s in ("jax", "port"))
    assert step_j == step_p == 15
    assert want.keys() == got.keys()
    for tag in want:
        np.testing.assert_allclose(got[tag], want[tag], atol=METRIC_TOL,
                                   equal_nan=True, err_msg=tag)

    last = Path("res") / "p" / "ckpts" / "last_fold0_seed412.pth"
    with open(dirs["jax"] / last, "rb") as f:
        jpay = pickle.load(f)
    assert jpay["step"] == 15
    jt = types.SimpleNamespace(state=types.SimpleNamespace(
        params=jpay["model"]["params"], opt_state=jpay["optimizer"],
        batch_stats=jpay["model"]["batch_stats"]))
    cfg = parse_config(argv)
    tr = Trainer(cfg, get_model(cfg), "cpu", eval_only=False,
                 iters_per_epoch=5)
    payload = checkpoints.load_checkpoint(dirs["port"] / last)
    assert payload["step"] == 15 and "format" not in payload
    checkpoints.restore(tr, payload)
    # the resumed run: updates 5..14 under the 2-epoch schedule
    schedule = build_schedule(cfg, 5)
    lr_sum = sum(schedule(k) for k in range(5, 15))
    compare_train_state(cfg, jt, tr, lr_sum, bias_walk=2.01 * lr_sum)
