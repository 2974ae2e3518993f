"""The port's drivers and what they run on, on the CPU at a small width:
the settings file, the wire format and the TIE buckets of
``Trainer.device_batch``, the asynchronous saver, ``--resume``, the test
driver over both checkpoint formats and the JAX checkpoint reader, the
flags the drivers refuse or honour (the tensor-parallel ones in two gloo
ranks, rank bodies in tests/tp_drivers_worker.py), and a config-4 run
(full Swin-T, 2 MBT layers at d 64) that trains, validates, saves and
tests end to end."""
import collections
import io
import json
import os
import pickle
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.train import checkpoints as jax_ckpt
from medical_tri_modal_pilot_tpu.train import logger as jax_logger
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
    BatchList, synthetic_batch, to_wire)
from medical_tri_modal_pilot_tpu_torch.drivers import test as test_driver
from medical_tri_modal_pilot_tpu_torch.drivers import train as train_driver
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import \
    from_jax_variables
from medical_tri_modal_pilot_tpu_torch.train import checkpoints
from medical_tri_modal_pilot_tpu_torch.train import logger as port_logger
from medical_tri_modal_pilot_tpu_torch.train.logger import Logger
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

B = 4
SMALL = ["--model", "tri_mbt_vsltcls", "--vslt-type", "TIE",
         "--imgtxt-time", "1", "--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--TIE-len", "64",
         "--transformer-num-layers", "2", "--transformer-dim", "64",
         "--transformer-num-head", "2", "--precision", "fp32"]
CONFIG2 = SMALL + ["--input-types", "vslt_txt"]
CONFIG4 = SMALL + ["--input-types", "vslt_img_txt"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite's workers share the machine, and a
    pool of one thread per core in each of them oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batches(cfg, n, seed=3, present=0.5):
    return [synthetic_batch(cfg, B, seed=seed + i, present_frac=present)
            for i in range(n)]


def _tensors_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ------------------------------------------------------------ settings

def test_settings_file_matches_jax(tmp_path):
    """The same bytes as the JAX make_setting_file for the same argv."""
    argv = CONFIG4 + ["--dir-result", str(tmp_path), "--seed-list", "1",
                      "2", "--resume", "auto"]
    path = tmp_path / "small1" / "settings.txt"
    jax_logger.make_setting_file(jax_parse(argv))
    want = path.read_bytes()
    path.unlink()
    port_logger.make_setting_file(parse_config(argv))
    assert path.read_bytes() == want and len(want) > 1000


# ------------------------------------------------------- wire, buckets

@pytest.fixture(scope="module")
def config4():
    cfg = parse_config(CONFIG4 + ["--img-pack-frac", "0.5"])
    return cfg, get_model(cfg)


def test_wire_resolves_to_the_dense_batch(config4):
    """uint8 pixels packed on the host (2 of 4 present, capacity 3) and
    unpacked (4 of 4: over the capacity), notes as txt_id rows: the device
    batch equals the dense fp32 one bit for bit, and so do the eval
    step's probabilities and loss."""
    cfg, model = config4
    batches = [synthetic_batch(cfg, B, seed=3, present_frac=0.5),
               synthetic_batch(cfg, B, seed=4, present_frac=1.0)]
    wire, dense, table = to_wire(batches)
    tr = Trainer(cfg, model, "cpu", txt_table=table)
    assert tr.wire_pack_c == 3
    assert "img_pack" in tr.wire_pack(wire[0])
    assert "img_pack" not in tr.wire_pack(wire[1])
    for w, d in zip(wire, dense):
        assert w["img"].dtype == np.uint8 and "txt" not in w
        _tensors_equal(tr.device_batch(w), tr.device_batch(d))
    p_w, loss_w, _ = tr.eval_step(wire[0])
    p_d, loss_d, _ = tr.eval_step(dense[0])
    assert np.array_equal(p_w, p_d) and loss_w == loss_d


def test_txt_id_batch_needs_the_table(config4):
    cfg, model = config4
    wire, _, _ = to_wire(_batches(cfg, 1))
    with pytest.raises(ValueError, match="txt_table"):
        Trainer(cfg, model, "cpu").device_batch(wire[0])


def test_bucket_slice_gives_the_full_batch_result():
    """--tie-buckets auto at TIE-len 600 (256, 512, 600): a batch whose
    TIE lengths are all <= 256 runs at 256, with the probabilities and
    loss of the same batch at full length (fp32, 1e-6)."""
    argv = CONFIG2[:-2] + ["--TIE-len", "600", "--input-types", "vslt_txt"]
    cfg = parse_config(argv)
    off = cfg.replace(tie_buckets="off")
    batch = synthetic_batch(cfg, B, seed=5)
    L = batch["input_length"]
    L[:] = np.minimum(L, 200)
    batch["vslt"][:, 200:] = 0.0
    model = get_model(cfg)
    tr, full = Trainer(cfg, model, "cpu"), Trainer(off, model, "cpu")
    assert tr.buckets == (256, 512, 600) and full.buckets == ()
    assert tr.device_batch(batch)["vslt"].shape[1] == 256
    assert full.device_batch(batch)["vslt"].shape[1] == 600
    (p, loss, _), (pf, lf, _) = tr.eval_step(batch), full.eval_step(batch)
    np.testing.assert_allclose(p, pf, rtol=0, atol=1e-6)
    assert abs(loss - lf) <= 1e-6


# --------------------------------------------------------- async saver

def _trainer(cfg, seed=7):
    return Trainer(cfg, get_model(cfg), "cpu", eval_only=False, seed=seed)


def test_async_save_holds_its_step(tmp_path):
    """The file of a save taken after step 2 holds step 2's model and
    optimizer bit for bit, while steps 3-5 run before it is joined; both
    files of a save_multi hold the same state."""
    cfg = parse_config(CONFIG2 + ["--dropout", "0.1"])
    batches = _batches(cfg, 5)
    tr = _trainer(cfg)
    for b in batches[:2]:
        tr.train_step(b)
    model_sd, opt_sd = tr.state_dicts()
    model_sd = {k: v.clone() for k, v in model_sd.items()}
    opt_sd = {i: {k: v.clone() for k, v in st.items()}
              for i, st in opt_sd["state"].items()}
    saver = checkpoints.AsyncCheckpointer()
    paths = [str(tmp_path / f"{k}.pth") for k in ("last", "best")]
    saver.save_multi([(paths[0], 0, 2), (paths[1], 2, 2)], tr, 0.5, 1)
    for b in batches[2:]:
        tr.train_step(b)
    saver.wait()
    assert tr.step == 5
    for path in paths:
        pay = checkpoints.load_checkpoint(path)
        assert (pay["step"], pay["epoch"], pay["last_step"]) == (2, 1, 2)
        _tensors_equal(pay["model"], model_sd)
        for i, st in pay["optimizer"]["state"].items():
            _tensors_equal(st, opt_sd[i])
    assert not torch.equal(tr.model.state_dict()["ie_feat.weight"],
                           model_sd["ie_feat.weight"])


def test_async_save_raises_a_failed_write_at_wait(tmp_path):
    cfg = parse_config(CONFIG2)
    saver = checkpoints.AsyncCheckpointer()
    (tmp_path / "file").write_text("")
    saver.save(str(tmp_path / "file" / "x.pth"), _trainer(cfg), 0.0, 1)
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()


# -------------------------------------------------------------- resume

@pytest.mark.parametrize("newest", ["last", "best"])
def test_resume_auto_takes_the_newest(tmp_path, newest):
    """--resume auto restores the newer of last and best by step; --resume
    best and --checkpoint --last take theirs; none restores nothing."""
    base = CONFIG2 + ["--dir-result", str(tmp_path), "--seed", "0"]
    cfg = parse_config(base)
    batches = _batches(cfg, 3)
    tr = _trainer(cfg)
    other = "best" if newest == "last" else "last"
    tr.train_step(batches[0])
    path = lambda kind: checkpoints.ckpt_path(str(tmp_path), "small1", kind,
                                              0, 0)
    checkpoints.save_checkpoint(path(other), tr, 0.25, 1, last_step=1)
    for b in batches[1:]:
        tr.train_step(b)
    checkpoints.save_checkpoint(path(newest), tr, 0.5, 2, last_step=3)
    for flags, step, kind in ((["--resume", "auto"], 3, newest),
                              (["--resume", other], 1, other),
                              (["--checkpoint", "1", "--last"], None, "last"),
                              ([], 0, None)):
        c = parse_config(base + flags)
        fresh = _trainer(c)
        log = Logger(c)
        got = train_driver.restore_for_resume(c, 0, fresh, log)
        want_step = step if step is not None else (3 if newest == "last"
                                                   else 1)
        assert fresh.step == want_step, flags
        if kind is None:
            assert got == (1, 0, None)
            continue
        assert got[2] == path(kind) and got[1] == (3 if want_step == 3
                                                   else 1)
        assert log.best_score == (0.5 if want_step == 3 else 0.25)
        log.close()


# --------------------------------------------- test driver, JAX reader

def test_test_driver_walks_both_formats(tmp_path):
    """A JAX pickle and a torch file of the same weights: the walk scores
    both, to the same metrics."""
    argv = CONFIG2 + ["--dir-result", str(tmp_path), "--seed", "0"]
    cfg, jcfg = parse_config(argv), jax_parse(argv)
    batches = _batches(cfg, 3)
    for i, b in enumerate(batches):
        b["target"][:] = [1, 0, i % 2, 0]
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batches[0])
        jpath = checkpoints.ckpt_path(str(tmp_path), "small1", "best", 0, 0)
        jax_ckpt.save_checkpoint(jpath, jt.state, 0.5, 1)
        variables = jax.device_get({"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
    finally:
        jax_ops.configure(False)
    model = get_model(cfg)
    model.load_state_dict(from_jax_variables(cfg, variables))
    tpath = checkpoints.ckpt_path(str(tmp_path), "small1", "last", 0, 0)
    checkpoints.save_checkpoint(tpath, Trainer(cfg, model, "cpu"), 0.5, 1)
    assert not checkpoints.is_torch_file(jpath)
    assert checkpoints.is_torch_file(tpath)
    assert checkpoints.load_checkpoint(jpath)["format"] == "jax"
    paths = test_driver.checkpoints_of(cfg.replace(last=True))
    assert paths == [jpath, tpath]
    out = test_driver.run_checkpoints(cfg, paths, BatchList(batches),
                                      device="cpu")
    assert [p for p, _ in out] == paths
    (_, a), (_, b) = out
    assert a == b and np.isfinite(a["auc"])
    assert test_driver.checkpoints_of(cfg) == [jpath]


def _optax_forms():
    sched = optax.constant_schedule(1e-3)
    for kind in ("adamw", "adam", "sgd"):
        for lars in (False, True):
            for masked in (False, True):
                tx = {"adamw": optax.adamw(sched, weight_decay=1e-2),
                      "adam": optax.adam(sched),
                      "sgd": optax.sgd(sched, momentum=0.9)}[kind]
                if lars:
                    tx = optax.chain(optax.scale_by_trust_ratio(), tx)
                if masked:
                    tx = optax.masked(tx, lambda p: {"a": True, "b": False})
                yield kind, lars, masked, tx


def _same_tree(got, want):
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__
        assert getattr(got, "_fields", None) == getattr(want, "_fields",
                                                        None)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same_tree(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).dtype == np.asarray(want).dtype


def test_jax_reader_knows_every_optim_form():
    """The optax state of each --optim form (adamw, adam, sgd, each with
    _lars, each masked or not), pickled as the JAX package pickles it,
    reads back through the stand-ins with the same classes, fields and
    arrays; an unknown class is refused by name."""
    params = {"a": np.ones((2, 3), np.float32),
              "b": np.arange(3, dtype=np.float32)}
    for kind, lars, masked, tx in _optax_forms():
        state = jax.tree.map(np.asarray, tx.init(params))
        blob = pickle.dumps({"optimizer": state}, pickle.HIGHEST_PROTOCOL)
        got = checkpoints.JaxCheckpointUnpickler(io.BytesIO(blob)).load()
        _same_tree(got["optimizer"], state)
    blob = pickle.dumps(collections.OrderedDict(a=1))
    with pytest.raises(pickle.UnpicklingError, match="OrderedDict"):
        checkpoints.JaxCheckpointUnpickler(io.BytesIO(blob)).load()


# --------------------------------------------------------------- flags

REFUSED = {
    "orbax": (["--ckpt-backend", "orbax"], "orbax"),
    "dp": (["--dp-size", "2"], "--dp-size"),
    "multi_k": (["--train-multi-k", "2"], "--train-multi-k 2"),
}


@pytest.mark.parametrize("name", list(REFUSED))
@pytest.mark.parametrize("driver", ["train", "test"])
def test_refused_flags_raise_by_name(tmp_path, name, driver):
    flags, match = REFUSED[name]
    argv = CONFIG2 + ["--dir-result", str(tmp_path)] + flags
    main = (train_driver if driver == "train" else test_driver).main
    if driver == "test" and name == "multi_k":
        # the test driver reads no --train-multi-k: it goes on to the walk
        with pytest.raises(SystemExit):
            main(argv, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=match):
        main(argv, device="cpu")


# the flags of tensor parallelism, which the drivers take: --mp-size 2 in
# two ranks joined through the launcher's environment, and the same with
# --dist-coordinator, --dist-num-processes and --dist-process-id given
ACCEPTED = {"mp": "0", "dist": "1"}
# a two-layer config-2 model whose four heads split over the two ranks
TP_FLAGS = ["--mp-size", "2", "--dp-size", "1", "--transformer-num-head",
            "4"]
TESTS = Path(__file__).resolve().parent
# a walk of the same checkpoints by two ranks and by one process: the
# ranks' sums split over the model group (tests/test_torch_tp.py's bound)
TP_WALK_TOL = 1e-5


@pytest.fixture(scope="module")
def single_run(tmp_path_factory):
    """The synthetic fixtures (vslt + BioBERT notes), and one epoch of the
    single-process train driver over them with its test driver's walk, run
    from the fixture's own directory (the eval index caches go to
    ./data/testIndexes, and the test driver reads the one the train
    driver built): (argv without --dir-result, that directory, train
    result, walk result)."""
    from tools.make_synthetic_fixtures import main as make
    root = tmp_path_factory.mktemp("single")
    synth = root / "synth"
    make(["--out", str(synth), "--n-train", "12", "--n-test", "6",
          "--seed", "3"])
    argv = CONFIG2 + [
        "--train-data-path", f"{synth}/train",
        "--test-data-path", f"{synth}/test",
        "--biobert-path", f"{synth}/mimic4_embeddings.h5",
        "--dir-root", str(synth), "--num-workers", "1", "--epochs", "1",
        "--seed-list", "412", "--transformer-num-head", "4"]
    one = argv + ["--dir-result", str(root / "res")]
    from tp_drivers_worker import record_probs
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    cwd, add, threads = os.getcwd(), Evaluator.add_batch, torch.get_num_threads()
    os.chdir(root)
    torch.set_num_threads(1)    # as the ranks
    try:
        probs = record_probs()
        trained = train_driver.main(one, device="cpu")
        n_train = len(probs)
        walked = test_driver.main(one, device="cpu")
    finally:
        os.chdir(cwd)
        Evaluator.add_batch = add
        torch.set_num_threads(threads)
    return (argv, root, (trained, probs[:n_train]),
            (walked, probs[n_train:]))


def _agg_close(got, want, tol=1e-4):
    """Two aggregates ({metric: (mean, std)}, tuples or JSON lists) within
    ``tol``, nan equal to nan."""
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), rtol=0,
                                   atol=tol, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("name", list(ACCEPTED))
@pytest.mark.parametrize("driver", ["train", "test"])
def test_tp_flags_are_taken_and_run(tmp_path, single_run, name, driver):
    """--mp-size 2 --dp-size 1 (from the launcher's environment, or with
    the --dist-* flags): each driver's ``main`` runs in two gloo ranks.
    The test driver walks the single process's checkpoints to its
    probabilities (every sample the metrics read) within TP_WALK_TOL, and
    to its aggregates where no two probabilities lie within that bound of
    each other or of an F1 threshold (near-tied probabilities can swap
    order). The train driver logs the single process's losses at the same
    steps and gives finite aggregates of the same metrics: two ``main``
    runs need not see the same batches, since the loader's worker threads
    draw items from one shared RNG (ROADMAP Queue 3; tests/
    test_torch_tp_drivers.py holds a fold over fixed batches to the single
    process's)."""
    import shutil
    from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
    argv, root, trained, walked = single_run
    # the ranks start in this test's directory: the single run's index
    # caches there, and its checkpoints for the test driver
    shutil.copytree(root / "data", tmp_path / "data", dirs_exist_ok=True)
    out = tmp_path / "out"
    out.mkdir()
    run = tmp_path / "res"
    if driver == "test":
        shutil.copytree(root / "res", run)
    (out / "argv.json").write_text(json.dumps(
        argv + TP_FLAGS + ["--dir-result", str(run)]))
    launch("tp_drivers_worker:run_driver", 2,
           f"file://{tmp_path / 'rendezvous'}",
           [str(out), driver, ACCEPTED[name]], pythonpath=[str(TESTS)],
           timeout=240, capture=True)
    got = json.loads((out / "results.json").read_text())
    want, probs = trained if driver == "train" else walked
    if driver == "train":
        assert _losses(run).keys() == _losses(root / "res").keys()
        assert len(got["probs"]) == len(probs)
        for g, w in zip(got["result"], want):
            assert set(g) == set(w)
            assert all(np.isfinite(g[k]).all() for k in g if k != "auc")
        return
    np.testing.assert_allclose(got["probs"], probs, rtol=0,
                               atol=TP_WALK_TOL)
    if _well_separated(probs, TP_WALK_TOL):
        _agg_close(got["result"], want)


def _well_separated(probs, tol=1e-4) -> bool:
    """No two probabilities, and none and a threshold of the F1 sweep
    (0.01 .. 0.99), within tol."""
    p = np.sort(np.concatenate([np.asarray(probs, float),
                                np.arange(1, 100) / 100]))
    return bool(np.all(np.diff(p) > tol))


def _losses(res):
    """The train and validation losses a run logged, by (tag, step)."""
    events = next(Path(res).glob("*/logs_0/events.jsonl")).read_text()
    rows = [json.loads(line) for line in events.splitlines()]
    return {(r["tag"], r["step"]): r["value"] for r in rows
            if r["tag"] in ("train/loss", "val/loss")}


def test_orbax_checkpoints_are_refused_by_name(tmp_path):
    path = str(tmp_path / "best_fold0_seed0.pth")
    os.makedirs(path + ".orbax")
    assert checkpoints.ckpt_exists(path)
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoints.load_checkpoint_any("pickle", path)
    with pytest.raises(NotImplementedError, match="orbax"):
        Logger(parse_config(CONFIG2 + ["--dir-result", str(tmp_path),
                                       "--ckpt-backend", "orbax"])
               ).save(None, 1, 1)


def test_drivers_need_cuda_unless_given_the_cpu(tmp_path):
    """No GPU here: the drivers raise rather than run on the CPU."""
    argv = CONFIG2 + ["--dir-result", str(tmp_path)]
    for main in (train_driver.main, test_driver.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def _fold(tmp_path, flags, n_train=3):
    cfg = parse_config(CONFIG2 + ["--dir-result", str(tmp_path),
                                  "--epochs", "1", "--img-pack-frac", "0.5"]
                       + flags)
    loaders = [BatchList(_batches(cfg, n, seed=s))
               for n, s in ((n_train, 10), (1, 20), (1, 30))]
    for b in loaders[1].batches + loaders[2].batches:
        b["target"][:] = [1, 0, 1, 0]
    return train_driver.run_fold(cfg, 0, *loaders, device="cpu")


def test_honoured_flags_multi_k_profile_dir_debug_nans(tmp_path,
                                                       monkeypatch):
    """--train-multi-k 0 runs one step per batch; --profile-dir writes a
    torch.profiler trace of the steps; --debug-nans raises on a
    non-finite train loss, which a run without it logs and goes past."""
    prof = train_driver.StepProfiler(str(tmp_path / "prof"),
                                     torch.device("cpu"))
    cfg = parse_config(CONFIG2 + ["--dir-result", str(tmp_path),
                                  "--epochs", "1", "--train-multi-k", "0",
                                  "--img-pack-frac", "0.5"])
    loaders = [BatchList(_batches(cfg, n, seed=s))
               for n, s in ((2, 10), (1, 20), (1, 30))]
    val, test = train_driver.run_fold(cfg, 0, *loaders, device="cpu",
                                      profiler=prof)
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert val is not None and test is not None
    monkeypatch.setattr(Trainer, "train_step", lambda self, b: float("nan"))
    with pytest.raises(FloatingPointError, match="debug-nans"):
        _fold(tmp_path / "a", ["--debug-nans", "1"])
    _fold(tmp_path / "b", [])


# ------------------------------------------------------------ end to end

def test_config4_run_trains_validates_saves_and_tests(tmp_path,
                                                      monkeypatch):
    """The train driver over the synthetic fixtures (vslt + CXR + BioBERT
    notes, full Swin-T, 2 MBT layers at d 64, uint8 image wire, auto pack
    fraction, note table), one epoch: finite train losses, a validation
    block, last and best saved; the test driver scores best to the train
    driver's final test metrics."""
    from tools.make_synthetic_fixtures import main as make
    synth = tmp_path / "synth"
    make(["--out", str(synth), "--n-train", "12", "--n-test", "6",
          "--seed", "3"])
    argv = CONFIG4 + [
        "--train-data-path", f"{synth}/train",
        "--test-data-path", f"{synth}/test",
        "--image-data-path", f"{synth}/images/",
        "--biobert-path", f"{synth}/mimic4_embeddings.h5",
        "--dir-root", str(synth), "--num-workers", "1", "--epochs", "1",
        "--seed-list", "412", "--dir-result", str(tmp_path / "res"),
        "--checkpoint-every", "2", "--log-iter", "1"]
    _val, test = train_driver.main(argv, device="cpu")
    root = tmp_path / "res" / "small1"
    assert (root / "settings.txt").exists()
    events = (root / "logs_0" / "events.jsonl").read_text()
    assert events.count('"train/loss"') == 5 and '"val/loss"' in events
    for kind in ("best", "last"):
        assert (root / "ckpts" / f"{kind}_fold0_seed412.pth").exists()
    assert test_driver.main(argv, device="cpu") == test


def test_vmulti_fold_through_both_drivers(tmp_path):
    """tri_mbt_vmulti (the [4, B] logits, the selected output) through the
    train driver's fold on the CPU (1 epoch of 2 train, 1 val and 1 test
    batch; full Swin-T, 2 layers at d 64): finite losses, a validation
    block, last and best saved; the test driver scores best to the train
    driver's final test metrics."""
    cfg = parse_config(CONFIG4 + ["--model", "tri_mbt_vmulti",
                                  "--dir-result", str(tmp_path),
                                  "--epochs", "1", "--log-iter", "1",
                                  "--img-pack-frac", "0.5"])
    loaders = [BatchList(_batches(cfg, n, seed=s))
               for n, s in ((2, 10), (1, 20), (1, 30))]
    for b in loaders[1].batches + loaders[2].batches:
        b["target"][:] = [1, 0, 1, 0]
    val, test = train_driver.run_fold(cfg, 0, *loaders, device="cpu")
    assert val is not None and np.isfinite(test["auc"])
    root = tmp_path / cfg.project_name
    events = (root / "logs_0" / "events.jsonl").read_text()
    assert events.count('"train/loss"') == 2 and '"val/loss"' in events
    best = checkpoints.ckpt_path(str(tmp_path), cfg.project_name, "best", 0,
                                 cfg.seed)
    walked = test_driver.run_checkpoints(cfg, test_driver.checkpoints_of(cfg),
                                         loaders[2], device="cpu")
    assert dict(walked)[best] == test
