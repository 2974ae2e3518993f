"""``--model-types classification`` in the port against the JAX package
on the CPU, for the five ``--loss-types`` (softmax, bces, bceandsoftmax,
rmse and the default bce): ``compute_loss`` on seeded logits and targets
(1e-6, relative 1e-6); the eval step (the probabilities, sigmoid of the
logits, and the loss, 1e-5) and one train step (loss 1e-5, or
TRAIN_LOSS_TOL; parameters and Adam moments at compare_train_state's
bounds; batch 16, STEP_B) of tri_mbt_vsltcls on vslt+txt from the
same perturbed weights; the port's loader copy against the JAX package's
in classification mode (the hour-bucket targets, key by key), and
``data/synthetic.py``'s classification targets in the loader's layout;
then a run per loss through the train driver's fold (two train steps,
validation, the test of the best checkpoint) and the test driver's walk
to the same test metrics, and ``drivers.train.main`` over the fixtures'
files, as tests/test_classification.py drives the JAX package. Small
width: 2 layers, d 64, 2 heads, TIE-len 64, batch 4, fp32."""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
    BatchList, synthetic_batch)
from medical_tri_modal_pilot_tpu_torch.drivers import test as test_driver
from medical_tri_modal_pilot_tpu_torch.drivers import train as train_driver
from medical_tri_modal_pilot_tpu_torch.train import checkpoints, trainer
from test_torch_data import SIDES, _loaders, _same_batches
from test_torch_variants import B, SMALL, check_model

# the train step: batch 16. The head's BatchNorm normalises fc1's outputs
# by their variance over the batch (E[h^2] - E[h]^2, as flax computes
# it), which over 4 samples is small on some features and puts both
# sides' fp32 train-mode logits well off a float64 head on the same
# inputs (the detection steps' too), more than a loss over 12 outputs
# per sample carries within 1e-5. The loss within 1e-5, but the default
# bce against hour-bucket indices (targets up to 11 scale the logits'
# rounding by as much): 1e-4.
STEP_B = 16
TRAIN_LOSS_TOL = {"bce": 1e-4}
# the output widths the JAX package's test runs each loss at
# (tests/test_classification.py): 12 hour buckets, one time to the event
LOSSES = {"softmax": 12, "bces": 12, "bceandsoftmax": 12, "rmse": 1,
          "bce": 1}


def _argv(loss, *extra):
    return SMALL + ["--model", "tri_mbt_vsltcls", "--input-types",
                    "vslt_txt", "--model-types", "classification",
                    "--loss-types", loss, "--output-dim",
                    str(LOSSES[loss])] + list(extra)


@pytest.mark.parametrize("loss", list(LOSSES))
def test_classification_loss_matches_jax(loss):
    """compute_loss on seeded logits [B, 12] (or [B]) and the targets of
    that loss, as the loader ships them, within 1e-6 (relative where the
    loss is large: bce against a bucket index runs to ~6)."""
    cfg = parse_config(_argv(loss))
    rng = np.random.default_rng(2)
    n = 6
    shape = (n, LOSSES[loss]) if LOSSES[loss] > 1 else (n,)
    logits = rng.normal(0, 2, shape).astype(np.float32)
    b = synthetic_batch(cfg, n, seed=4)
    want = jax_trainer.compute_loss(cfg, logits, None, b["target"],
                                    b["target_aux"], b["missing"],
                                    np.zeros(n, np.int32))
    got = trainer.compute_loss(cfg, torch.from_numpy(logits), None,
                               torch.from_numpy(b["target"]),
                               torch.from_numpy(b["target_aux"]))
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("loss", list(LOSSES))
def test_classification_steps_match_jax(loss):
    """The eval step (sigmoid probabilities [B, 12] or [B], the loss of
    the whole output) and one train step, from the same weights."""
    argv = _argv(loss, "--batch-size", str(STEP_B))
    check_model(argv, synthetic_batch(parse_config(argv), STEP_B, seed=3),
                train_loss_tol=TRAIN_LOSS_TOL.get(loss, 1e-5))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """tests/test_classification.py's fixtures: 24 train and 12 test
    stays, seed 5 (vasso windows enough for a batch)."""
    out = tmp_path_factory.mktemp("synth_cls")
    from tools.make_synthetic_fixtures import main as make
    make(["--out", str(out), "--n-train", "24", "--n-test", "12",
          "--seed", "5"])
    return str(out)


def _fixture_argv(synth, loss):
    return ["--train-data-path", f"{synth}/train",
            "--test-data-path", f"{synth}/test",
            "--image-data-path", f"{synth}/images/",
            "--biobert-path", f"{synth}/mimic4_embeddings.h5",
            "--dir-root", synth, "--input-types", "vslt",
            "--output-type", "vasso", "--model-types", "classification",
            "--loss-types", loss, "--output-dim", str(LOSSES[loss]),
            "--modality-inclusion", "train-missing_test-missing",
            "--model", "unimodal_transformer", "--batch-size", str(B),
            "--num-workers", "1", "--TIE-len", "64", "--seed-list", "412",
            "--transformer-num-layers", "2", "--transformer-dim", "64",
            "--transformer-num-head", "2", "--precision", "fp32"]


@pytest.mark.parametrize("loss", ["bces", "bceandsoftmax", "rmse"])
def test_loader_and_synthetic_targets(synth, tmp_path, monkeypatch, loss):
    """The port's loader gives the JAX loader's classification batches
    (thread workers), and synthetic_batch's target and target_aux have
    their dtypes and shapes: the one-hot [B, 12] of bces, the bucket and
    its one-hot in target_aux for bceandsoftmax, a time for rmse."""
    argv = _fixture_argv(synth, loss)
    sides = {s: _loaders(s, argv, tmp_path / s, monkeypatch) for s in SIDES}
    for i, name in ((1, "train"), (3, "test")):
        _same_batches(sides["jax"][i], sides["port"][i], name)
    assert len(sides["jax"][2]) == len(sides["port"][2])
    real = next(iter(sides["port"][3]))
    fake = synthetic_batch(sides["port"][0], B, seed=1)
    for k in ("target", "target_aux"):
        assert fake[k].dtype == real[k].dtype and \
            fake[k].shape == real[k].shape, k
    if loss == "bceandsoftmax":
        np.testing.assert_array_equal(
            fake["target_aux"].argmax(1), fake["target"])


@pytest.mark.parametrize("loss", list(LOSSES))
def test_classification_driver_run(tmp_path, monkeypatch, loss):
    """One epoch of two train batches, one val and one test batch through
    drivers.train.run_fold: finite losses and metrics, the best
    checkpoint written; the test driver's walk gives its test metrics."""
    monkeypatch.chdir(tmp_path)
    cfg = parse_config(_argv(loss, "--epochs", "1", "--img-pack-frac", "0.5",
                             "--dir-result",
                             str(tmp_path / "res"), "--project-name", loss))
    loaders = [BatchList([synthetic_batch(cfg, B, seed=s) for s in seeds])
               for seeds in ((3, 4), (5,), (6,))]
    val, test = train_driver.run_fold(cfg, 0, *loaders, device="cpu")
    assert test is not None and np.isfinite(test["f1"])
    best = checkpoints.ckpt_path(str(tmp_path / "res"), loss, "best", 0,
                                 cfg.seed)
    walked = dict(test_driver.run_checkpoints(
        cfg, test_driver.checkpoints_of(cfg), loaders[2], device="cpu"))
    assert walked[best] == test


def test_classification_main_over_the_fixtures(synth, tmp_path,
                                               monkeypatch):
    """drivers.train.main and drivers.test.main over the fixtures' files
    (--loss-types bceandsoftmax, unimodal_transformer on vslt, as the JAX
    package's test): finite aggregates."""
    monkeypatch.chdir(tmp_path)
    argv = _fixture_argv(synth, "bceandsoftmax") + [
        "--epochs", "1", "--dir-result", str(tmp_path / "res")]
    _, trained = train_driver.main(argv, device="cpu")
    walked = test_driver.main(argv, device="cpu")
    for agg in (trained, walked):
        assert agg and np.isfinite(np.asarray(agg["f1"], float)).all()


def test_jax_parse_agrees():
    """The port's Config of the classification flags is the JAX
    package's, field for field (the loss and output width the steps
    read)."""
    for loss in LOSSES:
        a, b = parse_config(_argv(loss)), jax_parse(_argv(loss))
        assert (a.model_types, a.loss_types, a.output_dim) == \
            (b.model_types, b.loss_types, b.output_dim)
