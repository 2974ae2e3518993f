"""Data parallelism of the port (--dp-size 2, and 2 x 2 with --mp-size 2)
on the CPU, in ranks started by parallel.launch over gloo (rank bodies in
tests/dp_worker.py, which imports no jax): the mesh layout against the JAX
package's ``make_mesh``; two ranks against the JAX Trainer at --dp-size 2
(a 2-device mesh of the 8 CPU devices, plain XLA); two ranks against the
port's single process on the same global batches at --dropout 0.1 for
every loss form, BatchNorm and draw site (one launch runs them all); a
global batch whose second half holds no image; four ranks at dp 2 x mp 2;
the drivers under --dp-size 2; the dropout masks' row offset; what stays
refused. fp32 throughout; each check states its tolerance."""
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.parallel import mesh as jax_mesh
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import (BatchList,
                                                          synthetic_batch)
from medical_tri_modal_pilot_tpu_torch.drivers import common
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import plain_dropout_masks
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import (
    from_jax_variables)
from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
from medical_tri_modal_pilot_tpu_torch.parallel.mesh import (
    Mesh, group_ranks, mesh_shape)
from medical_tri_modal_pilot_tpu_torch.train import trainer as port_trainer
from dp_worker import execute, narrow_trunk
from test_torch_drivers import CONFIG2, _losses, _well_separated
from test_torch_swin_train import NARROW
from test_torch_tp_drivers import FOLD, TP_RUN_TOL, _files, _fold_batches
from test_torch_train import _close_to_tensor_max, compare_train_state
from tp_drivers_worker import fold_resume_walk, record_probs

TESTS = Path(__file__).resolve().parent
B = 8
SMALL = ["--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--transformer-num-layers", "2",
         "--transformer-dim", "64", "--transformer-num-head", "4",
         "--precision", "fp32"]
TIE = ["--vslt-type", "TIE", "--TIE-len", "40", "--imgtxt-time", "1"]
DP = ["--dp-size", "2"]


# SGD with momentum: a parameter moves by lr times its gradient, so two
# ways of summing the batch give the same state to rounding (Adam's
# normalisation turns a gradient of rounding size into a step of lr either
# way; test_dp_matches_jax holds adamw to compare_train_state's bounds)
SGD = ["--optim", "sgd", "--momentum", "0.9"]


def _mbt(model, inputs, *extra):
    return SMALL + TIE + DP + SGD + ["--model", model, "--input-types",
                                     inputs, "--dropout", "0.1", *extra]


# the configurations two ranks run against one process: name -> (argv,
# Config fields the command line does not set, the reduced Swin-T or None)
RUNS = {
    # the BatchNorm head, input dropout and the ffn's in-kernel dropout
    "vsltcls": (_mbt("tri_mbt_vsltcls", "vslt_txt"), {}, None),
    # _heads_loss over [4, B] and the frozen trunk packed per shard
    "vmulti": (_mbt("tri_mbt_vmulti", "vslt_img_txt"), {}, NARROW),
    "vnoshnoavgtr": (_mbt("tri_mbt_vnoshnoavgtr", "vslt_img_txt"), {},
                     NARROW),
    "aux_rmse": (_mbt("tri_mbt_vsltcls", "vslt_txt",
                      "--auxiliary-loss-type", "rmse"), {}, None),
    "cls_softmax": (_mbt("tri_mbt_vsltcls", "vslt_txt", "--model-types",
                         "classification", "--loss-types", "softmax",
                         "--output-dim", "12"), {},
                    None),
    "cls_rmse": (_mbt("tri_mbt_vsltcls", "vslt_txt", "--model-types",
                      "classification", "--loss-types", "rmse"), {}, None),
    # the cpc softmax over the gathered keys, brl_bn over [B, T, F]
    "auxcpc_cpcWbrl": (SMALL + DP + SGD + [
        "--model", "auxcpc_mbt", "--input-types", "vslt_txt",
        "--vslt-type", "carryforward", "--dropout", "0.1",
        "--auxiliary-loss-input", "directInput"],
        {"auxiliary_loss_type": "cpcWbrl"}, None),
    # the convolutions' BatchNorms
    "resnet18": (SMALL + DP + SGD + [
        "--model", "resnet", "--input-types", "vslt_img", "--vslt-type",
        "carryforward", "--img-model-type", "resnet18", "--dropout", "0.1"],
        {"image_size": 64}, None),
    # a trainable trunk's stochastic depth
    "v2": (_mbt("tri_mbt_v2", "vslt_img_txt"), {}, NARROW),
}
# the global batch whose second half holds no image (the second rank's
# shard has none)
NO_IMAGE = "half_without_images"
# dp 2 against one process: the same math, the sums over the batch split
# in two and added (under SGD measured at most 2.4e-7 on the losses and
# the probabilities, 1.2e-7 on the parameters)
LOSS_TOL = 1e-5
PROB_TOL = 1e-5
STATE_RTOL = 1e-5
# the momentum buffers hold the gradients, whose sums over the batch run
# in another order (a convolution's weight gradient 1.1e-5 of its largest
# entry) and where the true gradient is zero (a bias the BatchNorm
# cancels) hold rounding noise of the model's gradient scale (2.2e-7)
GRAD_RTOL = 1e-4
GRAD_FLOOR = 1e-6


def _perturbed_init(cfg, trunk, seed: int):
    """The model's initial state with every floating parameter moved by
    0.02 of a seeded normal draw (zero-initialised weights, as the
    auxcpc ct_weight, then carry a gradient from the first step)."""
    with narrow_trunk(trunk):
        model = get_model(cfg)
    g = torch.Generator().manual_seed(seed)
    params = {n for n, _ in model.named_parameters()}
    return {k: (v + 0.02 * torch.randn(v.shape, generator=g)
                if k in params else v.clone())
            for k, v in model.state_dict().items()}


def _batches(cfg, no_image_half: bool = False):
    out = [synthetic_batch(cfg, B, seed=s) for s in (5, 6, 7)]
    if no_image_half:
        for b in out:
            b["missing"][:, 1] = [0, 1, 0, 0, 1, 1, 1, 1]
            b["img"][B // 2:] = 0.0
    return out[:2], out[2]


def _run(name, argv, replace, trunk, seed, no_image_half=False):
    cfg = parse_config(argv).replace(**replace)
    batches, eval_batch = _batches(cfg, no_image_half)
    return {"name": name, "argv": argv, "replace": replace, "trunk": trunk,
            "init": _perturbed_init(cfg, trunk, seed), "batches": batches,
            "eval": eval_batch}


def _single(run):
    """The run in one process (no data parallelism)."""
    return execute(dict(run, replace=dict(run["replace"], dp_size=0,
                                          mp_size=0)))


def _launch(tmp_path, nproc, runs):
    torch.save(runs, tmp_path / "runs.pt")
    launch("dp_worker:runs", nproc, f"file://{tmp_path / 'rendezvous'}",
           [str(tmp_path)], pythonpath=[str(TESTS)], timeout=400,
           capture=True)
    got = torch.load(tmp_path / "dp.pt", weights_only=False)
    states = [torch.load(tmp_path / f"state{r}.pt", weights_only=False)
              for r in range(nproc)]
    return got, states


def _ranks_agree(states, name):
    """Every rank ends the run with the same whole state, bit for bit
    (the data ranks take the same step; the model ranks' gathers)."""
    first = states[0][name]
    for other in states[1:]:
        for k, v in first["model"].items():
            assert torch.equal(v, other[name]["model"][k]), (name, k)
        for i, st in first["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                    other[name]["optimizer"]["state"][i][k])), (name, k)


def _compare_state(got, want, what):
    """A dp run's whole state against the single process's: every
    parameter and BatchNorm statistic within STATE_RTOL of its tensor's
    largest entry (plus 1e-7), every momentum buffer within GRAD_RTOL
    (plus GRAD_FLOOR), the step counts equal."""
    g_sd, w_sd = got["model"], want["model"]
    assert g_sd.keys() == w_sd.keys()
    for name, w in w_sd.items():
        if w.is_floating_point():
            _close_to_tensor_max(g_sd[name].numpy(), w.numpy(), STATE_RTOL,
                                 1e-7, f"{what} {name}")
        else:
            assert torch.equal(g_sd[name], w), name
    g_opt, w_opt = got["optimizer"]["state"], want["optimizer"]["state"]
    assert g_opt.keys() == w_opt.keys() and w_opt
    for i, st in w_opt.items():
        for key, v in st.items():
            _close_to_tensor_max(g_opt[i][key].numpy(), v.numpy(),
                                 GRAD_RTOL, GRAD_FLOOR, f"{what} {key} {i}")


def _check_against_single(got, want, what):
    """Losses (LOSS_TOL of the larger of 1 and the loss), the eval
    probabilities before and after the steps in sample order (PROB_TOL),
    the eval loss and rmse, the state (_compare_state)."""
    scale = np.maximum(1.0, np.abs(want["losses"]))
    assert np.all(np.abs(np.subtract(got["losses"], want["losses"]))
                  <= LOSS_TOL * scale), (got["losses"], want["losses"])
    for key in ("probs0", "probs"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=PROB_TOL, err_msg=f"{what} {key}")
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], abs=LOSS_TOL)
    if want["eval_rmse"] is None:
        assert got["eval_rmse"] is None
    else:
        assert got["eval_rmse"] == pytest.approx(want["eval_rmse"],
                                                 abs=LOSS_TOL)
    _compare_state(got, want, what)


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("dp,mp", [(2, 1), (4, 1), (2, 2)])
def test_mesh_layout_matches_jax(dp, mp):
    """The port's model groups (consecutive ranks) and data groups (one
    model index each) are the rows and columns of the JAX package's
    (data, model) device array, device i standing for rank i."""
    jm = jax_mesh.make_mesh(dp, dp, mp)
    ids = np.vectorize(lambda d: d.id)(jm.devices).reshape(dp, mp)
    model, data = group_ranks(dp, mp)
    assert model == [list(row) for row in ids]
    assert data == [list(col) for col in ids.T]
    assert mesh_shape(0, 2 * dp, mp, dp * mp) == (dp, mp)
    for rank in range(dp * mp):
        m = Mesh(dp, mp, rank)
        assert rank in model[m.data_index] and rank in data[m.model_index]


# ------------------------------------------------------- one launch: dp 2

JAX_ARGV = SMALL + TIE + DP + ["--model", "tri_mbt_vsltcls", "--input-types",
                               "vslt_txt", "--dropout", "0"]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Two gloo ranks over every run (RUNS, NO_IMAGE and the JAX-weighted
    one) in one launch; meanwhile in this process the JAX Trainer at
    --dp-size 2 and every run at dp 1. Returns (ranks' results, their
    states, single-process results, the JAX run's (Trainer, losses,
    probabilities))."""
    tmp = tmp_path_factory.mktemp("dp")
    runs = [_run(name, *spec, seed=i)
            for i, (name, spec) in enumerate(RUNS.items())]
    runs.append(_run(NO_IMAGE, _mbt("tri_mbt_vsltcls", "vslt_img_txt"), {},
                     NARROW, seed=20, no_image_half=True))
    cfg = parse_config(JAX_ARGV)
    jcfg = jax_parse(JAX_ARGV + ["--use-pallas", "0"])
    # both steps on one batch (as tests/test_torch_tp.py: a second batch
    # reads Adam's noise-driven elements at first order)
    batch = synthetic_batch(cfg, B, seed=3)
    jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batch)
    jprobs, _, _ = jt.eval_step(batch)
    variables = jax.device_get({"params": jt.state.params,
                                "batch_stats": jt.state.batch_stats})
    runs.append({"name": "jax", "argv": JAX_ARGV, "replace": {},
                 "trunk": None, "init": from_jax_variables(cfg, variables),
                 "batches": [batch, batch], "eval": batch})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # as the ranks
    errors = []

    def ranks():
        try:
            errors.append(_launch(tmp, 2, runs))
        except Exception as e:   # re-raised below, in the test's thread
            errors.append(e)
    thread = threading.Thread(target=ranks)
    thread.start()
    try:
        assert dict(jt.mesh.shape) == {"data": 2}
        jlosses = [float(jt.train_step(b)) for b in (batch, batch)]
        single = {}
        for run in runs[:-1]:
            single[run["name"]] = _single(run)
    finally:
        thread.join()
        torch.set_num_threads(threads)
    if isinstance(errors[0], Exception):
        raise errors[0]
    got, states = errors[0]
    return got, states, single, (jt, jlosses, np.asarray(jprobs))


def test_dp_matches_jax(dp_runs):
    """Two ranks at --dp-size 2 against the JAX Trainer at --dp-size 2
    (--use-pallas 0) from the same weights, dropout 0, two steps on one
    batch: losses and eval probabilities (1e-5), parameters, Adam moments
    and the BatchNorm head's statistics (compare_train_state)."""
    got, _, _, (jt, jlosses, jprobs) = dp_runs
    res = got["jax"]
    np.testing.assert_allclose(res["losses"], jlosses, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res["probs0"], jprobs, rtol=0, atol=1e-5)
    cfg = parse_config(JAX_ARGV).replace(dp_size=0)
    tr = port_trainer.Trainer(cfg, get_model(cfg), "cpu", eval_only=False)
    tr.load_state_dicts(res["model"], res["optimizer"])
    compare_train_state(cfg, jt, tr, res["lr_sum"])


@pytest.mark.parametrize("name", list(RUNS) + [NO_IMAGE])
def test_dp_matches_single_process(dp_runs, name):
    """Two ranks against one process on the same global batches from the
    same weights at --dropout 0.1 (the masks are the single process's
    rows, DropoutSeeds.row0): two losses and the eval loss (1e-5), the eval
    probabilities in sample order (1e-5), the state after the steps
    (_compare_state); every rank ends with the same state, bit for bit.
    NO_IMAGE: the second rank's shard holds no image."""
    got, states, single, _ = dp_runs
    _check_against_single(got[name], single[name], name)
    _ranks_agree(states, name)


# ------------------------------------------------------------- dp 2 x mp 2

def test_dp_mp_matches_single_process(tmp_path):
    """Four ranks at --dp-size 2 --mp-size 2 (two model groups of two, each
    on half the batch) against one process at --dropout 0.1: one step's
    loss and the eval after it (1e-5), the gathered state (_compare_state);
    every rank ends with the same whole state."""
    argv = _mbt("tri_mbt_vsltcls", "vslt_txt", "--mp-size", "2")
    run = _run("dp_mp", argv, {}, None, seed=30)
    run["batches"] = run["batches"][:1]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = _single(run)
        got, states = _launch(tmp_path, 4, [run])
    finally:
        torch.set_num_threads(threads)
    _check_against_single(got["dp_mp"], want, "dp_mp")
    _ranks_agree(states, "dp_mp")


# ----------------------------------------------------------------- drivers

def test_drivers_under_dp_match_one_process(tmp_path, monkeypatch):
    """The drivers' bodies in two ranks at --dp-size 2 (train with a step
    save and the epoch save, --resume last, the test driver's walk) over
    fixed batches, against the single process: every probability the
    metrics read and every logged loss within TP_RUN_TOL (the fold's
    eight Adam steps, tests/test_torch_tp_drivers.py), the aggregates
    where the probabilities lie well apart, the same files (process 1
    writes nothing: its guard would fail the launch)."""
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    monkeypatch.setattr(Evaluator, "add_batch", Evaluator.add_batch)
    probs = record_probs()
    argv = CONFIG2 + ["--epochs", "1", "--checkpoint-every", "2",
                      "--img-pack-frac", "0.5", "--log-iter", "1",
                      "--transformer-num-head", "4"]
    single = tmp_path / "single"
    cfg = parse_config(argv + ["--dir-result", str(single)])
    batches = _fold_batches(cfg)
    loaders = lambda: [BatchList(b) for b in batches]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = fold_resume_walk(cfg, loaders, "cpu")
        dp = tmp_path / "dp"
        out = tmp_path / "out"
        out.mkdir()
        (out / "argv.json").write_text(json.dumps(
            argv + DP + ["--dir-result", str(dp)]))
        torch.save(batches, out / "batches.pt")
        launch("tp_drivers_worker:fold", 2,
               f"file://{tmp_path / 'rendezvous'}", [str(out)],
               pythonpath=[str(TESTS)], timeout=300, capture=True)
    finally:
        torch.set_num_threads(threads)
    got = json.loads((out / "results.json").read_text())
    assert len(got["probs"]) == len(probs) > 0
    np.testing.assert_allclose(got["probs"], probs, rtol=0, atol=TP_RUN_TOL)
    want_losses, got_losses = _losses(single), _losses(dp)
    assert got_losses.keys() == want_losses.keys()
    assert sum(tag == "train/loss" for tag, _ in got_losses) == \
        2 * FOLD[0][0]
    np.testing.assert_allclose(list(got_losses.values()),
                               list(want_losses.values()), rtol=0,
                               atol=TP_RUN_TOL)
    if _well_separated(probs, TP_RUN_TOL):
        for key, w in want.items():
            for g1, w1 in zip(got[key] if key == "walk" else [got[key]],
                              w if key == "walk" else [w]):
                np.testing.assert_allclose(
                    [g1[k] for k in sorted(w1)], [w1[k] for k in sorted(w1)],
                    rtol=0, atol=1e-4, equal_nan=True, err_msg=key)
    assert _files(dp) == _files(single)


# ---------------------------------------------------------- dropout row0

@pytest.mark.parametrize("k,R,F,C", [(1, 33, 64, 40), (3, 16, 7, 64),
                                     (1, 64, 130, 3), (7, 5, 0, 256)])
def test_dropout_masks_row_offset_is_the_whole_masks_rows(k, R, F, C):
    """A data rank's masks (R rows from row0 = k R) are those rows of the
    whole batch's masks, both of them; with a column offset too."""
    p, seed = 0.3, 2 ** 40 + 5
    whole = plain_dropout_masks((k + 2) * R, F + 9, C, seed, p)
    part = plain_dropout_masks(R, F, C, seed, p, row0=k * R)
    rows = slice(k * R, (k + 1) * R)
    assert torch.equal(part[0], whole[0][rows, :F])
    assert torch.equal(part[1], whole[1][rows])
    both = plain_dropout_masks(R, F, C, seed, p, col0=9, row0=k * R)
    assert torch.equal(both[0], whole[0][rows, 9:9 + F])
    assert torch.equal(plain_dropout_masks(R, F, C, seed, p, row0=0)[0],
                       plain_dropout_masks(R, F, C, seed, p)[0])


# --------------------------------------------------------------- refusals

def test_what_data_parallelism_refuses():
    """--train-multi-k > 1 stays refused by name; --dp-size needs its
    processes, a batch dp divides and a mesh of its size; --dp-size 0
    resolves as JAX's auto_dp_size. A model other than tri_mbt_vsltcls
    under dp x mp (refused until tensor parallelism covered every family)
    now shards: the cross transformer's Trainer on a (2, 2) mesh."""
    assert mesh_shape(2, B, 0, 2) == (2, 1)
    assert mesh_shape(0, B, 2, 4) == (2, 2)
    assert mesh_shape(0, 6, 1, 3) == (3, 1)
    assert jax_mesh.auto_dp_size(6, 4) == 3
    with pytest.raises(ValueError, match="without a shard"):
        mesh_shape(0, 6, 1, 4)      # auto takes 3 of the 4 processes
    with pytest.raises(ValueError, match="does not divide --batch-size"):
        mesh_shape(2, 5, 0, 2)
    with pytest.raises(ValueError, match="without a shard"):
        mesh_shape(2, B, 0, 4)
    cross = parse_config(SMALL + DP + [
        "--model", "cross_transformer_txt_vslt", "--input-types", "vslt_txt",
        "--vslt-type", "carryforward", "--mp-size", "2"])
    tr = port_trainer.Trainer(cross, get_model(cross), "cpu",
                              mesh=Mesh(2, 2, 0))
    assert tr.split and all(tr.split[k] in (0, 1) for k in tr.split)
    cfg = parse_config(_mbt("tri_mbt_vsltcls", "vslt_txt"))
    with pytest.raises(ValueError, match="data ranks"):
        port_trainer.Trainer(cfg, get_model(cfg), "cpu")
    with pytest.raises(ValueError, match="needs 2 processes"):
        common.setup_distributed(cfg, "cpu")
    common.check_flags(cfg)
    with pytest.raises(NotImplementedError, match="--train-multi-k 2"):
        common.check_flags(cfg.replace(train_multi_k=2))
