"""Tensor parallelism (--mp-size 2) for every family of the port's
registry on the CPU, in ranks started by parallel.launch over gloo (rank
bodies in tests/tp_families_worker.py, which imports no jax).

One launch of two ranks runs every family of ``RUNS`` (the cross
transformers, the 3-D block mask, the concat fusion, --remat 1, AUXCPC,
GRU-D with nothing split, tri_mbt_v1's frozen trunk) against the port's
single process on the same batches from the same weights at --dropout
0.1, and the cross transformer and a model whose heads the model axis
does not divide (one head) against the JAX Trainer at --mp-size 2
--dp-size 1 --use-pallas 2 (a (1, 2) mesh of the 8 CPU devices); a
launch of four ranks runs the cross transformer at --dp-size 2
--mp-size 2. Then every name of the registry is built at a tiny width
and cut for both model ranks of a (1, 2) mesh, its two shards put back
together against the whole state_dict, and its seeded weights are held
to those of a build that runs torch's default initialisation first.

Small: 2 layers, d 64, 2 or 4 heads, batch 4, fp32, the Swin-T at
tests/test_torch_swin_train.py's ``NARROW``. Tolerances: eval
probabilities and the two train-step losses within 1e-5; the state after
the steps within tests/test_torch_dp.py's bounds (SGD, against one
process) or compare_train_state's (Adam, against JAX); every rank's whole
state, replicated parameters included, bit for bit equal."""
import copy
import functools
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import (baselines, get_model,
                                                      legacy, models,
                                                      registry)
from medical_tri_modal_pilot_tpu_torch.models.convert import (
    from_jax_variables)
from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
from medical_tri_modal_pilot_tpu_torch.parallel.mesh import Mesh
from medical_tri_modal_pilot_tpu_torch.train import trainer as port_trainer
from dp_worker import execute
from test_torch_dp import (GRAD_RTOL, LOSS_TOL, PROB_TOL, SGD, STATE_RTOL,
                           _perturbed_init, _ranks_agree)
from test_torch_legacy_models import SMALL_BACKBONES, _own_inputs
from test_torch_swin_train import NARROW
from test_torch_train import _close_to_tensor_max, compare_train_state

TESTS = Path(__file__).resolve().parent
B = 4
FLAGS = ["--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--transformer-num-layers", "2",
         "--transformer-dim", "64", "--precision", "fp32"]
TIE = ["--vslt-type", "TIE", "--TIE-len", "40", "--imgtxt-time", "1"]
CF = ["--vslt-type", "carryforward"]
MP = ["--mp-size", "2", "--dp-size", "1"]


def _argv(model, inputs, stream, heads=2, dropout=0.1, *extra):
    return FLAGS + stream + MP + (SGD if dropout else []) + [
        "--model", model, "--input-types", inputs,
        "--transformer-num-head", str(heads), "--dropout", str(dropout),
        *extra]


# the families two ranks run against one process (SGD with momentum, as
# tests/test_torch_dp.py: a parameter moves by lr times its gradient, so
# the two ways of summing give the same state to rounding, where Adam
# turns a gradient of rounding size into a step of lr): name -> (argv,
# Config fields the command line does not set, the reduced Swin-T or None)
RUNS = {
    # the cross layers' MHA without prenorm, on the rank's heads
    "cross_txt": (_argv("cross_transformer_txt_vslt", "vslt_txt", CF), {},
                  None),
    # the image cross transformer over the Swin-T's 49 tokens
    "cross_img": (_argv("cross_transformer_img_vslt_sssccc", "vslt_img", CF),
                  {}, NARROW),
    # the [B, L, L] block mask on the rank's heads
    "vmulti": (_argv("tri_mbt_vmulti", "vslt_img_txt", TIE, 4), {}, NARROW),
    # the concat fusion's joint stream
    "tri_mt": (_argv("tri_mt_v1", "vslt_img_txt", TIE), {}, NARROW),
    # torch.utils.checkpoint around layers that hold collectives
    "remat": (_argv("unimodal_transformer", "vslt", TIE, 4, 0.1,
                    "--remat", "1"), {}, None),
    # the cpc loss over keys drawn alike on the model ranks
    "auxcpc": (_argv("auxcpc_mbt", "vslt_txt", CF, 2, 0.1,
                     "--auxiliary-loss-input", "directInput"),
               {"auxiliary_loss_type": "cpc"}, None),
    # nothing split: pure replication
    "gru_d": (_argv("gru_d", "vslt", CF), {}, None),
    # the frozen trunk and the v1 heads
    "v1": (_argv("tri_mbt_v1", "vslt_img_txt", TIE), {}, NARROW),
}
# against the JAX Trainer at --mp-size 2 (dropout 0, JAX's initial
# weights): the cross transformer, and one head, which the model axis
# does not divide (JAX runs that attention unsharded, ops/__init__.py:
# 116-118; the port gathers q, k and v)
JAX_RUNS = {
    "jax_cross": _argv("cross_transformer_txt_vslt", "vslt_txt", CF, 2, 0),
    "jax_one_head": _argv("tri_mbt_vsltcls", "vslt_txt", TIE, 1, 0),
}
TOL = 1e-5
# a momentum buffer whose true gradient is 0 (a bias the BatchNorm
# cancels) holds rounding noise of the model's gradient scale: its error
# is bounded by GRAD_NOISE of the largest momentum entry of the model
# (measured 1.0e-6 of it, fc_list.0.bias of the remat run)
GRAD_NOISE = 1e-5


def _run(name, argv, replace, trunk, seed):
    cfg = parse_config(argv).replace(**replace)
    return {"name": name, "argv": argv, "replace": replace, "trunk": trunk,
            "init": _perturbed_init(cfg, trunk, seed),
            "batches": [synthetic_batch(cfg, B, seed=s, present_frac=0.5)
                        for s in (5, 6)],
            "eval": synthetic_batch(cfg, B, seed=7, present_frac=0.5)}


def _single(run):
    return execute(dict(run, replace=dict(run["replace"], dp_size=0,
                                          mp_size=0)))


def _launch(tmp, nproc, runs):
    torch.save(runs, tmp / "runs.pt")
    launch("tp_families_worker:runs", nproc, f"file://{tmp / 'rendezvous'}",
           [str(tmp)], pythonpath=[str(TESTS)], timeout=400, capture=True)
    got = torch.load(tmp / "tp.pt", weights_only=False)
    states = [torch.load(tmp / f"state{r}.pt", weights_only=False)
              for r in range(nproc)]
    return got, states


def _in_thread(fn, *args):
    """fn(*args) in a thread; join() returns its result or raises its
    error."""
    box = {}

    def body():
        try:
            box["result"] = fn(*args)
        except Exception as e:   # re-raised in the caller's thread
            box["error"] = e
    thread = threading.Thread(target=body)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]
    return join


def _jax_run(name, argv):
    """The JAX Trainer at --mp-size 2 on a (1, 2) mesh, its initial
    weights as the run's; its eval probabilities and two steps' losses
    come later (``_jax_steps``)."""
    cfg = parse_config(argv)
    batch = synthetic_batch(cfg, B, seed=3)
    jcfg = jax_parse(argv + ["--use-pallas", "2"])
    jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batch)
    assert dict(jt.mesh.shape) == {"data": 1, "model": 2}
    variables = jax.device_get({"params": jt.state.params,
                                "batch_stats": jt.state.batch_stats})
    # both steps on one batch (tests/test_torch_tp.py::test_tp_steps_
    # match_jax: a second batch reads Adam's noise-driven elements at
    # first order)
    run = {"name": name, "argv": argv, "replace": {}, "trunk": None,
           "init": from_jax_variables(cfg, variables),
           "batches": [batch, batch], "eval": batch}
    return jt, run


def _jax_steps(jt, run):
    probs = np.asarray(jt.eval_step(run["eval"])[0])
    losses = [float(jt.train_step(b)) for b in run["batches"]]
    return probs, losses


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Two gloo ranks over RUNS and JAX_RUNS in one launch, four over the
    cross transformer at dp 2 x mp 2 in another, both while this process
    runs the JAX Trainers and every run in one process. Returns (the two
    ranks' results and states, the four ranks' results and states, the
    single-process results, the JAX results by name)."""
    runs = [_run(name, *spec, seed=i) for i, (name, spec) in
            enumerate(RUNS.items())]
    jax_side = {}
    jax_ops.reset_mesh_fallback_count()
    try:
        for name, argv in JAX_RUNS.items():
            jt, run = _jax_run(name, argv)
            jax_side[name] = jt
            runs.append(run)
        dp_mp = _run("dp_mp", _argv("cross_transformer_txt_vslt", "vslt_txt",
                                    CF, 2, 0.1, "--dp-size", "2"), {}, None,
                     seed=20)
        dp_mp["batches"] = dp_mp["batches"][:1]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # as the ranks
        two = _in_thread(_launch, tmp_path_factory.mktemp("tp2"), 2, runs)
        four = _in_thread(_launch, tmp_path_factory.mktemp("tp4"), 4,
                          [dp_mp])
        try:
            jax_res = {}
            for run in runs[len(RUNS):]:
                jt = jax_side[run["name"]]
                jax_res[run["name"]] = (jt, *_jax_steps(jt, run))
            jax_res["fallbacks"] = jax_ops.mesh_fallback_count()
            single = {run["name"]: _single(run) for run in runs}
            single["dp_mp"] = _single(dp_mp)
        finally:
            ranks2 = two()
            ranks4 = four()
            torch.set_num_threads(threads)
    finally:
        jax_ops.configure(False)
    return ranks2, ranks4, single, jax_res


def _check_against_single(got, want, what):
    """A TP run against one process: the losses (LOSS_TOL of the larger of
    1 and the loss), the eval probabilities before and after the steps
    (PROB_TOL), the eval loss; the whole state: every parameter and
    BatchNorm statistic within STATE_RTOL of its tensor's largest entry
    (plus 1e-7), every momentum buffer within GRAD_RTOL of its tensor's
    (plus GRAD_NOISE of the model's largest), the other entries equal
    (tests/test_torch_dp.py's bounds, the floor scaled to the model)."""
    scale = np.maximum(1.0, np.abs(want["losses"]))
    assert np.all(np.abs(np.subtract(got["losses"], want["losses"]))
                  <= LOSS_TOL * scale), (what, got["losses"], want["losses"])
    for key in ("probs0", "probs"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=PROB_TOL, err_msg=f"{what} {key}")
    assert got["eval_loss"] == pytest.approx(want["eval_loss"], abs=LOSS_TOL)
    g_sd, w_sd = got["model"], want["model"]
    assert g_sd.keys() == w_sd.keys() and got["names"] == want["names"]
    for name, w in w_sd.items():
        if w.is_floating_point():
            _close_to_tensor_max(g_sd[name].numpy(), w.numpy(), STATE_RTOL,
                                 1e-7, f"{what} {name}")
        else:
            assert torch.equal(g_sd[name], w), (what, name)
    g_opt, w_opt = got["optimizer"]["state"], want["optimizer"]["state"]
    assert g_opt.keys() == w_opt.keys() == set(range(len(want["names"])))
    floor = GRAD_NOISE * max(float(st["momentum_buffer"].abs().max())
                             for st in w_opt.values())
    for i, st in w_opt.items():
        _close_to_tensor_max(g_opt[i]["momentum_buffer"].numpy(),
                             st["momentum_buffer"].numpy(), GRAD_RTOL, floor,
                             f"{what} momentum {want['names'][i]}")


# ------------------------------------------------ families, two ranks

@pytest.mark.parametrize("name", list(RUNS))
def test_family_matches_single_process(tp_runs, name):
    """Two ranks at --mp-size 2 against one process at --dropout 0.1 from
    the same weights on the same batches: the eval probabilities before
    and after two train steps, the losses and the eval loss (1e-5), the
    state after the steps (_check_against_single); both ranks end
    with the same whole state, bit for bit; that state, loaded back into
    the ranks (load_state_dicts cuts it) and gathered again, is the same;
    Trainer.check_replicas catches one replicated parameter moved by a
    rounding step on one rank. What tp_spec splits: the q|k|v and FFN
    weights of every transformer layer, nothing of gru_d."""
    (got, states), _, single, _ = tp_runs
    _check_against_single(got[name], single[name], name)
    _ranks_agree(states, name)
    assert got[name]["drift_caught"] and got[name]["reloaded"]
    split = got[name]["split"]
    if name == "gru_d":
        assert split == []
    else:
        layers = len([n for n in split if n.endswith("w_2.weight")])
        assert layers >= 2 and len(split) == 9 * layers, split


@pytest.mark.parametrize("name", list(JAX_RUNS))
def test_tp_matches_jax(tp_runs, name):
    """Two ranks at --mp-size 2 against the JAX Trainer at --mp-size 2
    --dp-size 1 --use-pallas 2 from the same weights, dropout 0, two steps
    on one batch: eval probabilities and losses (1e-5), parameters, Adam
    moments and BatchNorm statistics (compare_train_state). The one-head
    run reaches JAX's unsharded attention (a mesh fallback)."""
    (got, states), _, _, jax_res = tp_runs
    jt, jprobs, jlosses = jax_res[name]
    res = got[name]
    np.testing.assert_allclose(res["probs0"], jprobs, rtol=0, atol=TOL)
    np.testing.assert_allclose(res["losses"], jlosses, rtol=0, atol=TOL)
    cfg = parse_config(JAX_RUNS[name]).replace(mp_size=0, dp_size=0)
    tr = port_trainer.Trainer(cfg, get_model(cfg), "cpu", eval_only=False)
    tr.load_state_dicts(res["model"], res["optimizer"])
    compare_train_state(cfg, jt, tr, res["lr_sum"])
    _ranks_agree(states, name)
    if name == "jax_one_head":
        assert jax_res["fallbacks"] > 0


def test_dp_mp_cross_matches_single_process(tp_runs):
    """Four ranks at --dp-size 2 --mp-size 2 (two model groups of two, each
    on half the batch) on the cross transformer against one process at
    --dropout 0.1: one step's loss, the eval before and after it (1e-5),
    the gathered state; every rank ends with the same whole state."""
    _, (got, states), single, _ = tp_runs
    _check_against_single(got["dp_mp"], single["dp_mp"], "dp_mp")
    _ranks_agree(states, "dp_mp")
    assert got["dp_mp"]["drift_caught"] and got["dp_mp"]["reloaded"]


# ------------------------------------------------- every registry name

def _walk_argv(name):
    """The flags a name builds on: its own --input-types, the TIE stream
    for the MBT models, the carryforward grid for the baselines and the
    legacy families."""
    if name in legacy.LEGACY:
        extra = CF
        if name.startswith("auxcpc"):
            extra = extra + ["--auxiliary-loss-input", "directInput"]
        if name.startswith("mbt_"):
            extra = TIE
        return _argv(name, _own_inputs(name), extra)
    if name in ("gru_d", "lstm", "feature_temporal_v1"):
        return _argv(name, "vslt", CF)
    if name == "fusiontrainer":
        return _argv(name, "vslt_img_txt", CF)
    if name == "unimodal_transformer":
        return _argv(name, "vslt", TIE)
    inputs = ("vslt_img" if name.startswith(("biimg", "bi_vsltimg"))
              else "vslt_txt" if name.startswith(("bitxt", "bi_vslttxt"))
              else "vslt_img_txt")
    return _argv(name, inputs, TIE)


@pytest.fixture
def small_port_backbones(monkeypatch):
    """The reduced backbones (test_torch_legacy_models' SMALL_BACKBONES)
    in the port's legacy, MBT and baseline modules."""
    for attr, (_, cls, kw) in SMALL_BACKBONES.items():
        for mod in (legacy, models, baselines):
            if hasattr(mod, attr):
                monkeypatch.setattr(mod, attr, functools.partial(cls, **kw))


@pytest.mark.parametrize("name", sorted(registry._REGISTRY))
def test_every_name_shards_and_reassembles(name, small_port_backbones):
    """Each name's Trainer at --mp-size 2 builds for model index 0 and 1 of
    a (1, 2) mesh (no process group: shard_model cuts in place); the two
    shards of each split tensor put back together, and each replicated
    tensor on both ranks, are the whole model's state_dict. The bimodal
    *_mbt_vflexible1 names raise, as the JAX model does."""
    cfg = parse_config(_walk_argv(name))
    if name.endswith("vflexible1"):
        with pytest.raises(ValueError, match="Queue 3"):
            get_model(cfg)
        return
    model = get_model(cfg)
    whole = model.state_dict()
    trainers = [port_trainer.Trainer(cfg, copy.deepcopy(model), "cpu",
                                     eval_only=False, mesh=Mesh(1, 2, r))
                for r in (0, 1)]
    split = trainers[0].split
    assert trainers[1].split == split
    parts = [tr.model.state_dict() for tr in trainers]
    assert parts[0].keys() == parts[1].keys() == whole.keys()
    for k, v in whole.items():
        if k in split:
            assert torch.equal(torch.cat([p[k] for p in parts], split[k]),
                               v), (name, k)
            assert parts[0][k].shape[split[k]] * 2 == v.shape[split[k]]
        else:
            assert torch.equal(parts[0][k], v) and torch.equal(parts[1][k],
                                                               v), (name, k)
    tp = [m for m in trainers[0].model.modules()
          if getattr(m, "tp", None) is not None]
    # an attention and an FFN per transformer layer, each split whole
    assert len(tp) == 2 * len([k for k in split if k.endswith("w_2.weight")])


@pytest.mark.parametrize("name", sorted(registry._REGISTRY))
def test_every_name_seeds_its_weights_without_torch_init(
        name, small_port_backbones):
    """get_model builds its modules without torch's default initialisation
    (registry._without_torch_init): init_parameters draws every parameter,
    so the seeded state is the one built with torch's default draws first,
    bit for bit."""
    cfg = parse_config(_walk_argv(name))
    if name.endswith("vflexible1"):
        with pytest.raises(ValueError, match="Queue 3"):
            get_model(cfg)
        return
    got = get_model(cfg, torch.Generator().manual_seed(5)).state_dict()
    want = registry._REGISTRY[name](cfg)
    registry.init_parameters(want, torch.Generator().manual_seed(5))
    want = want.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), (name, k)
