"""Tensor parallelism of the port (--mp-size 2, dp 1) on the CPU, in ranks
started by parallel.launch over gloo (rank bodies in tests/tp_worker.py,
which imports no jax): the layout against the JAX package's ``_tp_spec``,
the three collectives and a sharded encoder layer against the whole one,
two ranks against the JAX Trainer at --mp-size 2 --use-pallas 2 (rowmm in
interpret mode) and against the port's single process at --dropout 0.1,
checkpoints crossing between the two, the dropout masks' column offset,
and what the port refuses. fp32 throughout; each check states its
tolerance."""
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.kernels import rowmm as jax_rowmm
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.parallel.mesh import _path_str, _tp_spec
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import (
    keep_threshold, philox4x32_10, plain_dropout_masks)
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import (
    from_jax_variables, params_from_jax)
from medical_tri_modal_pilot_tpu_torch.parallel import distributed
from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
from medical_tri_modal_pilot_tpu_torch.parallel.mesh import (
    Mesh, mesh_shape, shard_state_dict, tp_spec)
from medical_tri_modal_pilot_tpu_torch.train import checkpoints
from medical_tri_modal_pilot_tpu_torch.train import trainer as port_trainer
from test_torch_train import (MOMENT_RTOL, MU_NOISE, _close_to_tensor_max,
                              compare_train_state)

TESTS = Path(__file__).resolve().parent
B = 4
# config 2 at small width; TIE-len 600 makes the fusion-layer vslt stream
# 768 rows (1 + 600 + 4 bottlenecks, padded to 256s), so its attention
# reaches the row-skipping LN projection; the txt stream (133 rows) takes
# StdLN and plain products. d_ff = 4 d = 256.
TP = ["--model", "tri_mbt_vsltcls", "--input-types", "vslt_txt",
      "--vslt-type", "TIE", "--imgtxt-time", "1",
      "--output-type", "intubation",
      "--modality-inclusion", "train-missing_test-missing",
      "--batch-size", str(B), "--TIE-len", "600",
      "--transformer-num-layers", "2", "--transformer-dim", "64",
      "--transformer-num-head", "4", "--precision", "fp32",
      "--mp-size", "2", "--dp-size", "1"]
CROSS = ["--model", "cross_transformer_txt_vslt", "--input-types",
         "vslt_txt", "--vslt-type", "carryforward", "--output-type",
         "intubation", "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--transformer-num-layers", "2",
         "--transformer-dim", "64", "--transformer-num-head", "2",
         "--precision", "fp32"]
# the families of tests/test_torch_tp_families.py, for the layout: the
# block-mask multitoken model, the concat fusion, AUXCPC over the MBT
# fusion, the legacy cross transformer on the Swin-T's tokens
VMULTI = [{"tri_mbt_vsltcls": "tri_mbt_vmulti",
           "vslt_txt": "vslt_img_txt"}.get(a, a) for a in TP]
TRI_MT = [{"tri_mbt_vsltcls": "tri_mt_v1",
           "vslt_txt": "vslt_img_txt"}.get(a, a) for a in TP]
AUXCPC = [{"cross_transformer_txt_vslt": "auxcpc_mbt"}.get(a, a)
          for a in CROSS] + ["--auxiliary-loss-input", "directInput"]
CROSS_IMG = [{"cross_transformer_txt_vslt":
              "cross_transformer_img_vslt_sssccc",
              "vslt_txt": "vslt_img"}.get(a, a) for a in CROSS]
# sharded against whole, fp32: the same math with the sums split over the
# ranks (measured below 2e-6 of each tensor's largest entry)
SPLIT_RTOL = 1e-5


def _launch(tmp_path, target, **kw):
    launch(f"tp_worker:{target}", 2, f"file://{tmp_path / 'rendezvous'}",
           [str(tmp_path)], pythonpath=[str(TESTS)], timeout=240,
           capture=True, **kw)


def _write_inputs(tmp_path, argv, state, batches):
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    torch.save(state, tmp_path / "init.pt")
    torch.save(batches, tmp_path / "batches.pt")


def _replicated_agree(tmp_path):
    """Every rank ends with the same replicated parameters, bit for bit."""
    a, b = (torch.load(tmp_path / f"replicated{r}.pt") for r in (0, 1))
    assert a.keys() == b.keys() and len(a) > 10
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------- layout

def _jax_param_shapes(argv):
    jcfg = jax_parse(argv)
    cfg = parse_config(argv)
    b = {k: jax.numpy.asarray(v)
         for k, v in synthetic_batch(cfg, B, seed=0).items()}
    missing_num = jax_trainer.compute_missing_num(jcfg, b["missing"])
    model = jax_get_model(jcfg)
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": rng, "dropout": rng}, b, missing_num, True))
    return cfg, shapes["params"]


# the encoder layers of each case (tri_mt_v1: the joint stream's alone)
LAYERS = {"tri_mbt": 4, "cross": 4, "vmulti": 6, "tri_mt": 2, "auxcpc": 4,
          "cross_img": 4}


@pytest.mark.parametrize("argv,case", [
    (TP, "tri_mbt"), (CROSS, "cross"), (VMULTI, "vmulti"),
    (TRI_MT, "tri_mt"), (AUXCPC, "auxcpc"), (CROSS_IMG, "cross_img")],
    ids=["tri_mbt", "cross", "vmulti", "tri_mt", "auxcpc", "cross_img"])
@pytest.mark.parametrize("mp", [2, 3])
def test_tp_spec_matches_jax(argv, case, mp):
    """Each JAX parameter becomes a marker array that counts along the
    dimension JAX's _tp_spec splits (zeros where it is replicated); through
    the weight bridge each port tensor must count along exactly the
    dimension the port's tp_spec names. mp 3 divides no width here, so
    nothing may be split."""
    cfg, shapes = _jax_param_shapes(argv)

    def marker(kp, leaf):
        spec = _tp_spec(_path_str(kp), leaf.shape, mp)
        dims = [i for i, s in enumerate(spec) if s is not None]
        a = np.zeros(leaf.shape, np.float32)
        if dims:
            d = dims[0]
            shape = [1] * len(leaf.shape)
            shape[d] = leaf.shape[d]
            a = a + np.arange(leaf.shape[d], dtype=np.float32).reshape(shape)
        return a

    tree = jax.tree_util.tree_map_with_path(marker, shapes)
    port = params_from_jax(cfg, jax.tree.map(np.asarray, tree))
    split = 0
    for name, t in port.items():
        dim = tp_spec(name, t.shape, mp)
        varies = [d for d in range(t.dim())
                  if t.shape[d] > 1 and not torch.equal(
                      t, t.narrow(d, 0, 1).expand_as(t))]
        assert varies == ([] if dim is None else [dim]), (name, varies, dim)
        split += dim is not None
    # per encoder layer: the q, k, v weights and biases, w_1's weight and
    # bias, w_2's weight
    layers = len([k for k in port if k.endswith("w_2.weight")])
    assert split == (0 if mp == 3 else 9 * layers)
    assert layers == LAYERS[case]


# ------------------------------------------------------------ collectives

def test_collectives_and_a_sharded_layer_match_the_whole(tmp_path):
    """Copy, reduce and gather against their definitions; an encoder layer
    cut over two ranks against the whole layer on the same inputs and
    dropout seeds: the output on live rows and every gradient, at dropout
    0 and 0.1, on a 512-row stream with a dead 256-row block (the LN-fused
    projection) and on a 130-row one (StdLN and products); a LARS step on
    a shard against the whole tensor's (norms over the model group)."""
    _launch(tmp_path, "collectives")
    res = json.loads((tmp_path / "collectives.json").read_text())
    for key, err in res.items():
        if key.endswith("_split"):
            assert any(n.endswith("w_1.weight") for n in err)
            assert any(n.endswith("query_proj.linear.bias") for n in err)
            continue
        assert err <= SPLIT_RTOL, (key, err)
    assert "lars_shard" in res


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launch stops
    rank 0 and raises with rank 1's error."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        _launch(tmp_path, "fails")
    assert not (tmp_path / "unreachable.npy").exists()


# ----------------------------------------------------- the step vs JAX

def test_tp_steps_match_jax(tmp_path, monkeypatch):
    """Two gloo ranks at --mp-size 2 against the JAX Trainer at --mp-size 2
    --dp-size 1 --use-pallas 2 (a (1, 2) mesh of the 8 CPU devices, the
    kernels in interpret mode), from the same weights, dropout 0: eval
    probabilities (1e-5), then two train steps on one batch: loss (1e-5),
    parameters, Adam moments and BatchNorm statistics
    (compare_train_state). Both sides reach the row-skipping LN
    projection."""
    argv = TP + ["--dropout", "0"]
    cfg = parse_config(argv)
    jcfg = jax_parse(argv + ["--use-pallas", "2"])
    # both steps on one batch: Adam moves an element whose gradient is
    # rounding noise by up to lr either way, and a second batch reads such
    # elements at first order (on two batches the JAX package's own single
    # and TP steps differ by 1.6e-5 in the second loss, measured)
    batches = [synthetic_batch(cfg, B, seed=3)] * 2
    reached = {"n": 0}
    traced = jax_rowmm._call_ln_fwd

    def counted(*args):
        reached["n"] += 1
        return traced(*args)
    monkeypatch.setattr(jax_rowmm, "_call_ln_fwd", counted)
    errors = []
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batches[0])
        assert dict(jt.mesh.shape) == {"data": 1, "model": 2}
        variables = jax.device_get({"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
        _write_inputs(tmp_path, argv, from_jax_variables(cfg, variables),
                      batches)

        def ranks():
            try:
                _launch(tmp_path, "steps")
            except Exception as e:   # re-raised below, in the test thread
                errors.append(e)
        thread = threading.Thread(target=ranks)
        thread.start()
        jprobs, _, _ = jt.eval_step(batches[0])
        jlrs, jlosses = [], []
        for b in batches:
            jlrs.append(jt.current_lr())
            jlosses.append(float(jt.train_step(b)))
        thread.join()
        if errors:
            raise errors[0]
        tp = torch.load(tmp_path / "tp.pt", weights_only=False)
        np.testing.assert_allclose(tp["probs"], np.asarray(jprobs), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(tp["losses"], jlosses, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tp["lrs"], jlrs, rtol=1e-6)
        assert tp["rowmm_ln"] > 0 and reached["n"] > 0
        single = cfg.replace(mp_size=0, dp_size=0)
        tr = port_trainer.Trainer(single, get_model(single), "cpu",
                                  eval_only=False)
        tr.load_state_dicts(tp["model"], tp["optimizer"])
        compare_train_state(cfg, jt, tr, sum(tp["lrs"]))
    finally:
        jax_ops.configure(False)
    _replicated_agree(tmp_path)


# --------------------------------------- the step vs the single process

def _compare_port(model_sd, opt_sd, tr, lr_sum):
    """Whole-model state (a TP run's, gathered) against a single-process
    trainer's, with compare_train_state's bounds."""
    named = [(n, p) for n, p in tr.model.named_parameters()
             if p.requires_grad]
    for i, (name, p) in enumerate(named):
        st, want = opt_sd["state"][i], tr.optimizer.opt.state[p]
        for key, floor in (("exp_avg", 5e-6), ("exp_avg_sq", 1e-10)):
            _close_to_tensor_max(st[key].numpy(), want[key].numpy(),
                                 MOMENT_RTOL, floor, f"{key} {name}")
        err = (model_sd[name] - p.detach()).abs().numpy()
        clear = want["exp_avg"].abs().numpy() >= MU_NOISE
        bound = np.where(clear, 2e-6 + 0.02 * lr_sum, 2.01 * lr_sum + 2e-6)
        assert np.all(err <= bound), (name, err.max())
    head = tr.model.fc_list[1]
    for key in ("running_mean", "running_var"):
        _close_to_tensor_max(model_sd[f"fc_list.1.{key}"].numpy(),
                             getattr(head, key).numpy(), 1e-4, 1e-6, key)


def test_tp_matches_single_process_and_checkpoints_cross(tmp_path):
    """Two ranks against the port's single process at --dropout 0.1 (the
    hidden masks are the single FFN's columns through col0): eval
    probabilities and two losses (1e-5), the state after them (as
    compare_train_state). Checkpoints cross both ways: the single
    process's checkpoint of step 1 resumed under TP, and TP's checkpoint
    of step 1 (the single process's keys and shapes) resumed in one
    process, each to the same step 2."""
    argv = TP + ["--dropout", "0.1"]
    cfg = parse_config(argv)
    single = cfg.replace(mp_size=0, dp_size=0)
    batches = [synthetic_batch(cfg, B, seed=s) for s in (5, 6)]
    init = {k: v.clone() for k, v in get_model(single).state_dict().items()}

    def fresh():
        model = get_model(single)
        model.load_state_dict(init)
        return port_trainer.Trainer(single, model, "cpu", eval_only=False,
                                    seed=7)

    tr = fresh()
    probs, _, _ = tr.eval_step(batches[0])
    losses = [tr.train_step(batches[0])]
    path = tmp_path / "single_step1.pth"
    checkpoints.save_checkpoint(str(path), tr, score=0.5, epoch=1,
                                last_step=1)
    lr_sum = tr.schedule(0) + tr.current_lr()
    losses.append(tr.train_step(batches[1]))
    _write_inputs(tmp_path, argv, init, batches)
    _launch(tmp_path, "steps")
    tp = torch.load(tmp_path / "tp.pt", weights_only=False)
    np.testing.assert_allclose(tp["probs"], probs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp["losses"], losses, rtol=0, atol=1e-5)
    assert tp["rowmm_ln"] > 0
    _compare_port(tp["model"], tp["optimizer"], tr, lr_sum)
    assert tp["resumed_step"] == 1
    np.testing.assert_allclose(tp["resumed_losses"], losses[1:], rtol=0,
                               atol=1e-5)
    _compare_port(tp["resumed_model"], tp["resumed_optimizer"], tr, lr_sum)

    tp_ck = checkpoints.load_checkpoint(str(tmp_path / "tp_step1.pth"))
    one_ck = checkpoints.load_checkpoint(str(path))
    assert tp_ck.keys() == one_ck.keys() and tp_ck["step"] == 1
    assert {k: v.shape for k, v in tp_ck["model"].items()} == \
        {k: v.shape for k, v in one_ck["model"].items()}
    for i, st in one_ck["optimizer"]["state"].items():
        assert {k: np.shape(v) for k, v in st.items()} == \
            {k: np.shape(v) for k, v in tp_ck["optimizer"]["state"][i].items()}
    resumed = fresh()
    checkpoints.restore(resumed, tp_ck)
    assert resumed.step == 1
    assert resumed.train_step(batches[1]) == pytest.approx(losses[1],
                                                           abs=1e-5)
    model_sd, opt_sd = resumed.state_dicts()
    _compare_port(model_sd, opt_sd, tr, lr_sum)
    _replicated_agree(tmp_path)


def test_shard_from_jax_is_the_shard_of_the_whole():
    """The JAX weights bridged whole and cut by the layout: each split
    tensor's two shards put back together are the whole, each replicated
    one is the whole on both ranks."""
    cfg, shapes = _jax_param_shapes(TP)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    stats = {"fc_list": {"bn": {"mean": np.zeros(64, np.float32),
                                "var": np.ones(64, np.float32)}}}
    variables = {"params": params, "batch_stats": stats}
    whole = from_jax_variables(cfg, variables)
    shards = [shard_state_dict(whole, 2, i) for i in (0, 1)]
    assert shards[0].keys() == whole.keys()
    n_split = 0
    for k, v in whole.items():
        dim = tp_spec(k, v.shape, 2)
        if dim is None:
            assert torch.equal(shards[0][k], v) and torch.equal(shards[1][k],
                                                                v)
            continue
        n_split += 1
        assert shards[0][k].shape[dim] == v.shape[dim] // 2, k
        assert torch.equal(torch.cat([s[k] for s in shards], dim), v), k
    # per encoder layer: q, k, v weights and biases, w_1 weight and bias,
    # w_2 weight (2 layers x 2 streams)
    assert n_split == 9 * 4


# ------------------------------------------------------ dropout col0

def _keep_before_the_offset(R, N, m, seed, thr):
    """The hidden and output masks as plain_dropout_masks drew them before
    it took a column offset (kernels/ffn.py _keep, pinned here)."""
    n4 = -(-N // 4)
    c0 = torch.arange(n4, dtype=torch.int64)[None, :]
    c1 = torch.arange(R, dtype=torch.int64)[:, None]
    c0, c1 = torch.broadcast_tensors(c0, c1)
    words = philox4x32_10(c0, c1, torch.full_like(c0, m), seed)
    return torch.stack(words, dim=-1).reshape(R, 4 * n4)[:, :N] < thr


def test_dropout_masks_offset_zero_is_unchanged():
    """col0 = 0 (the default) draws exactly the masks of before."""
    R, F, C, p, seed = 70, 130, 36, 0.1, 2 ** 40 + 77
    thr = keep_threshold(p)
    for got in (plain_dropout_masks(R, F, C, seed, p),
                plain_dropout_masks(R, F, C, seed, p, col0=0)):
        assert torch.equal(got[0], _keep_before_the_offset(R, F, 0, seed,
                                                           thr))
        assert torch.equal(got[1], _keep_before_the_offset(R, C, 1, seed,
                                                           thr))


@pytest.mark.parametrize("col0,F", [(0, 64), (1, 7), (5, 64), (64, 64),
                                    (130, 3), (512, 512)])
def test_dropout_masks_offset_slice_is_the_whole_masks_columns(col0, F):
    """A rank's hidden mask (F columns from col0) is those columns of the
    whole mask; the output mask does not move."""
    R, C, p, seed = 33, 40, 0.3, 99
    whole = plain_dropout_masks(R, col0 + F + 5, C, seed, p)
    part = plain_dropout_masks(R, F, C, seed, p, col0=col0)
    assert torch.equal(part[0], whole[0][:, col0:col0 + F])
    assert torch.equal(part[1], whole[1])


# --------------------------------------------------------- refusals

def test_what_tensor_parallelism_refuses():
    """A mesh that leaves ranks out, an --mp-size that does not divide the
    processes, --mp-size without a mesh, and nccl without a card per rank
    raise. Four processes at --mp-size 2 make a (2, 2) mesh: data
    parallelism over two model groups (tests/test_torch_dp.py). Every
    model of the registry shards: the cross transformer's Trainer at
    --mp-size 2 cuts its q|k|v and FFN weights (its refusal until
    tensor parallelism covered every family)."""
    assert mesh_shape(1, B, 2, 2) == (1, 2)
    assert mesh_shape(0, B, 2, 2) == (1, 2)
    assert mesh_shape(0, B, 2, 4) == (2, 2)
    assert mesh_shape(2, B, 2, 4) == (2, 2)
    with pytest.raises(ValueError, match="divide"):
        mesh_shape(1, B, 3, 4)
    with pytest.raises(ValueError, match="without a shard"):
        mesh_shape(1, B, 2, 4)
    cfg = parse_config(TP)
    with pytest.raises(ValueError, match="mesh"):
        port_trainer.Trainer(cfg, get_model(cfg), "cpu")
    cross = parse_config(CROSS + ["--mp-size", "2"])
    tr = port_trainer.Trainer(cross, get_model(cross), "cpu",
                              mesh=Mesh(1, 2, 0))
    layers = [k for k in tr.split if k.endswith("w_2.weight")]
    assert len(layers) >= 2 and len(tr.split) == 9 * len(layers)
    dcfg = cfg.replace(dist_coordinator="localhost:29999",
                       dist_num_processes=2, dist_process_id=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="one visible card per rank"):
            distributed.maybe_init_distributed(dcfg, "nccl")
    with pytest.raises(ValueError, match="backend"):
        distributed.maybe_init_distributed(dcfg, "mpi")
    with pytest.raises(ValueError, match="rank"):
        distributed.maybe_init_distributed(
            cfg.replace(dist_coordinator="localhost:29999"), "gloo")
    assert distributed.maybe_init_distributed(cfg, "gloo") == (0, 1)
    assert distributed.init_method("auto") == "env://"
    assert distributed.init_method("h:1") == "tcp://h:1"
