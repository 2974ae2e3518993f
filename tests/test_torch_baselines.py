"""The paper's recurrent baselines in the port against the JAX package on
the CPU: ``gru_d`` (GRU-D: the input and hidden decays, flax's GRUCell,
the state at ``input_length`` clipped to T - 1, the BatchNorm at flax's
momentum 0.99) and ``lstm`` (two masked flax OptimizedLSTMCell layers,
the fixed 0.3 feature dropout). Weights of the JAX model's tree (gru_d:
its init, every leaf perturbed; lstm: seeded draws of its init's shapes,
``draw_like``) and random running statistics, carried across by
``from_jax_variables``. fp32 throughout, outputs within 1e-5.

gru_d: the eval step and one JAX-Trainer train step at --dropout 0 (loss
within 1e-5; parameters, Adam moments and the 0.99 running statistics at
``compare_train_state``'s bounds). lstm: its fixed dropout cannot draw
JAX's PRNG masks, so the eval step and the gradients of the mean BCE
with ``deterministic=True`` on both sides (``check_grads``: per tensor
within 1e-4 of its largest entry, the terms of a 24-step recurrence
summed in another order), and the port's mask alone (Philox of the step's
seed, the keep rate within binomial bounds). Also the bridge (a
bijection between the JAX leaves and the port's tensors) and the
initialisers. Small: d 64, hidden 32, batch 4, T 24, 16 channels."""
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import plain_dropout_masks
from medical_tri_modal_pilot_tpu_torch.models import convert, get_model
from medical_tri_modal_pilot_tpu_torch.models.baselines import GRUCell
from medical_tri_modal_pilot_tpu_torch.models.modules import DropoutSeeds
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_unimodal import draw_like
from test_torch_variants import _random_stats, check_model

ATOL = 1e-5
# gradients by tensor: |port - jax| <= GRAD_RTOL * max|jax| + 1e-7
GRAD_RTOL = 1e-4
KEY = jax.random.PRNGKey(0)
B = 4
SMALL = ["--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--transformer-num-layers", "2",
         "--transformer-dim", "64", "--transformer-num-head", "2",
         "--hidden-size", "32", "--precision", "fp32"]
CARRYFORWARD = ["--input-types", "vslt", "--vslt-type", "carryforward"]


def argv_for(model, *extra):
    return SMALL + ["--model", model] + list(extra or CARRYFORWARD)


def init_shapes(argv, batch):
    """The shapes of the JAX model's variables: ``jax.eval_shape`` of its
    init, a trace (the JAX Trainer's jitted init costs seconds of XLA
    compile on the CPU)."""
    jcfg = jax_parse(argv)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return flax.core.unfreeze(jax.eval_shape(
        lambda b: jax_get_model(jcfg).init(
            {"params": KEY, "dropout": KEY}, b, jnp.zeros(B, jnp.int32),
            True), jb))


def jax_and_port(argv, batch, shapes=None):
    """The JAX model (``.cfg``, ``.model``) with seeded variables of its
    init's shapes (``draw_like``) and random running statistics, and the
    port model carrying them (eval mode). ``shapes``: ``init_shapes``'s,
    where a caller has them."""
    cfg, jcfg = parse_config(argv), jax_parse(argv)
    shapes = shapes or init_shapes(argv, batch)
    variables = {
        "params": draw_like(shapes["params"]),
        "batch_stats": _random_stats(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32),
            shapes.get("batch_stats", {})))}
    model = get_model(cfg)
    model.load_state_dict(convert.from_jax_variables(cfg, variables),
                          strict=True)
    return (cfg, SimpleNamespace(cfg=jcfg, model=jax_get_model(jcfg)),
            variables, model)


def check_grads(cfg, jt, variables, model, batch, rtol=GRAD_RTOL,
                eval_step=False):
    """The gradients of the mean BCE of the logits, ``deterministic=True``
    on both sides (the port's model in eval mode, with autograd on): the
    loss within ATOL, the rmse head's output (where the model has one)
    within ATOL, every trainable tensor's gradient within ``rtol`` of its
    largest JAX entry (a parameter the loss does not reach: zero on both
    sides). With ``eval_step`` also the port Trainer's eval step against
    the JAX eval step's arithmetic on the same logits (sigmoid
    probabilities per sample, the mean BCE) within ATOL, from the one JAX
    compile. Returns the port's gradients by name."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    mn = jax_trainer.compute_missing_num(jt.cfg, jb["missing"])

    def loss_fn(params):
        logits, rmse = jt.model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jb, mn, True)[:2]
        logits = logits.astype(jnp.float32)
        return (optax.sigmoid_binary_cross_entropy(
            logits, jb["target"]).mean(), (logits, rmse))

    (want_loss, (want_logits, want_rmse)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    if eval_step:
        probs, loss, _ = trainer.Trainer(cfg, model, "cpu").eval_step(batch)
        assert probs.shape == (cfg.batch_size,)
        np.testing.assert_allclose(
            probs, np.asarray(jax.nn.sigmoid(want_logits)), atol=ATOL)
        assert loss == pytest.approx(float(want_loss), abs=ATOL)
    want = convert.params_from_jax(cfg, jax.device_get(jgrads))
    model.eval()
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    logits, rmse = model(b, trainer.compute_missing_num(cfg,
                                                        b["missing"]))[:2]
    assert (rmse is None) == (want_rmse is None)
    if rmse is not None:
        np.testing.assert_allclose(rmse.detach().numpy(),
                                   np.asarray(want_rmse), atol=ATOL)
    loss = trainer.bce(logits.float(), b["target"].float()).mean()
    model.zero_grad(set_to_none=True)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), abs=ATOL)
    got = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        w = want[name].numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= rtol * np.abs(w).max() + 1e-7, (name, err)
        got[name] = g
    return got


def check_bridge(argv, batch, shapes=None):
    """The weight bridge is a bijection between the JAX tree's leaves and
    the port's tensors: each JAX leaf filled with its own index lands, as
    a constant, in exactly one port tensor of the same size, and the port
    state_dict keys are exactly the bridge's; an extra leaf raises."""
    cfg = parse_config(argv)
    shapes = shapes or init_shapes(argv, batch)
    leaves, treedef = jax.tree.flatten(shapes)
    ids = jax.tree.unflatten(treedef, [
        np.full(s.shape, i, np.float32) for i, s in enumerate(leaves)])
    sd = convert.from_jax_variables(cfg, ids)
    port = get_model(cfg).state_dict()
    assert sd.keys() == port.keys()
    seen = []
    for k, v in sd.items():
        assert v.shape == port[k].shape, k
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.all(v == v.flatten()[0]), k
        i = int(v.flatten()[0])
        assert v.numel() == int(np.prod(leaves[i].shape)), k
        seen.append(i)
    assert sorted(seen) == list(range(len(leaves)))
    ids["params"]["extra"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="extra"):
        convert.from_jax_variables(cfg, ids)
    return cfg


def test_gru_d_matches_jax():
    """Eval, then one train step at --dropout 0: the BatchNorm's running
    statistics move at flax's momentum 0.99 on both sides."""
    argv = argv_for("gru_d")
    tr = check_model(argv, synthetic_batch(parse_config(argv), B, seed=3))
    assert tr.model.BN_MOMENTUM == 0.99
    assert int(tr.model.bn.num_batches_tracked) == 1


def test_gru_d_reads_the_state_at_the_clipped_length():
    """input_length past T reads the last step, as JAX clips it; a shorter
    one reads its own step (not length - 1, the legacy encoder's rule)."""
    argv = argv_for("gru_d")
    cfg = parse_config(argv)
    model = get_model(cfg)
    b = synthetic_batch(cfg, B, seed=5)
    T = b["vslt"].shape[2]
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    mn = torch.zeros(B, dtype=torch.long)
    outs = {}
    for n in (T - 1, T + 7, 3):
        tb["input_length"] = torch.full((B,), n, dtype=torch.int32)
        with torch.no_grad():
            outs[n] = model(tb, mn)[0]
    assert torch.equal(outs[T - 1], outs[T + 7])
    assert not torch.allclose(outs[3], outs[T - 1])


def test_lstm_matches_jax():
    """lstm: the eval step and the deterministic gradients."""
    argv = argv_for("lstm")
    batch = synthetic_batch(parse_config(argv), B, seed=3)
    cfg, jt, variables, model = jax_and_port(argv, batch)
    check_grads(cfg, jt, variables, model, batch, eval_step=True)


def test_lstm_fixed_dropout_mask():
    """The features' dropout is 0.3 whatever --dropout says: the port's
    training forward equals the eval head over the eval features masked by
    the Philox keep mask of the step's first seed (divided by 0.7), and
    over many rows the keep rate lies within 5 sd of 0.7. A train step
    runs and is finite."""
    cfg = parse_config(argv_for("lstm", *CARRYFORWARD, "--dropout", "0"))
    model = get_model(cfg)
    b = synthetic_batch(cfg, B, seed=3)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    mn = torch.zeros(B, dtype=torch.long)
    enc = model.ehr_model
    x = torch.cat([tb["vslt"][:, 0], tb["static"][:, 1, None, None].expand(
        B, tb["vslt"].shape[2], 1), tb["static"][:, 0, None, None].expand(
        B, tb["vslt"].shape[2], 1)], dim=-1)
    lengths = tb["input_length"].long().clamp_min(1)
    with torch.no_grad():
        feats = enc(x, lengths)[1]
        model.train()
        got = model(tb, mn, DropoutSeeds(7, 2))[0]
    seed = DropoutSeeds(7, 2).next()
    _, keep = plain_dropout_masks(B, 0, feats.shape[1], seed, 0.3)
    q = torch.tensor(0.7)
    dropped = torch.where(keep, feats / q, 0.0)
    want = torch.nn.functional.linear(dropped, model.dense_layer.weight,
                                      model.dense_layer.bias)[..., 0]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    _, keep = plain_dropout_masks(4096, 0, 64, seed, 0.3)
    n = keep.numel()
    rate = float(keep.float().mean())
    assert abs(rate - 0.7) <= 5 * (0.21 / n) ** 0.5
    tr = trainer.Trainer(cfg, get_model(cfg), "cpu", eval_only=False)
    assert np.isfinite(tr.train_step(b))


@pytest.mark.parametrize("model", ["gru_d", "lstm"])
def test_recurrent_bridge(model):
    check_bridge(argv_for(model),
                 synthetic_batch(parse_config(argv_for(model)), B, seed=3))


def test_recurrent_initialisers():
    """flax's initialisers: orthogonal hidden kernels, fan-in input
    kernels, zero biases, input_decay_w ~ N(0, 0.02), input_decay_b 0."""
    cfg = parse_config(argv_for("gru_d", *CARRYFORWARD, "--hidden-size",
                                "128"))
    model = get_model(cfg)
    cell = model.gru.cell
    assert isinstance(cell, GRUCell)
    for name in ("hr", "hz", "hn"):
        w = getattr(cell, name).weight
        torch.testing.assert_close(w @ w.T, torch.eye(128), atol=1e-5,
                                   rtol=0)
    std = float(cell.ir.weight.detach().std())
    assert std == pytest.approx(32 ** -0.5, rel=0.1)
    assert not cell.ir.bias.any() and not cell.hn.bias.any()
    assert not model.input_decay_b.any()
    std = float(model.input_decay_w.detach().std())
    assert std == pytest.approx(0.02, rel=0.5)
    lstm = get_model(parse_config(argv_for("lstm"))).ehr_model.layer1.cell
    w = lstm.hf.weight
    torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5, rtol=0)
    assert lstm.ii.bias is None and lstm.hi.bias is not None


def test_default_model_runs_through_the_drivers(tmp_path):
    """No --model: the CLI's default gru_d (carryforward) through the
    train driver's fold on the CPU (1 epoch of 2 train, 1 val and 1 test
    batch), then the test driver scores its best checkpoint to the train
    driver's final test metrics."""
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import BatchList
    from medical_tri_modal_pilot_tpu_torch.drivers import test as test_drv
    from medical_tri_modal_pilot_tpu_torch.drivers import train as train_drv
    cfg = parse_config(SMALL + CARRYFORWARD + [
        "--dir-result", str(tmp_path), "--epochs", "1", "--log-iter", "1",
        "--img-pack-frac", "0.5"])
    assert cfg.model == "gru_d"
    loaders = [BatchList([synthetic_batch(cfg, B, seed=s + i)
                          for i in range(n)])
               for n, s in ((2, 10), (1, 20), (1, 30))]
    for b in loaders[1].batches + loaders[2].batches:
        b["target"][:] = [1, 0, 1, 0]
    val, test = train_drv.run_fold(cfg, 0, *loaders, device="cpu")
    assert val is not None and np.isfinite(test["auc"])
    walked = dict(test_drv.run_checkpoints(cfg, test_drv.checkpoints_of(cfg),
                                           loaders[2], device="cpu"))
    assert test in walked.values()
