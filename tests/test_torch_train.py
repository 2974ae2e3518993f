"""The port's training path on the CPU against the JAX package: the
gradients of the plain attn_block and ffn (autograd) against jax.grad of
the Pallas kernels' custom VJPs (interpret mode), the Philox dropout masks,
the LR schedules, the six optimizer variants against optax, a config-2
train step against the JAX Trainer, and a checkpoint round trip. fp32
throughout; each check states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.kernels.attn_block import pallas_attn_block
from medical_tri_modal_pilot_tpu.kernels.ffn import _ln_f32, pallas_ffn
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.models.modules import _ffn_row_blocks
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
    key_ends, torch_attn_block)
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import (
    keep_threshold, philox4x32_10, plain_dropout_masks, torch_ffn)
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import (
    from_jax_variables, optimizer_state_from_jax, params_from_jax)
from medical_tri_modal_pilot_tpu_torch.train import checkpoints
from medical_tri_modal_pilot_tpu_torch.train import trainer as port_trainer

# The port's tests run torch on one intra-op thread. The tier-1 command
# runs six pytest workers on the machine's cores, and each worker collects
# (imports) every test module, so this holds in all of them. A pool as
# wide as the machine in every worker spins between its parallel regions
# on the cores the other workers need: a two-batch ``run_fold`` of
# tests/test_torch_classification.py took 0.4 s alone and 32-47 s inside
# the six-worker run, 0.4 s again in six concurrent runs at one thread.
torch.set_num_threads(1)

# gradients: fp32 on both sides, the same math summed in another order
# (the JAX package's own kernel-vs-composition tolerance)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _grads_torch(fn, args, cot):
    """Gradients of sum(fn(*args) * cot) by autograd."""
    ts = [_t(a).requires_grad_(True) for a in args]
    (fn(*ts) * _t(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


# ---------------------------------------------------------- attn_block

# the shape cases of tests/test_attn_block.py:101; sample 0 has every key
# masked (uniform attention over all L keys, every row live)
@pytest.mark.parametrize("B,L,C,H", [(2, 130, 64, 4), (2, 517, 64, 2)])
def test_attn_block_plain_grads_match_jax_kernel(B, L, C, H):
    """The cotangent is zero on rows at or past a sample's last valid key
    (the model's pattern: nothing downstream reads them)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    gamma = (1 + .1 * rng.standard_normal(C)).astype(np.float32)
    beta = (.1 * rng.standard_normal(C)).astype(np.float32)
    w = (rng.standard_normal((C, 3 * C)) / np.sqrt(C)).astype(np.float32)
    b = (.1 * rng.standard_normal(3 * C)).astype(np.float32)
    lengths = np.array([0, L // 3 + 1])
    mask = np.arange(L)[None, :] >= lengths[:, None]
    ends = key_ends(torch.from_numpy(mask)).numpy()
    cot = rng.standard_normal((B, L, C)).astype(np.float32)
    cot *= (np.arange(L)[None, :] < ends[:, None])[:, :, None]
    scale = float(np.sqrt(C // H))
    jm = jnp.asarray(mask)

    def loss(*a):
        return jnp.sum(pallas_attn_block(*a, jm, scale, H) * cot)

    want = jax.grad(loss, argnums=tuple(range(5)))(x, gamma, beta, w, b)
    got = _grads_torch(
        lambda *a: torch_attn_block(*a, torch.from_numpy(mask), scale, H),
        (x, gamma, beta, w, b), cot)
    for g, e, name in zip(got, want, ["dx", "dgamma", "dbeta", "dw", "db"]):
        np.testing.assert_allclose(g, np.asarray(e), err_msg=name,
                                   **GRAD_TOL)


# ----------------------------------------------------------------- ffn

def _ffn_inputs(B, R, C=64, F=256, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape, m=0.0, s=1.0: rng.normal(m, s, shape).astype(
        np.float32)
    return (f(B, R, C), f(C, m=1.0, s=.1), f(C, s=.1), f(C, F, s=.05),
            f(F, s=.01), f(F, C, s=.05), f(C, s=.01))


# the shape cases of tests/test_ffn_kernel.py:51 and :88, and the
# row-skipping case of :124 (256-row flags, dead rows' cotangent zero)
@pytest.mark.parametrize("B,R,lengths", [(2, 70, None), (2, 130, None),
                                         (4, 512, (100, 512, 300, 10))])
def test_ffn_plain_grads_match_jax_kernel(B, R, lengths):
    args = _ffn_inputs(B, R, seed=5)
    rng = np.random.default_rng(6)
    cot = rng.standard_normal(args[0].shape).astype(np.float32)
    flags = None
    if lengths is not None:
        alive = np.arange(R)[None] < np.asarray(lengths)[:, None]
        cot *= alive[:, :, None]
        flags = _ffn_row_blocks(jnp.asarray(args[0]), jnp.asarray(~alive))

    def loss(*a):
        return jnp.sum(pallas_ffn(*a, p=0.0, deterministic=True, seed=None,
                                  block_valid=flags) * cot)

    want = jax.grad(loss, argnums=tuple(range(7)))(*args)
    got = _grads_torch(torch_ffn, args, cot)
    names = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]
    for g, e, name in zip(got, want, names):
        np.testing.assert_allclose(g, np.asarray(e), err_msg=name,
                                   **GRAD_TOL)


# ------------------------------------------------------- dropout masks

def test_philox_known_answers():
    """A scalar Philox4x32-10 written from the definition gives Random123's
    known answers, and the vectorised one used for the masks agrees with
    it on random counters (fourth word 0) and keys."""
    M = 0xFFFFFFFF
    assert _philox_scalar((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert _philox_scalar((M, M, M, M), (M, M)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert _philox_scalar((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
                          (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]
    rng = np.random.default_rng(0)
    c = rng.integers(0, 2 ** 32, (3, 16), dtype=np.int64)
    for seed in (0, 12345, 2 ** 63 - 1):
        words = philox4x32_10(*(torch.from_numpy(r) for r in c), seed)
        for i in range(16):
            want = _philox_scalar((c[0, i], c[1, i], c[2, i], 0),
                                  (seed & M, seed >> 32))
            assert [int(w[i]) for w in words] == want


def _philox_scalar(c, k):
    """A scalar Philox4x32-10 written from the definition."""
    M, c, (k0, k1) = 0xFFFFFFFF, [int(v) for v in c], map(int, k)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k0, p1 & M, (p0 >> 32) ^ c[3] ^ k1, p0 & M]
        k0, k1 = (k0 + 0x9E3779B9) & M, (k1 + 0xBB67AE85) & M
    return c


def test_dropout_masks_keep_rate_and_regeneration():
    """Keep rate within 5 binomial standard deviations of q; the same seed
    gives the same masks, another seed others; element (r, c) of mask m is
    word c % 4 of Philox at counter (c // 4, r, m, 0)."""
    R, F, C, p = 300, 256, 64, 0.1
    k1, k2 = plain_dropout_masks(R, F, C, 1234, p)
    assert k1.shape == (R, F) and k2.shape == (R, C)
    for k in (k1, k2):
        n = k.numel()
        sd = np.sqrt(n * p * (1 - p))
        assert abs(int(k.sum()) - n * (1 - p)) < 5 * sd
    a1, a2 = plain_dropout_masks(R, F, C, 1234, p)
    assert torch.equal(a1, k1) and torch.equal(a2, k2)
    b1, _ = plain_dropout_masks(R, F, C, 1235, p)
    assert not torch.equal(b1, k1)
    thr = keep_threshold(p)
    seed = 1234
    for m, k, (r, c) in ((0, k1, (7, 13)), (1, k2, (299, 63)),
                         (0, k1, (0, 255))):
        words = _philox_scalar((c // 4, r, m, 0),
                               (seed & 0xFFFFFFFF, seed >> 32))
        assert bool(k[r, c]) == (words[c % 4] < thr)


def test_dropout_masks_do_not_depend_on_the_tiling():
    """Keyed by each element's place in the whole array: the masks of a
    smaller array are the corner of a larger one's, whatever the row or
    column count."""
    k1, k2 = plain_dropout_masks(200, 192, 64, 77, 0.3)
    s1, s2 = plain_dropout_masks(70, 130, 10, 77, 0.3)
    assert torch.equal(s1, k1[:70, :130]) and torch.equal(s2, k2[:70, :10])


def test_ffn_with_dropout_matches_a_jax_composition():
    """torch_ffn given the Philox masks against the same composition in
    JAX (the TPU kernel's formula: h / q and z / q in the compute dtype),
    value and the seven gradients."""
    B, R, C, F, p = 2, 70, 64, 256, 0.25
    args = _ffn_inputs(B, R, C, F, seed=8)
    keep = plain_dropout_masks(B * R, F, C, 99, p)
    k1, k2 = (np.asarray(k.numpy()) for k in keep)
    cot = np.random.default_rng(9).standard_normal(args[0].shape).astype(
        np.float32)

    def jax_ffn(x, gamma, beta, w1, b1, w2, b2):
        ln, *_ = _ln_f32(x, gamma, beta, C)
        h = jnp.maximum(ln @ w1 + b1, 0)
        h = jnp.where(k1.reshape(h.shape), h / (1 - p), 0.0)
        z = jnp.where(k2.reshape(x.shape), (h @ w2 + b2) / (1 - p), 0.0)
        return x + z

    want_y = jax_ffn(*map(jnp.asarray, args))
    got_y = torch_ffn(*map(_t, args), keep=keep, p=p)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-5,
                               atol=1e-5)
    want = jax.grad(lambda *a: jnp.sum(jax_ffn(*a) * cot),
                    argnums=tuple(range(7)))(*args)
    got = _grads_torch(lambda *a: torch_ffn(*a, keep=keep, p=p), args, cot)
    for g, e in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(e), **GRAD_TOL)
    # through ops on the CPU, with a seed: the same masks
    y = ops.ffn(*map(_t, args), p=p, training=True, seed=99)
    assert torch.equal(y, got_y.detach())


# ------------------------------------------------- schedules, optimizers

@pytest.mark.parametrize("scheduler", ["CosineAnnealing", "Single"])
@pytest.mark.parametrize("t_mult", [1, 2])
def test_schedules_match_jax(scheduler, t_mult):
    """200 steps at 10 iterations per epoch: warmup, cosine, restarts
    (cycles of 30 then 60 steps with t_mult 2). Both compute in float32;
    1e-5 relative covers a last-unit difference of cos or log, amplified
    near the end of a decay (measured 2.5e-6)."""
    argv = ["--lr-scheduler", scheduler, "--t_0", "3", "--t_up", "1",
            "--t_mult", str(t_mult), "--epochs", "4", "--batch-size", "16"]
    want = jax_trainer.build_schedule(jax_parse(argv), 10)
    got = port_trainer.build_schedule(parse_config(argv), 10)
    steps = np.arange(200)
    np.testing.assert_allclose([got(k) for k in steps],
                               [float(want(k)) for k in steps],
                               rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("optim", ["adamw", "adam", "sgd", "adamw_lars",
                                   "adam_lars", "sgd_lars"])
def test_optimizers_match_optax(optim):
    """Three updates of a small tree (one tensor starting at zero, so the
    trust ratio's zero-norm rule runs) at a decaying rate. 1e-5 on O(1)
    parameters that move by up to 0.1 a step: Adam's m / (sqrt(v) + eps)
    rounds differently in torch.optim and optax (measured 1.1e-6)."""
    argv = ["--optim", optim, "--weight_decay", "0.01", "--momentum", "0.8"]
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": np.zeros(5, np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    lr = lambda k: 0.1 / (1.0 + k)
    tx = jax_trainer.build_optimizer(jax_parse(argv), lr)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = port_trainer.Optimizer(parse_config(argv), list(tp.values()))
    for k, g in enumerate(grads):
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in tp.items():
            p.grad = _t(g[name])
        opt.step(lr(k))
        for name, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[name]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} step {k}")


# ------------------------------------------------------ the train step

B = 4
SMALL = ["--model", "tri_mbt_vsltcls", "--input-types", "vslt_txt",
         "--vslt-type", "TIE", "--imgtxt-time", "1",
         "--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--TIE-len", "64",
         "--transformer-num-layers", "2", "--transformer-dim", "64",
         "--transformer-num-head", "2", "--precision", "fp32"]


def _batch(cfg, seed=3):
    b = synthetic_batch(cfg, B, seed=seed)
    b["missing"][:, 2] = [0, 1, 0, 1]
    b["txt_length"][:] = [128, 0, 1, 0]
    b["txt"][1] = b["txt"][3] = 0.0
    b["txt"][2, 1:] = 0.0
    return b


# Train-state tolerances. fp32 on both sides, but the BatchNorm of the head
# normalises over the batch's 4 samples, which amplifies the summation-order
# noise: gradients differ by up to ~2e-4 of their tensor's largest entry
# (measured). Adam's update m / (sqrt(v) + eps) is O(lr) for every element,
# so an element whose gradient is within that noise (analytically zero: a
# key-projection bias, the biases before the BatchNorm) can step anywhere
# up to the learning rate on either side. Hence: moments within 2e-3 of
# their tensor's largest entry (plus a floor at the noise); parameters
# within 2e-6 plus 2 % of the summed learning rates where the first moment
# stands above the noise (|mu| >= MU_NOISE), and elsewhere within twice
# the summed learning rates (each side's step is at most about lr: at step
# t <= 2, |m_hat| / sqrt(v_hat) <= 1.001).
MOMENT_RTOL = 2e-3
MU_NOISE = 2e-4


def _close_to_tensor_max(got, want, rtol, floor, what):
    err = np.abs(got - want).max(initial=0.0)
    bound = rtol * np.abs(want).max(initial=0.0) + floor
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


def compare_train_state(cfg, jt, tr, lr_sum, bias_walk=0.0,
                        sq_rtol=MOMENT_RTOL):
    """Parameters, optimizer moments and BatchNorm statistics of a JAX
    Trainer and a port Trainer after the same steps. ``bias_walk``: an
    allowance on the running mean for longer runs. The running mean
    carries fc_list.0's bias, whose true gradient is zero (the BatchNorm
    cancels it), so each side's Adam walks it by noise, within the
    parameter bound below (2.01 lr_sum); the running mean, a weighted mean
    of batch means that include the bias, inherits that difference. A
    model whose heads hold no BatchNorm (the LayerNorm heads of the
    multitoken family) has no statistics to compare; one with a head per
    stream (tri_mbt_vnosh*) has each head's. ``sq_rtol``: the
    second moments' bound, which holds squared gradients (a gradient's
    relative error doubles in its square)."""
    jparams = jax.device_get(jt.state.params)
    want = params_from_jax(cfg, jparams)
    named = dict(tr.model.named_parameters())
    moments = optimizer_state_from_jax(cfg, jax.device_get(jt.state.opt_state),
                                       jparams)
    state = tr.optimizer.opt.state
    for key, tree in moments.items():
        for name, w in tree.items():
            if named[name].requires_grad:
                sq = key == "exp_avg_sq"
                _close_to_tensor_max(state[named[name]][key].numpy(),
                                     w.numpy(), sq_rtol if sq else MOMENT_RTOL,
                                     1e-10 if sq else 5e-6, f"{key} {name}")
    mu = moments.get("exp_avg", moments.get("momentum_buffer"))
    for name, w in want.items():
        err = np.abs(named[name].detach().numpy() - w.numpy())
        clear = np.abs(mu[name].numpy()) >= MU_NOISE
        bound = np.where(clear, 2e-6 + 0.02 * lr_sum, 2.01 * lr_sum + 2e-6)
        assert np.all(err <= bound), (name, err.max(), err[clear].max(
            initial=0.0))
    stats = jax.device_get(jt.state.batch_stats)
    if not stats:
        assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                       for m in tr.model.modules())
        return
    # every BatchNorm: the heads' (fc_list, fc_list_{m}), one at the
    # model's root (gru_d's bn), the backbones' nested ones
    sd = from_jax_variables(cfg, {"params": jparams, "batch_stats": stats})
    buffers = dict(tr.model.named_buffers())
    for name, w in sd.items():
        if name.endswith("running_mean"):
            _close_to_tensor_max(buffers[name].numpy(), w.numpy(), 1e-4,
                                 1e-6 + bias_walk, f"{name[:-13]} running mean")
        elif name.endswith("running_var"):
            _close_to_tensor_max(buffers[name].numpy(), w.numpy(), 1e-4,
                                 1e-6, f"{name[:-12]} running var")


def test_config2_train_steps_match_jax():
    """Two optimizer steps of config 2 (small width, --dropout 0) from the
    same weights: loss (1e-5), parameters, Adam moments and BatchNorm
    running statistics (tolerances at compare_train_state)."""
    argv = SMALL + ["--dropout", "0"]
    cfg = parse_config(argv)
    jcfg = jax_parse(argv)
    batches = [_batch(cfg, seed=s) for s in (3, 4)]
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batches[0])
        variables = jax.device_get({"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
        model = get_model(cfg)
        model.load_state_dict(from_jax_variables(cfg, variables), strict=True)
        tr = port_trainer.Trainer(cfg, model, "cpu", eval_only=False)
        lr_sum = 0.0
        for batch in batches:
            assert tr.current_lr() == pytest.approx(jt.current_lr(),
                                                    rel=1e-6)
            lr_sum += tr.current_lr()
            loss = tr.train_step(batch)
            assert loss == pytest.approx(float(jt.train_step(batch)),
                                         abs=1e-5)
        assert tr.step == 2 and int(jt.state.step) == 2
        compare_train_state(cfg, jt, tr, lr_sum)
    finally:
        jax_ops.configure(False)


@pytest.mark.parametrize("dropout", ["0", "0.1"])
def test_checkpoint_round_trip_resumes_exactly(tmp_path, dropout):
    """Three steps in one Trainer equal two steps, a save, a load into a
    fresh Trainer and one step, bit for bit: the model, the optimizer, the
    BatchNorm statistics and (with dropout) the masks of the resumed
    step."""
    cfg = parse_config(SMALL + ["--dropout", dropout])
    batches = [_batch(cfg, seed=s) for s in (3, 4, 5)]

    def fresh():
        return port_trainer.Trainer(cfg, get_model(cfg), "cpu",
                                    eval_only=False, seed=7)

    full = fresh()
    losses = [full.train_step(b) for b in batches]
    first = fresh()
    assert [first.train_step(b) for b in batches[:2]] == losses[:2]
    path = checkpoints.ckpt_path(str(tmp_path), "proj", "last", 0, 7)
    checkpoints.save_checkpoint(path, first, score=0.5, epoch=1,
                                last_step=2)
    payload = checkpoints.load_checkpoint(path)
    assert (payload["step"], payload["epoch"], payload["last_step"]) == \
        (2, 1, 2)
    resumed = fresh()
    checkpoints.restore(resumed, payload)
    assert resumed.step == 2
    assert resumed.train_step(batches[2]) == losses[2]
    want = full.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    opt_want = full.optimizer.state_dict()["state"]
    for i, st in resumed.optimizer.state_dict()["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_want[i][k]), (i, k)


def test_dropout_changes_the_step_and_needs_seeds():
    """With --dropout 0.1 the train step's loss depends on the run seed;
    a training-mode forward given no seeds raises."""
    cfg = parse_config(SMALL)
    batch = _batch(cfg)
    a, b = (port_trainer.Trainer(cfg, get_model(cfg), "cpu",
                                 eval_only=False, seed=s).train_step(batch)
            for s in (0, 1))
    assert a != b
    tr = port_trainer.Trainer(cfg, get_model(cfg), "cpu")
    tr.model.train()
    with pytest.raises(RuntimeError, match="DropoutSeeds"):
        b_ = tr.device_batch(batch)
        tr.model(b_, port_trainer.compute_missing_num(cfg, b_["missing"]))


class _AuxStub(torch.nn.Module):
    """A model of the (logits, rmse, aux) contract: logits from a linear
    map of the static features, and an auxiliary loss of its own weights
    (None with ``with_aux`` False)."""

    def __init__(self, with_aux):
        super().__init__()
        g = torch.Generator().manual_seed(5)
        self.w = torch.nn.Parameter(torch.randn(2, 1, generator=g))
        self.v = torch.nn.Parameter(torch.randn(3, generator=g))
        self.with_aux = with_aux

    def forward(self, b, missing_num, seeds=None):
        logits = (b["static"].float()[:, :2] @ self.w)[:, 0] + self.v[0]
        aux = (self.v ** 2).sum() + (self.w * self.v[1:, None]).sum()
        return logits, None, aux if self.with_aux else None


@pytest.mark.parametrize("with_aux", [True, False])
def test_train_step_adds_the_auxiliary_loss(with_aux):
    """Trainer.train_step adds auxiliary_loss_weight * aux when the model
    returns one (JAX trainer.py:463-468) and nothing when it returns None:
    its loss and gradients equal the loss written out by hand."""
    cfg = parse_config(SMALL + ["--auxiliary-loss-weight", "0.3"])
    batch = _batch(cfg)
    tr = port_trainer.Trainer(cfg, _AuxStub(with_aux), "cpu",
                              eval_only=False)
    loss = tr.train_step(batch)
    got = [p.grad.clone() for p in tr.model.parameters()]

    want_model = _AuxStub(with_aux)
    b = {k: torch.as_tensor(np.asarray(batch[k]))
         for k in port_trainer.BATCH_KEYS if k in batch}
    logits, _, aux = want_model(b, None)
    want = port_trainer.bce(logits, b["target"].float()).mean()
    if with_aux:
        want = want + 0.3 * aux
    want.backward()
    want = float(want.detach())
    assert abs(loss - want) <= 1e-6 * max(1.0, abs(want))
    for g, p in zip(got, want_model.parameters()):
        torch.testing.assert_close(g, p.grad, rtol=1e-6, atol=1e-7)
