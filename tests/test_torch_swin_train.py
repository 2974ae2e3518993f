"""The trainable Swin trunk on the CPU (--img-pretrain No, tri_mbt_v2,
fusiontrainer): the autograd Functions of ``swin_attention`` and
``swin_mlp`` (forward: the kernel, here its plain version in the
kernel's place; backward: the plain version recomputed under autograd)
against the JAX package's custom-VJP backward (``jax.vjp`` of its XLA
oracles), the whole trunk's parameter gradients through those Functions
against ``jax.grad`` of the flax trunk at a narrow geometry, and
stochastic depth: the branch without its residual against JAX
``mlp_branch``, the masks of a block (Philox of the step's seeds, the
attention's then the MLP's, identical to ``plain_dropout_masks``), the
drop probabilities per block and the keep rate within binomial bounds.
fp32; outputs within 1e-5, gradients per tensor within 1e-4 of its
largest entry (sums over 49-token windows and 4C hidden units in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.swin_attention import \
    xla_window_attention
from medical_tri_modal_pilot_tpu.kernels.swin_mlp import (mlp_branch,
                                                          xla_swin_mlp)
from medical_tri_modal_pilot_tpu.models import swin as jswin
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.kernels import swin_attention as ksa
from medical_tri_modal_pilot_tpu_torch.kernels import swin_mlp as ksm
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import plain_dropout_masks
from medical_tri_modal_pilot_tpu_torch.models import swin
from medical_tri_modal_pilot_tpu_torch.models.convert import swin_state_dict
from medical_tri_modal_pilot_tpu_torch.models.modules import DropoutSeeds
from test_torch_swin import _mlp_args, _np, _wa_args

ATOL = dict(atol=1e-5, rtol=1e-5)
GRAD_RTOL = 1e-4
# a narrow trunk with Swin-T's output width: 16 x 16 patches of 384
# channels (a 14 x 14 map of 4 windows at 224, shifted in block 1), then
# one merge to 768 (7 x 7, the shift clamped to 0); 4 blocks, stochastic
# depth 0, 0.2/3, 0.4/3, 0.2
NARROW = dict(embed_dim=384, depths=(2, 2), num_heads=(12, 24),
              patch_size=16)


@pytest.fixture
def functions_on_cpu(monkeypatch):
    """The ops route through the autograd Functions with the plain forward
    in the kernel's place (counted), as a CUDA tensor would."""
    calls = {"swin_attention": 0, "swin_mlp": 0}

    def attention(*a):
        calls["swin_attention"] += 1
        return ksa.torch_window_attention(*a[:-1])

    def mlp(*a):
        calls["swin_mlp"] += 1
        return ksm.torch_swin_mlp(*a[:-1])

    monkeypatch.setattr(ksa, "_launch_fwd", attention)
    monkeypatch.setattr(ksm, "_launch_fwd", mlp)
    monkeypatch.setattr(ops, "swin_attention", ksa.cuda_window_attention)
    monkeypatch.setattr(ops, "swin_mlp", ksm.cuda_swin_mlp)
    ops.reset_launches()
    return calls


def _jax_vjp(fn, args, cot):
    """(out, cotangents of args) of the JAX ``fn`` under ``cot``, jitted
    as one program (op by op it takes seconds on the CPU)."""
    def f(c, *a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(c)
    return jax.jit(f)(jnp.asarray(cot), *map(jnp.asarray, args))


def _grads(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    out.backward(torch.from_numpy(cot))
    return out, [t.grad for t in ts]


@pytest.mark.parametrize("shifted", [False, True])
def test_swin_attention_function_backward_matches_jax(functions_on_cpu,
                                                      shifted):
    """dx, dW_qkv, db_qkv, dW_proj, db_proj and the bias cotangent."""
    args = _wa_args(8, 64, 2, seed=6)
    smask = jswin._shift_attn_mask(14, 14, 7, 3) if shifted else None
    cot = np.random.default_rng(7).standard_normal(
        args[0].shape).astype(np.float32)
    tmask = None if smask is None else torch.from_numpy(smask)
    out, got = _grads(lambda *t: ksa.cuda_window_attention(*t, tmask, 2),
                      args, cot)
    assert functions_on_cpu["swin_attention"] == 1
    assert ops.recomputes["swin_attention_bwd"] == 1
    jm = None if smask is None else jnp.asarray(smask)
    want, wgrads = _jax_vjp(lambda *a: xla_window_attention(*a, jm, 2),
                            args, cot)
    np.testing.assert_allclose(_np(out), _np(want), **ATOL)
    for g, w in zip(got, wgrads):
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= GRAD_RTOL * np.abs(w).max()
    # the same as autograd of the plain version, bit for bit
    _, plain = _grads(lambda *t: ksa.torch_window_attention(*t, tmask, 2),
                      args, cot)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


def test_swin_mlp_function_backward_matches_jax(functions_on_cpu):
    args = _mlp_args(70, 64, seed=8)
    cot = np.random.default_rng(9).standard_normal(
        args[0].shape).astype(np.float32)
    out, got = _grads(ksm.cuda_swin_mlp, args, cot)
    assert functions_on_cpu["swin_mlp"] == 1
    assert ops.recomputes["swin_mlp_bwd"] == 1
    want, wgrads = _jax_vjp(xla_swin_mlp, args, cot)
    np.testing.assert_allclose(_np(out), _np(want), **ATOL)
    for g, w in zip(got, wgrads):
        w = _np(w)
        assert np.abs(_np(g) - w).max() <= GRAD_RTOL * np.abs(w).max()


def test_mlp_branch_matches_jax():
    """The stochastic-depth blocks' MLP branch, without the residual."""
    args = _mlp_args(70, 64, seed=10)
    got = ksm.torch_mlp_branch(*map(torch.from_numpy, args))
    want = jax.jit(mlp_branch)(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)


@pytest.fixture(scope="module")
def narrow_jax():
    """The flax trunk at NARROW: its init's parameters (every bias 0) and
    the jitted (<out, cot>, out) and gradients of (params, img, cot) on
    two 224 x 224 images (deterministic), compiled once for the file."""
    model = jswin.SwinTransformer(in_channels=1, **NARROW)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((2, 1, 224, 224)))["params"]

    def f(p, img, cot):
        out = model.apply({"params": p}, img, True)
        return jnp.sum(out * cot), out

    return params, jax.jit(jax.value_and_grad(f, has_aux=True))


@pytest.fixture(scope="module")
def narrow_trunk(narrow_jax):
    """The flax trunk at NARROW on two 224 x 224 images, every leaf
    perturbed, its output and the gradients of <out, cot> with respect
    to its parameters (deterministic), and the port trunk carrying the
    weights."""
    rng = np.random.default_rng(11)
    img = rng.random((2, 1, 224, 224)).astype(np.float32)
    params, grad_fn = narrow_jax
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), params)
    cot = rng.standard_normal((2, 7, 7, 768)).astype(np.float32)
    (_, out), grads = grad_fn(params, jnp.asarray(img), jnp.asarray(cot))
    port = swin.SwinTransformer(in_channels=1, **NARROW)
    port.load_state_dict(swin_state_dict(params), strict=True)
    return port, img, cot, np.asarray(out), swin_state_dict(
        jax.device_get(grads))


def test_trunk_gradients_match_jax(narrow_trunk, functions_on_cpu):
    """Every trunk parameter's gradient (the relative-position tables'
    through the gather of their bias) through the Functions, eval mode
    (no stochastic depth), against jax.grad of the flax trunk."""
    port, img, cot, want_out, want = narrow_trunk
    port.eval()
    port.zero_grad(set_to_none=True)
    out = port(torch.from_numpy(img))
    np.testing.assert_allclose(_np(out), want_out, atol=2e-5, rtol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    assert functions_on_cpu == {"swin_attention": 4, "swin_mlp": 4}
    assert ops.recomputes == {"swin_attention_bwd": 4, "swin_mlp_bwd": 4}
    grads = dict(port.named_parameters())
    assert grads.keys() == want.keys()
    for name, p in grads.items():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max() + 1e-7, (name, err)


def test_stochastic_depth_masks(narrow_trunk):
    """Training mode: block k drops with 0.2 k / 3 (block 0 never, and it
    keeps the fused op); a dropping block takes two seeds, the
    attention's then the MLP's, and its output is x + keep_a attn / q,
    then + keep_m mlp_branch / q, with the keep masks of
    plain_dropout_masks over the images (the kernel's Philox bits on the
    card)."""
    port = narrow_trunk[0]
    blocks = [b for st in (port.features[1], port.features[2 + 1])
              for b in st]
    assert [b.sd_prob for b in blocks] == pytest.approx(
        [0.0, 0.2 / 3, 0.4 / 3, 0.2])
    blk = blocks[3]
    blk.train()
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (16, 7, 7, 768)).astype(np.float32))
    seeds = DropoutSeeds(5, 3)
    with torch.no_grad():
        got = blk(x, seeds)
    assert seeds.calls == 2
    ref = DropoutSeeds(5, 3)
    q = torch.tensor(0.8)
    keep = [plain_dropout_masks(16, 0, 1, ref.next(), 0.2)[1].reshape(
        16, 1, 1, 1) for _ in range(2)]
    with torch.no_grad():
        h = x + torch.where(keep[0], blk.attn(blk.norm1(x)) / q, 0.0)
        fc1, fc2 = blk.mlp[0], blk.mlp[3]
        o = ksm.torch_mlp_branch(h.reshape(-1, 768), blk.norm2.weight,
                                 blk.norm2.bias, fc1.weight.t(), fc1.bias,
                                 fc2.weight.t(), fc2.bias).reshape(h.shape)
        want = h + torch.where(keep[1], o / q, 0.0)
    assert torch.equal(got, want)
    assert 0 < int(keep[0].sum()) < 16 or 0 < int(keep[1].sum()) < 16
    blk.eval()
    seeds = DropoutSeeds(5, 3)
    blocks[0].train()
    with torch.no_grad():
        blocks[0](torch.zeros(2, 14, 14, 384), seeds)
    blocks[0].eval()
    assert seeds.calls == 0


def test_stochastic_depth_keep_rate():
    """Over 200000 rows the keep rate of the last block's masks lies within
    5 standard deviations of 0.8."""
    n = 200_000
    _, keep = plain_dropout_masks(n, 0, 1, DropoutSeeds(1, 0).next(), 0.2)
    rate = float(keep.float().mean())
    assert abs(rate - 0.8) <= 5 * (0.16 / n) ** 0.5


def test_trunk_train_mode_draws_its_seeds(narrow_trunk):
    """A training forward of the trunk draws two seeds per dropping block
    (6 here) and differs from eval; without seeds it raises."""
    port, img = narrow_trunk[:2]
    port.train()
    seeds = DropoutSeeds(2, 0)
    x = torch.from_numpy(img)
    try:
        with torch.no_grad():
            train = port(x, seeds)
            with pytest.raises(RuntimeError, match="DropoutSeeds"):
                port(x)
    finally:
        port.eval()
    assert seeds.calls == 6
    with torch.no_grad():
        assert not torch.allclose(train, port(x))


def test_live_bias_follows_the_table(narrow_trunk, monkeypatch):
    """Under autograd the bias is gathered from the table on every call,
    equal to the cached one; such a forward gathers no detached bias, and
    its cotangent reaches the table. The shift mask stays the one built
    first, whatever the table does."""
    attn = narrow_trunk[0].features[1][1].attn
    live = attn.live_bias()
    assert live.requires_grad
    assert torch.equal(live.detach(), attn.frozen_bias())
    cpu = torch.device("cpu")
    smask = attn.geometry(14, 14, cpu)[0]
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 14, 14, 384)).astype(np.float32))
    with monkeypatch.context() as mp:
        mp.setattr(attn, "frozen_bias",
                   lambda: pytest.fail("detached bias gathered"))
        attn(x).sum().backward()
    table = attn.relative_position_bias_table
    saved = table.detach().clone()
    try:
        assert table.grad is not None and table.grad.abs().max() > 0
        with torch.no_grad():
            table.add_(1.0)
        assert attn.geometry(14, 14, cpu)[0] is smask
    finally:
        with torch.no_grad():
            table.copy_(saved)
        attn.zero_grad(set_to_none=True)



def test_seeded_trunk_takes_a_zero_image():
    """A missing CXR is a zero image. At the JAX package's init (every
    bias 0) it stays exactly 0 through the trunk, so each LayerNorm sees
    variance 0 and multiplies its cotangent by 1/sqrt(eps), and the
    gradient overflows fp32 (ROADMAP Queue 3); the port's init draws the
    stem convolution's bias of a trunk that trains as torch's Conv2d
    does, so the full Swin-T's gradients stay finite under a cotangent of
    10 on every output, while with that bias zeroed the features of the
    zero image are exactly 0. A frozen trunk's stem bias stays 0, as
    JAX draws it."""
    from medical_tri_modal_pilot_tpu_torch.models.registry import \
        init_parameters
    trunk = swin.SwinTransformer(in_channels=1).eval()
    init_parameters(trunk, torch.Generator().manual_seed(0))
    assert trunk.features[0][0].bias.abs().max() > 0
    img = torch.zeros(1, 1, 224, 224)
    (10 * trunk(img)).sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in trunk.parameters())
    with torch.no_grad():
        trunk.features[0][0].bias.zero_()
        assert not trunk(img).any()
    init_parameters(trunk.requires_grad_(False),
                    torch.Generator().manual_seed(0))
    assert not trunk.features[0][0].bias.any()


def test_zero_bias_trunk_fails_alike_in_both_packages(narrow_jax):
    """A trunk carried in from the JAX package's init (every bias 0) on
    zero images: both packages output exactly 0, and under a seeded
    cotangent each LayerNorm at variance 0 multiplies it by up to
    1/sqrt(eps) on both sides alike, every gradient within 1e-4 of its
    largest entry, the stem bias's above 1e25 (what overflows fp32 at
    Swin-T's depth, ROADMAP Queue 3)."""
    params, grad_fn = narrow_jax
    img = np.zeros((2, 1, 224, 224), np.float32)
    cot = np.random.default_rng(3).standard_normal(
        (2, 7, 7, 768)).astype(np.float32)
    (_, out), grads = grad_fn(params, jnp.asarray(img), jnp.asarray(cot))
    want = swin_state_dict(jax.device_get(grads))
    port = swin.SwinTransformer(in_channels=1, **NARROW)
    port.load_state_dict(swin_state_dict(jax.device_get(params)),
                         strict=True)
    got = port.eval()(torch.from_numpy(img))
    assert not np.asarray(out).any() and not got.any()
    (got * torch.from_numpy(cot)).sum().backward()
    for name, p in port.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (name, err)
    assert np.abs(want["features.0.0.bias"].numpy()).max() > 1e25
