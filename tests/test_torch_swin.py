"""The port's Swin trunk on the CPU: the plain versions of its two kernels
(torch_window_attention, torch_swin_mlp) against the JAX package's XLA
oracles and, once each, its Pallas kernels in interpret mode; a small
SwinTransformer against the flax one with weights carried across; and the
dispatch of both kernels. fp32 throughout: 1e-5 on O(1) values, the same
math summed in another order (the JAX swin_mlp's polynomial erf differs
from the real one by < 1.5e-7). The CUDA kernels are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.swin_attention import (
    pallas_window_attention, xla_window_attention)
from medical_tri_modal_pilot_tpu.kernels.swin_mlp import (pallas_swin_mlp,
                                                          xla_swin_mlp)
from medical_tri_modal_pilot_tpu.models import swin as jswin
from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.kernels.swin_attention import (
    cuda_window_attention, torch_window_attention)
from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import (
    cuda_swin_mlp, torch_swin_mlp)
from medical_tri_modal_pilot_tpu_torch.models import swin
from medical_tri_modal_pilot_tpu_torch.models.convert import swin_state_dict

ATOL = dict(atol=1e-5, rtol=1e-5)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(a, np.float32)


def _wa_args(I, C, nh, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda s, *shape: (s * rng.standard_normal(shape)).astype(np.float32)
    return (n(1, I, 49, C), n(C ** -.5, C, 3 * C), n(.1, 3 * C),
            n(C ** -.5, C, C), n(.1, C), n(.5, nh, 49, 49))


def _mlp_args(R, C, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda s, *shape: (s * rng.standard_normal(shape)).astype(np.float32)
    return (n(1, R, C), (1 + n(.1, C)).astype(np.float32), n(.1, C),
            n(C ** -.5, C, 4 * C), n(.1, 4 * C), n((4 * C) ** -.5, 4 * C, C),
            n(.1, C))


def _window_attention_both(args, smask, nh):
    want = xla_window_attention(*map(jnp.asarray, args),
                                None if smask is None else jnp.asarray(smask),
                                nh)
    got = torch_window_attention(
        *map(torch.from_numpy, args),
        None if smask is None else torch.from_numpy(smask), nh)
    return _np(got), _np(want)


# (C, heads, map): a stage-1-like map with 4 windows per image and the
# full-width head count of Swin-T's stage 1; two or three images, so the
# mask period M divides I = images * M
@pytest.mark.parametrize("C,nh,hw,images", [(64, 2, 14, 2), (96, 3, 21, 3)])
@pytest.mark.parametrize("shifted", [False, True])
def test_window_attention_plain_matches_xla(C, nh, hw, images, shifted):
    M = (hw // 7) ** 2
    args = _wa_args(images * M, C, nh)
    smask = jswin._shift_attn_mask(hw, hw, 7, 3) if shifted else None
    got, want = _window_attention_both(args, smask, nh)
    np.testing.assert_allclose(got, want, **ATOL)


def test_window_attention_mask_period():
    """Window i takes mask i % M: a mask that differs per window changes
    exactly the windows of that position in every image."""
    args = _wa_args(8, 64, 2, seed=1)
    smask = np.zeros((4, 49, 49), bool)
    smask[1, :, 10:] = True
    got, want = _window_attention_both(args, smask, 2)
    np.testing.assert_allclose(got, want, **ATOL)
    free, _ = _window_attention_both(args, None, 2)
    changed = np.abs(got - free).max(axis=(1, 2)) > 1e-6
    assert changed.tolist() == [False, True, False, False] * 2


def test_window_attention_plain_matches_pallas_interpret():
    args = _wa_args(8, 64, 2, seed=2)
    smask = jswin._shift_attn_mask(14, 14, 7, 3)
    kern = pallas_window_attention(*map(jnp.asarray, args),
                                   jnp.asarray(smask), 2)
    got, _ = _window_attention_both(args, smask, 2)
    # the Pallas kernel multiplies by 1/sqrt(d) where XLA divides
    np.testing.assert_allclose(got, _np(kern), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("R,C", [(70, 64), (49, 96)])
def test_swin_mlp_plain_matches_xla(R, C):
    args = _mlp_args(R, C)
    want = xla_swin_mlp(*map(jnp.asarray, args))
    got = torch_swin_mlp(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)


def test_swin_mlp_plain_matches_pallas_interpret():
    args = _mlp_args(70, 32, seed=3)
    kern = pallas_swin_mlp(*map(jnp.asarray, args))
    got = torch_swin_mlp(*map(torch.from_numpy, args))
    np.testing.assert_allclose(_np(got), _np(kern), **ATOL)


# ------------------------------------------------------------- trunk

SMALL = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2))


@pytest.fixture(scope="module")
def small_trunk():
    """The flax trunk at embed 32, depths (2, 2), heads (1, 2) on 56x56
    inputs (a 14x14 map of 4 windows, shifted in odd blocks; then 7x7,
    where the shift clamps to 0), every leaf perturbed, and its port."""
    img = np.random.default_rng(4).random((2, 1, 56, 56)).astype(np.float32)
    model = jswin.SwinTransformer(in_channels=1, **SMALL)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(img))["params"]
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), params)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(img))
    port = swin.SwinTransformer(in_channels=1, **SMALL)
    port.load_state_dict(swin_state_dict(params), strict=True)
    return port.eval(), img, want, params


def test_small_swin_matches_jax(small_trunk):
    port, img, want, _ = small_trunk
    with torch.inference_mode():
        got = port(torch.from_numpy(img))
    assert got.shape == (2, 7, 7, 64)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


def test_small_swin_nhwc_input_and_shift_clamp(small_trunk):
    port, img, want, _ = small_trunk
    with torch.inference_mode():
        got = port(torch.from_numpy(img).permute(0, 2, 3, 1))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)
    blocks = [b for stage in (port.features[1], port.features[3])
              for b in stage]
    cpu = torch.device("cpu")
    shifts = [b.attn.geometry(m, m, cpu)[1]
              for b, m in zip(blocks, (14, 14, 7, 7))]
    assert shifts == [0, 3, 0, 0]
    attn = blocks[1].attn
    smask, _ = attn.geometry(14, 14, cpu)
    bias = attn.frozen_bias()
    assert tuple(bias.shape) == (1, 49, 49) and tuple(smask.shape) == (4, 49,
                                                                       49)
    # the mask once per map size and device, whatever the table does; the
    # bias once, gathered again after the table changes
    assert attn.frozen_bias() is bias
    table = attn.relative_position_bias_table
    saved = table.detach().clone()
    with torch.no_grad():
        table.add_(1.0)
    assert torch.allclose(attn.frozen_bias(), bias + 1.0)
    assert attn.geometry(14, 14, cpu)[0] is smask
    with torch.no_grad():
        table.copy_(saved)


def test_swin_bridge_is_convert_swin_t_inverse(small_trunk):
    """port state_dict -> the JAX package's convert_swin_t -> the flax tree
    it came from, leaf for leaf (the merge permutation is a swap)."""
    from medical_tri_modal_pilot_tpu.models.convert import convert_swin_t
    port, _, _, params = small_trunk
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_swin_t(sd, in_channels=1, depths=SMALL["depths"])
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], str(k))
    assert not any("relative_position_index" in k
                   for k in port.state_dict())


# ---------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_swin_versions():
    ops.reset_launches()
    wa = [torch.from_numpy(a) for a in _wa_args(4, 64, 2)]
    assert torch.equal(ops.swin_attention(*wa, None, 2),
                       torch_window_attention(*wa, None, 2))
    mlp = [torch.from_numpy(a) for a in _mlp_args(9, 32)]
    assert torch.equal(ops.swin_mlp(*mlp), torch_swin_mlp(*mlp))
    assert ops.launches["swin_attention"] == ops.launches["swin_mlp"] == 0


def test_swin_wrappers_refuse_cpu_tensors_and_grads():
    wa = [torch.from_numpy(a) for a in _wa_args(4, 64, 2)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_window_attention(*wa, None, 2)
    mlp = [torch.from_numpy(a) for a in _mlp_args(9, 32)]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_swin_mlp(*mlp)
    # inputs that need a gradient take the autograd Function, whose
    # forward is the same launch and refuses them as well
    mlp[0].requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_swin_mlp(*mlp)
    wa[0].requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_window_attention(*wa, None, 2)
