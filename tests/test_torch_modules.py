"""Each module of the port against its flax counterpart on the same numpy
inputs, weights carried across with the layout rules of
models/convert.py: StdLayerNorm, LayerNorm, the attention helpers, MHA on
both of its paths, the FFN, the encoder layer, UMSE, MBTFusion and the
classifier head. All in fp32 on the CPU, where the port takes its plain
kernel versions; 1e-5 absolute on O(1) activations (the same math summed
in another order), unless a test states otherwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.models import heads as jheads
from medical_tri_modal_pilot_tpu.models import mbt as jmbt
from medical_tri_modal_pilot_tpu.models import modules as jm
from medical_tri_modal_pilot_tpu.models import umse as jumse
from medical_tri_modal_pilot_tpu_torch.kernels.attention import \
    torch_masked_attention
from medical_tri_modal_pilot_tpu_torch.models import convert, heads, mbt
from medical_tri_modal_pilot_tpu_torch.models import modules as tm
from medical_tri_modal_pilot_tpu_torch.models import umse

ATOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(a, np.float32)


def _load(module, sd):
    """Load a converted state_dict, stripping the helper's key prefix."""
    sd = {k.split(".", 1)[1]: v for k, v in sd.items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def _perturb(params, seed=1):
    """Flax initialises norms to identity and biases to zero; randomise
    every leaf so each weight is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(a.shape))
        .astype(np.float32), params)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_std_layer_norm():
    x = _x(3, 7, 32)
    params = _perturb(jm.StdLayerNorm(32).init(KEY, x))["params"]
    want = jm.StdLayerNorm(32).apply({"params": params}, x)
    mod = tm.StdLayerNorm(32)
    mod.load_state_dict({"gamma": torch.from_numpy(params["gamma"]),
                         "beta": torch.from_numpy(params["beta"])})
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), _np(want),
                               **ATOL)


def test_std_layer_norm_zero_variance_row():
    """A constant row: the variance floor keeps the output at beta."""
    x = np.full((1, 2, 16), 3.0, np.float32)
    got = tm.stdln_apply(torch.from_numpy(x), torch.ones(16),
                         torch.full((16,), .5), torch.float32)
    want = jm.stdln_apply(jnp.asarray(x), jnp.ones(16), jnp.full(16, .5),
                          jnp.float32)
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)


def test_layer_norm():
    x = _x(4, 5, 32) * 3 + 1
    params = _perturb(jm.LayerNorm().init(KEY, x))["params"]
    want = jm.LayerNorm().apply({"params": params}, x)
    mod = tm.LayerNorm(32)
    mod.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                         "bias": torch.from_numpy(params["bias"])})
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), _np(want),
                               **ATOL)


def test_positional_encoding_and_length_mask():
    np.testing.assert_array_equal(_np(tm.positional_encoding(50, 32)),
                                  _np(jm.positional_encoding(50, 32)))
    lengths = np.array([0, 3, 9], np.int32)
    np.testing.assert_array_equal(
        tm.length_key_mask(torch.from_numpy(lengths), 9).numpy(),
        np.asarray(jm.length_key_mask(jnp.asarray(lengths), 9)))


@pytest.mark.parametrize("mask_dims", [2, 3])
def test_masked_softmax_attention(mask_dims):
    """Key masks and block masks, including fully masked query rows."""
    q, k, v = (_x(2, 6, 2, 8, seed=s) for s in range(3))
    rng = np.random.default_rng(3)
    if mask_dims == 2:
        mask = np.array([[True] * 6, [False] * 4 + [True] * 2])
    else:
        mask = rng.uniform(size=(2, 6, 6)) < .5
        mask[0, 1] = True
    want = jm.masked_softmax_attention(q, k, v, jnp.asarray(mask), 2.8)
    got = torch_masked_attention(*map(torch.from_numpy, (q, k, v)),
                                 torch.from_numpy(mask), 2.8)
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)


def _mha_sd(params):
    sd = {}
    for name in ("query_proj", "key_proj", "value_proj"):
        convert._lin(sd, f"m.{name}.linear", params[name])
    return sd


@pytest.mark.parametrize("fused", [False, True])
def test_multi_head_attention(fused):
    """Plain path (separate q/k/v, no prenorm) and the fused attn_block
    path (prenorm + residual), with a fully masked sample."""
    x = _x(3, 20, 32)
    mask = np.arange(20)[None, :] >= np.array([0, 7, 20])[:, None]
    gamma = 1 + .1 * _x(32, seed=4)
    beta = .1 * _x(32, seed=5)
    jmha = jm.MultiHeadAttention(32, 4)
    kw = dict(prenorm=(jnp.asarray(gamma), jnp.asarray(beta))) if fused \
        else {}
    jx = jnp.asarray(x)

    def call(mdl, x):
        return mdl(x, x, x, jnp.asarray(mask), residual=x, **kw)

    params = _perturb(jmha.init(KEY, jx, method=call))["params"]
    want = jmha.apply({"params": params}, jx, method=call)
    mod = _load(tm.MultiHeadAttention(32, 4), _mha_sd(params))
    tx = torch.from_numpy(x)
    tkw = dict(prenorm=(torch.from_numpy(gamma), torch.from_numpy(beta))) \
        if fused else {}
    got = mod(tx, tx, tx, torch.from_numpy(mask), residual=tx, **tkw)
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)


def test_feed_forward_and_mlp_stem():
    x = _x(2, 9, 32)
    ff = jm.FeedForward(32, 128)
    p = _perturb(ff.init(KEY, x))["params"]
    sd = {}
    for w in ("w_1", "w_2"):
        kern = np.asarray(p[w]["kernel"])
        sd[f"{w}.weight"] = torch.from_numpy(kern.T[:, :, None].copy())
        sd[f"{w}.bias"] = torch.from_numpy(p[w]["bias"])
    mod = tm.FeedForward(32, 128)
    mod.load_state_dict(sd)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))),
                               _np(ff.apply({"params": p}, x)), **ATOL)

    demo = np.random.default_rng(1).uniform(size=(5, 2)).astype(np.float32)
    stem = jm.MLPStem(32)
    ps = _perturb(stem.init(KEY, demo))["params"]
    sd = {}
    convert._stem(sd, "s", ps)
    got = _load(tm.MLPStem(2, 32), sd)(torch.from_numpy(demo))
    np.testing.assert_allclose(_np(got), _np(stem.apply({"params": ps}, demo)),
                               **ATOL)


def _layer_and_mask(L=24, C=32, seed=0):
    x = _x(3, L, C, seed=seed)
    mask = np.arange(L)[None, :] >= np.array([0, 9, L])[:, None]
    return x, mask


def test_encoder_layer():
    x, mask = _layer_and_mask()
    layer = jm.TransformerEncoderLayer(32, 4, 128)
    p = _perturb(layer.init(KEY, x, jnp.asarray(mask)))["params"]
    want = layer.apply({"params": p}, x, jnp.asarray(mask))
    sd = {}
    convert._encoder_layer(sd, "l", p)
    mod = _load(tm.TransformerEncoderLayer(32, 4, 128), sd)
    got = mod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)


def test_encoder_layer_refuses_training_mode():
    """The refusal went with the training path: an encoder layer in
    training mode matches the flax layer's training forward
    (deterministic=False) at dropout 0, value and input gradient."""
    x, mask = _layer_and_mask(seed=2)
    layer = jm.TransformerEncoderLayer(32, 4, 128, dropout_p=0.0)
    p = _perturb(layer.init(KEY, x, jnp.asarray(mask)))["params"]
    cot = _x(*x.shape, seed=3)

    def loss(xx):
        y = layer.apply({"params": p}, xx, jnp.asarray(mask),
                        deterministic=False)
        return jnp.sum(y * cot), y

    (_, want), dx = jax.value_and_grad(loss, has_aux=True)(x)
    sd = {}
    convert._encoder_layer(sd, "l", p)
    mod = _load(tm.TransformerEncoderLayer(32, 4, 128, dropout_p=0.0),
                sd).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    got = mod(xt, torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(_np(got), _np(want), **ATOL)
    np.testing.assert_allclose(_np(xt.grad), _np(dx), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("L", [64, 192])
def test_ffn_row_blocks(L):
    """Tiles of 64 rows are skippable only when every row is a masked key;
    an all-masked sample keeps every tile. Grouped to the TPU kernel's 256
    rows, the flags are the JAX package's."""
    x = np.zeros((3, L, 8), np.float32)
    lengths = np.array([0, 70, 3])
    mask = np.arange(L)[None, :] >= lengths[:, None]
    got = tm.ffn_row_blocks(torch.from_numpy(x), torch.from_numpy(mask))
    want = np.stack([np.ones(L // 64, bool), np.arange(L // 64) * 64 < 70,
                     np.arange(L // 64) == 0])
    np.testing.assert_array_equal(got.numpy(), want)
    jflags = jm._ffn_row_blocks(jnp.asarray(x), jnp.asarray(mask))
    if L % 256 == 0:
        np.testing.assert_array_equal(
            got.reshape(3, -1, 4).any(-1).numpy(), np.asarray(jflags))
    assert tm.ffn_row_blocks(torch.zeros(3, L + 1, 8),
                             torch.zeros(3, L + 1, dtype=torch.bool)) is None


def _umse_inputs(B=4, L=30, seed=0):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(-24, 0, (B, L)), rng.uniform(0, 1, (B, L)),
                  rng.integers(0, 18, (B, L))], axis=-1).astype(np.float32)
    return (x, rng.uniform(size=B).astype(np.float32),
            rng.integers(0, 2, B).astype(np.float32),
            rng.standard_normal((B, 5, 768)).astype(np.float32),
            rng.uniform(-24, 0, B).astype(np.float32))


def test_umse():
    """TIE tokens (the umse op), the demographics stem, the BioBERT
    projection and the txt timestamp enrichment."""
    x, age, gen, txt, t = _umse_inputs()

    def run(mdl, x, age, gen, txt, t):
        tokens, demo = mdl.embed_vslt(x, age, gen)
        return tokens, demo, mdl.add_time_feature(mdl.embed_txt(txt), t, 19)

    jmod = jumse.UMSE(d_model=32, imgtxt_time=1)
    p = _perturb(jmod.init(KEY, x, age, gen, txt, t, method=run))["params"]
    want = jmod.apply({"params": p}, x, age, gen, txt, t, method=run)
    sd = {}
    for name in ("ie_vslt", "ie_time", "ie_demo"):
        convert._stem(sd, name, p[name])
    sd["ie_feat.weight"] = convert._t(p["ie_feat"]["embedding"])
    convert._lin(sd, "txt_embedding", p["txt_embedding"])
    mod = umse.UMSE(d_model=32).eval()
    mod.load_state_dict(sd, strict=True)
    got = run(mod, *map(torch.from_numpy, (x, age, gen, txt, t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **ATOL)


# (missing_num, resbottle, fusion_startidx, vsltonly, vslt tokens)
FUSION_CASES = [
    (0, False, 0, 0, 40), (1, False, 0, 0, 40), (0, True, 0, 0, 40),
    (1, True, 1, 0, 40),   # layer 0 runs the streams alone: txt all masked
    (0, False, 0, 1, 40),  # vsltonly: last layer skips the txt stream
    (1, False, 0, 0, 520),  # a long stream, pre-padded to 256-row tiles
]


@pytest.mark.parametrize("missing,resbottle,startidx,vsltonly,L",
                         FUSION_CASES)
def test_mbt_fusion(missing, resbottle, startidx, vsltonly, L):
    """Bimodal vslt+txt fusion, 2 layers. Text lengths hold the
    varying == 2 (vlen 3 -> 0) sample; missing_num mixes per sample."""
    B, D = 4, 32
    enc = [_x(B, L, D, seed=1), _x(B, 12, D, seed=2)]
    varying = [np.array([L, 5, 17, 1], np.int32),
               np.array([2, 14, 7, 3], np.int32)]
    missing_num = np.array([missing, 1 - missing, missing, 0], np.int32)
    kw = dict(n_modality=2, bottlenecks_n=4, fusion_startidx=startidx,
              n_layers=2, n_head=4, d_model=D, d_ff=4 * D, txt_idx=1,
              vsltonly=vsltonly, resbottle=resbottle, use_pe=(False, True),
              mask=(True, True))
    jf = jmbt.MBTFusion(dropout=0.0, **kw)
    jargs = ([jnp.asarray(e) for e in enc], [jnp.asarray(v) for v in varying],
             jnp.asarray(missing_num))
    p = _perturb(jf.init(KEY, *jargs))["params"]
    want = jf.apply({"params": p}, *jargs)
    sd = {}
    convert._fusion(sd, "f", p, 2)
    mod = _load(mbt.MBTFusion(**kw), sd)
    got = mod([torch.from_numpy(e) for e in enc],
              [torch.from_numpy(v) for v in varying],
              torch.from_numpy(missing_num))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **ATOL)


def test_cls_head_eval_uses_running_stats():
    x = _x(6, 64)
    head = jheads.ClsHead(32, 1)
    v = head.init(KEY, x, True)
    p = _perturb(v["params"])
    rng = np.random.default_rng(7)
    stats = {"bn": {"mean": rng.normal(0, .3, 32).astype(np.float32),
                    "var": rng.uniform(.5, 2, 32).astype(np.float32)}}
    want = head.apply({"params": p, "batch_stats": stats}, x, True)
    sd = {}
    convert._lin(sd, "h.0", p["fc1"])
    convert._lin(sd, "h.3", p["fc2"])
    sd.update({"h.1.weight": convert._t(p["bn"]["scale"]),
               "h.1.bias": convert._t(p["bn"]["bias"]),
               "h.1.running_mean": convert._t(stats["bn"]["mean"]),
               "h.1.running_var": convert._t(stats["bn"]["var"]),
               "h.1.num_batches_tracked": torch.tensor(0)})
    mod = _load(heads.ClsHead(64, 32, 1), sd)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), _np(want),
                               **ATOL)


def test_missing_candidate_weights():
    for n in (2, 3):
        np.testing.assert_array_equal(mbt.missing_candidate_weights(n),
                                      jmbt.missing_candidate_weights(n))
    with pytest.raises(ValueError):
        mbt.missing_candidate_weights(4)
