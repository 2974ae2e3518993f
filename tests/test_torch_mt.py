"""The concat-fusion baseline ``*_mt_v1`` in the port against the JAX
package on the CPU: ``models/encoder.py::MTFusion`` against JAX
``MTFusion`` (fp32, perturbed weights, dropout 0; every row of the joint
stream within 1e-5) with and without layers per stream before the
fusion, the tri-modal layout and the bimodal one (whose second stream,
the notes, gets the image cls token), including a text stream masked
whole by the ``vlen == 2 -> 0`` rule (its queries attend uniformly in the
layers per stream); then ``bitxt_mt_v1`` and ``tri_mt_v1`` end to end
through tests/test_torch_variants.py's ``check_model`` (eval within 1e-5;
one train step: loss 1e-5, parameters and Adam moments (gradients 2e-4
relative) and the BatchNorm head's statistics at compare_train_state's
bounds), at --mbt-fusion-startIdx 1 with a sample whose note is masked
whole; and the weight bridge's names for every name of this slice.
``biimg_mt_v1`` and ``mt_v1``: tests/test_torch_mt_img.py."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import encoder as jenc
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import convert, get_model
from medical_tri_modal_pilot_tpu_torch.models.encoder import MTFusion
from test_torch_mbt_v1 import batch_for
from test_torch_unimodal import perturb
from test_torch_variants import B, KEY, NAMES, argv_for, check_model

ATOL = dict(atol=1e-5, rtol=1e-5)
D = 32


def _fusion_case(n_mod):
    """Inputs of a fusion at d 32: (vslt 20 rows, img 7, txt 9) or (vslt,
    txt); per sample the valid lengths, the notes' chosen so that one
    sample's text stream is masked whole (tri: 1 + 1 = 2 valid rows; bi:
    the image cls token adds one more, 0 + 1 + 1)."""
    rng = np.random.default_rng(11)
    lens = (20, 7, 9) if n_mod == 3 else (20, 9)
    inputs = [rng.standard_normal((B, L, D)).astype(np.float32)
              for L in lens]
    txt = np.array([8, 1, 4, 1]) if n_mod == 3 else np.array([8, 0, 4, 1])
    varying = [np.array([20, 5, 11, 1]), np.full(B, 7), txt + 1][:n_mod - 1]
    varying.append(txt + 1)
    mask = (True, False, True) if n_mod == 3 else (True, True)
    return inputs, varying, mask


@pytest.mark.parametrize("startidx", [0, 1])
@pytest.mark.parametrize("n_mod", [3, 2])
def test_mtfusion_matches_jax(n_mod, startidx):
    """Every row of the joint stream [B, 1 + sum L (+1), D] (or, with no
    fusion layer, the streams concatenated) within 1e-5, 2 layers, 2
    heads; the bridge's MTFusion names load strictly."""
    inputs, varying, mask = _fusion_case(n_mod)
    kw = dict(n_modality=n_mod, fusion_startidx=startidx, n_layers=2,
              n_head=2, d_model=D, d_ff=4 * D, dropout=0.0,
              txt_idx=n_mod - 1, mask=mask)
    jmod = jenc.MTFusion(**kw)
    jx = [jnp.asarray(x) for x in inputs]
    jv = [jnp.asarray(v) for v in varying]
    p = perturb(jax.jit(jmod.init)(KEY, jx, jv)["params"])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jmod.apply)({"params": p}, jx, jv))
    sd = {}
    convert._mt_fusion(sd, "f", p)
    mod = MTFusion(**kw)
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    got = mod.eval()([torch.from_numpy(x) for x in inputs],
                     [torch.from_numpy(v) for v in varying])
    assert got.shape == want.shape == (
        B, 1 + sum(x.shape[1] for x in inputs) + 1, D)
    np.testing.assert_allclose(got.detach().numpy(), want, **ATOL)


def _masked_note_batch(cfg):
    """batch_for's batch (every missing case) with sample 2's note one
    token long: 1 + 1 valid rows, which the tri-modal rule masks whole."""
    b = batch_for(cfg)
    b["txt_length"][2] = 1
    b["txt"][2, 1:] = 0.0
    return b


@pytest.mark.parametrize("name", ["bitxt_mt_v1", "tri_mt_v1"])
def test_mt_model_matches_jax(name):
    argv = argv_for(name, "--mbt-fusion-startIdx", "1")
    tr = check_model(argv, _masked_note_batch(parse_config(argv)))
    assert not tr.model.img_pack


def test_bridge_names():
    """For each name of this slice whose JAX model builds, the port's
    state_dict keys are the ones from_jax_variables writes for its JAX
    tree (every parameter and running statistic, nothing else), and the
    seeded port model is one the bridge raises on nothing of; a leaf the
    bridge does not use raises. flexibleavg and final_cls_tokens start at
    zero, as the JAX package initialises them."""
    for name in NAMES:
        if name.endswith("vflexible1"):
            continue
        argv = argv_for(name)
        jcfg, cfg = jax_parse(argv), parse_config(argv)
        jb = {k: jnp.asarray(v) for k, v in batch_for(cfg).items()}
        shapes = jax.eval_shape(
            lambda b: jax_get_model(jcfg).init(
                KEY, b, jnp.zeros(B, jnp.int32), True), jb)
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                             flax.core.unfreeze(shapes))
        sd = convert.from_jax_variables(cfg, zeros)
        port = get_model(cfg).state_dict()
        assert sd.keys() == port.keys(), name
        for k, v in sd.items():
            assert v.shape == port[k].shape, (name, k)
        for k in ("flexibleavg", "fusion_transformer.final_cls_tokens"):
            if k in port:
                assert not port[k].any(), (name, k)
    zeros["params"]["extra"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="extra"):
        convert.from_jax_variables(cfg, zeros)


