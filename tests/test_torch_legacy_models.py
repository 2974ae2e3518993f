"""The legacy families of the port (models/legacy.py, models/resnet.py,
models/vit.py, models/maxvit.py) against the JAX package on the CPU: the
registry's 72 names, the 1_uni_vslt transformers, the image classifiers
over every backbone kind, the ViT in the MBT image encoder, and the
pretrain windows (data/synthetic.py, data/window.py).

Small: 2 layers, d 64, 2 heads, batch 4, window 24, fp32; the CXR
backbones as modules at reduced depth and width where their JAX default
is large (``SMALL_BACKBONES``: ViT 2 x 64, MaxViT two stages of 16 / 32
at window 2; the Swin-T trunk at tests/test_torch_swin_train.py's
``NARROW``), patched into both packages alike; ResNet-18 / 50 as they
are, on 64 x 64 images. JAX weights are seeded draws of its init's
shapes (tests/test_torch_unimodal.py::draw_like) with random running
statistics in every BatchNorm, carried across by ``from_jax_variables``.
Eval outputs within 1e-5 of the JAX ``model.apply``; two train steps at
--dropout 0 against the JAX Trainer (tests/test_torch_train.py::
compare_train_state, every BatchNorm's running statistics included)."""
import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.data import window as jax_window
from medical_tri_modal_pilot_tpu.models import available_models
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.models import legacy as jax_legacy
from medical_tri_modal_pilot_tpu.models import maxvit as jax_maxvit
from medical_tri_modal_pilot_tpu.models import models as jax_models
from medical_tri_modal_pilot_tpu.models import swin as jax_swin
from medical_tri_modal_pilot_tpu.models import vit as jax_vit
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data import window
from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
    synthetic_batch, to_wire)
from medical_tri_modal_pilot_tpu_torch.models import (convert, get_model,
                                                      legacy, maxvit,
                                                      models, registry,
                                                      swin, vit)
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_swin_train import NARROW
from test_torch_train import compare_train_state
from test_torch_unimodal import draw_like

ATOL = 1e-5
KEY = jax.random.PRNGKey(0)
B = 4
SMALL = ["--vslt-type", "carryforward", "--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--transformer-num-layers", "2",
         "--transformer-dim", "64", "--transformer-num-head", "2",
         "--precision", "fp32", "--img-model-type", "resnet18"]
# the reduced backbones: (module attribute, JAX class, port class, kwargs)
SMALL_BACKBONES = {
    "VisionTransformer": (jax_vit.VisionTransformer, vit.VisionTransformer,
                          dict(num_layers=2, num_heads=2, hidden_dim=64,
                               mlp_dim=128)),
    "MaxViT": (jax_maxvit.MaxViT, maxvit.MaxViT,
               dict(widths=(16, 32), depths=(1, 1), heads=(1, 2),
                    window=2)),
    "SwinTransformer": (jax_swin.SwinTransformer, swin.SwinTransformer,
                        NARROW),
}


def argv_for(model, input_types="vslt", *extra):
    return SMALL + ["--model", model, "--input-types", input_types] + \
        list(extra)


def configs(argv, **replace):
    """The port's and the JAX package's Config of ``argv``, with
    ``replace`` (fields the command line does not take: a smaller image,
    an auxiliary loss type of the auxcpc family)."""
    return (parse_config(argv).replace(**replace),
            jax_parse(argv).replace(**replace))


@pytest.fixture
def small_backbones(monkeypatch):
    """The reduced backbones in both packages' legacy and MBT modules."""
    for name, (jcls, pcls, kw) in SMALL_BACKBONES.items():
        for mod, cls in ((jax_legacy, jcls), (jax_models, jcls),
                         (legacy, pcls), (models, pcls)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name,
                                    functools.partial(cls, **kw))
    yield
    jax_ops.configure(False)


def random_stats(tree, seed=1):
    """Random running statistics in every BatchNorm of a batch_stats
    tree (nested: the backbones' too)."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if "mean" in node and "var" in node:
            node["mean"] = rng.normal(0, .3, np.shape(node["mean"])).astype(
                np.float32)
            node["var"] = rng.uniform(.5, 2, np.shape(node["var"])).astype(
                np.float32)
            return
        for sub in node.values():
            fill(sub)
    fill(tree)
    return tree


def jnp_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


class Pair:
    """One model on both sides: the JAX module with seeded variables of
    its init's shapes and random running statistics (``variables``, or
    those given), the port model carrying them (eval mode), and the JAX
    eval forward (``jax_apply``: compiled once, or with ``jit=False`` op
    by op, which reuses the primitives another model compiled at the same
    shapes)."""

    def __init__(self, cfg, jcfg, batch, variables=None, jit=True):
        self.cfg, self.jcfg = cfg, jcfg
        self.jmodel = jax_get_model(jcfg)
        if variables is None:
            jb = jnp_batch(batch)
            shapes = flax.core.unfreeze(jax.eval_shape(
                lambda b: self.jmodel.init(
                    {"params": KEY, "dropout": KEY}, b,
                    jnp.zeros(B, jnp.int32), True), jb))
            variables = {
                "params": draw_like(shapes["params"]),
                "batch_stats": random_stats(jax.tree.map(
                    lambda s: np.zeros(s.shape, np.float32),
                    shapes.get("batch_stats", {})))}
        self.variables = variables
        self.model = get_model(cfg)
        self.model.load_state_dict(
            convert.from_jax_variables(cfg, self.variables), strict=True)

        def apply(v, b, mn):
            return self.jmodel.apply(v, b, mn, True)
        self._apply = jax.jit(apply) if jit else apply

    def jax_apply(self, batch, variables=None):
        jb = jnp_batch(batch)
        mn = jax_trainer.compute_missing_num(self.jcfg, jb["missing"])
        return self._apply(variables or self.variables, jb, mn)

    def port_apply(self, batch):
        self.model.eval()
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        with torch.no_grad():
            return self.model(b, trainer.compute_missing_num(
                self.cfg, b["missing"]))


def check_eval(cfg, jcfg, batch):
    """The port's logits and its Trainer's eval step (probabilities, mean
    BCE) against the JAX apply's, within 1e-5. Returns the Pair and both
    sides' outputs."""
    pair = Pair(cfg, jcfg, batch)
    want = pair.jax_apply(batch)
    got = pair.port_apply(batch)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=ATOL, rtol=ATOL)
    probs, loss, _ = trainer.Trainer(cfg, pair.model, "cpu").eval_step(
        batch)
    want_probs = np.asarray(jax.nn.sigmoid(want[0]))
    np.testing.assert_allclose(probs, want_probs, atol=ATOL)
    want_loss = float(jax_trainer._bce(np.asarray(want[0]),
                                       batch["target"]).mean())
    assert loss == pytest.approx(want_loss, abs=ATOL)
    return pair, got, want


def check_train(cfg, jcfg, batches):
    """Two optimizer steps at --dropout 0 from the JAX Trainer's initial
    weights (its init, every BatchNorm at mean 0 / var 1): each step's
    loss within 1e-5, then parameters, Adam moments and every running
    statistic (compare_train_state). Returns the port Trainer."""
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batches[0])
        variables = jax.device_get({"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
        model = get_model(cfg)
        model.load_state_dict(convert.from_jax_variables(cfg, variables),
                              strict=True)
        tr = trainer.Trainer(cfg, model, "cpu", eval_only=False)
        lr_sum = 0.0
        for batch in batches:
            assert tr.current_lr() == pytest.approx(jt.current_lr(),
                                                    rel=1e-6)
            lr_sum += tr.current_lr()
            loss = tr.train_step(batch)
            assert loss == pytest.approx(float(jt.train_step(batch)),
                                         abs=ATOL)
        compare_train_state(cfg, jt, tr, lr_sum)
        return tr
    finally:
        jax_ops.configure(False)


def image_batch(cfg, seed=3, n=B):
    """A synthetic batch with half its CXRs present (the missing ones
    zeros)."""
    return synthetic_batch(cfg, n, seed=seed, present_frac=0.5)


# ---------------------------------------------------------------- registry

def test_registry_holds_every_jax_name():
    """The port's registry is the JAX package's: all 72 names."""
    assert set(registry._REGISTRY) == set(available_models())
    assert len(registry._REGISTRY) == 72
    for alias, name in legacy.ALIASES.items():
        assert legacy.LEGACY[alias] is registry._REGISTRY[name]


# names that build another name's model from the same flags (a name of
# the same class, or an alias), which the card's phase 20 runs once
TWINS = {"multi_t_transformer": "binary_t_transformer",
         "multi_f_transformer": "binary_f_transformer",
         "multi_gru_d": "binary_gru_d", "multi_lstm": "binary_lstm",
         "multi_gru_d_t_transformer": "binary_gru_d_t_transformer",
         "resnet_enc": "resnet",
         "earlyfusion_img_vslt_v2": "earlyfusion_img_vslt",
         "mbt_v1_img": "mbt_v1"}


def _constructor(name):
    make = registry._REGISTRY[name]
    if isinstance(make, functools.partial):
        return make.func, make.args, make.keywords
    return make, (), {}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_names_build_their_twins_model(name):
    """A twin's constructor is its twin's, and from one seed both names
    build the same weights."""
    twin = TWINS[name]
    assert _constructor(name) == _constructor(twin)
    built = [get_model(parse_config(["--model", n, "--input-types",
                                     _own_inputs(twin)] + SMALL),
                       torch.Generator().manual_seed(0)) for n in (name, twin)]
    assert type(built[0]) is type(built[1])
    a, b = (m.state_dict() for m in built)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _own_inputs(name):
    """The --input-types a legacy name runs on (the reference file's
    folder: 1_uni_vslt, 2_uni_image, 4_bi_vslt_img, 5_bi_vslt_txt,
    6_tri)."""
    if name in ("mbt_v1", "mbt_v1_img", "mbt_v2", "earlyfusion_img_txt_vslt"):
        return "vslt_img_txt"
    if "img" in name or name in ("resnet", "resnet_enc", "swin_transformer",
                                 "vit", "vit_monai", "maxvit"):
        return "vslt_img"
    if "txt" in name or name.startswith("auxcpc"):
        return "vslt_txt"
    return "vslt"


@pytest.mark.parametrize("name", sorted(legacy.LEGACY))
def test_every_legacy_name_runs(name, small_backbones):
    """Each of the 44 names builds on its own --input-types and gives
    finite per-sample logits in an eval step and a finite loss in a train
    step (the auxcpc names on the pretrain windows, with their loss); the
    MBT aliases on the TIE stream they were built for."""
    extra = ["--image-size", "224"]
    if name.startswith("auxcpc"):
        extra += ["--auxiliary-loss-input", "directInput"]
    if name.startswith("mbt_"):
        extra += ["--vslt-type", "TIE", "--TIE-len", "64"]
    cfg = parse_config(argv_for(name, _own_inputs(name), *extra))
    if name.startswith("auxcpc"):
        cfg = cfg.replace(auxiliary_loss_type="cosine")
    batch = image_batch(cfg)
    tr = trainer.Trainer(cfg, get_model(cfg), "cpu", eval_only=False)
    probs = tr.eval_step(batch)[0]
    assert probs.shape == (B,) and np.all(np.isfinite(probs))
    assert np.isfinite(tr.train_step(batch))


# ---------------------------------------------------------- 1_uni_vslt

UNI_VSLT = ["binary_t_transformer", "binary_f_transformer",
            "multi_ft_transformer", "binary_gru_d_t_transformer"]


@pytest.mark.parametrize("name", UNI_VSLT)
def test_uni_vslt_eval_matches_jax(name):
    """T (the init_fc tokens, PE, the key mask of input_length + 1), F
    (one token per feature trace, no PE, no mask), FT (both, ``merge``)
    and GRU-D into the time encoder."""
    cfg, jcfg = configs(argv_for(name))
    batch = synthetic_batch(cfg, B, seed=3)
    batch["input_length"][:2] = [1, 24]
    check_eval(cfg, jcfg, batch)


def test_grud_encoder_reads_length_minus_one():
    """The legacy GRU-D encoder's last state is the state at
    clip(input_length - 1, 0, T - 1) (JAX legacy.py:70-72), the row
    gru_d's own rule (input_length, clipped) reads one step later."""
    cfg = parse_config(argv_for("midfusion_vslt_txt_transformer",
                                "vslt_txt"))
    enc = legacy.GRUDEncoder(cfg, torch.float32)
    registry.init_parameters(enc, torch.Generator().manual_seed(0))
    b = synthetic_batch(cfg, B, seed=5)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    for n, row in ((0, 0), (1, 0), (7, 6), (24, 23), (30, 23)):
        tb["input_length"] = torch.full((B,), n, dtype=torch.int32)
        with torch.no_grad():
            last, hs = enc(tb)
        assert torch.equal(last, hs[:, row])


# ---------------------------------------------------------- 2_uni_image

# each backbone kind on the image size its reduced geometry takes
UNI_IMAGE = {"resnet": 64, "resnet_enc": 64, "maxvit": 32, "vit": 64,
             "vit_monai": 64, "swin_transformer": 224}


@pytest.mark.parametrize("name", sorted(UNI_IMAGE))
def test_uni_image_eval_matches_jax(name, small_backbones):
    """The pooled backbone feature through ``fc``: ResNet-18 (its
    BatchNorms at their running statistics), MaxViT, ViT, the patch stem
    and the Swin-T trunk."""
    cfg, jcfg = configs(argv_for(name, "vslt_img"),
                        image_size=UNI_IMAGE[name])
    check_eval(cfg, jcfg, image_batch(cfg))


def test_resnet50_matches_jax():
    """The bottleneck blocks (1 x 1, 3 x 3 stride 2, 1 x 1 to 4x width,
    the strided 1 x 1 downsample), as an ImageBackbone module: pooled
    feature and tokens."""
    cfg, jcfg = configs(argv_for("resnet", "vslt_img"), image_size=64)
    jm = jax_legacy.ImageBackbone(jcfg.replace(img_model_type="resnet50"))
    img = image_batch(cfg)["img"]
    shapes = flax.core.unfreeze(jax.eval_shape(
        lambda x: jm.init({"params": KEY}, x, True), jnp.asarray(img)))
    variables = {"params": draw_like(shapes["params"]),
                 "batch_stats": random_stats(jax.tree.map(
                     lambda s: np.zeros(s.shape, np.float32),
                     shapes["batch_stats"]))}
    want = jax.jit(lambda v, x: jm.apply(v, x, True))(variables,
                                                      jnp.asarray(img))
    port = legacy.ImageBackbone(cfg, torch.float32, "resnet50").eval()
    sd = {}
    convert._flax_named(sd, "", variables["params"],
                        variables["batch_stats"])
    port.load_state_dict(sd, strict=True)
    assert port.width == 1024
    with torch.no_grad():
        got = port(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=ATOL)
    # the tokens feed the kernels as a stream where no img_proj sits
    # between (ResNet-18's 256 at d_model 256)
    assert got[1].is_contiguous()


def test_uni_image_resnet_train_steps_match_jax():
    """Two steps of ``resnet`` (ResNet-18): the convolutions' gradients,
    and every BatchNorm's running statistics at flax's 0.99 from the
    batch's biased variance."""
    argv = argv_for("resnet", "vslt_img", "--dropout", "0")
    cfg, jcfg = configs(argv, image_size=64)
    tr = check_train(cfg, jcfg, [image_batch(cfg, s) for s in (3, 4)])
    bn = tr.model.img_backbone.img_encoder.layer0_0.bn1
    assert bn.flax_momentum == 0.99 and int(bn.num_batches_tracked) == 2


# ------------------------------------------------- the MBT image encoder

def test_mbt_image_encoder_takes_vit(small_backbones):
    """``--img-model-type vit`` in the MBT models (JAX models.py:116-121):
    the ViT's tokens through ``linear``, trainable at --img-pretrain Yes;
    the flagship's eval against JAX."""
    from test_torch_variants import SMALL as MBT_SMALL
    argv = MBT_SMALL + ["--model", "tri_mbt_vsltcls", "--input-types",
                        "vslt_img_txt", "--img-model-type", "vit"]
    cfg, jcfg = configs(argv)
    pair, _, _ = check_eval(cfg, jcfg, image_batch(cfg))
    model = pair.model
    assert isinstance(model.img_encoder, vit.VisionTransformer)
    assert not model.frozen
    assert all(p.requires_grad for p in model.img_encoder.parameters())


# ------------------------------------------------------- pretrain windows

def test_pretrain_window_copy_matches_jax():
    """The port's copy of sequence_generator_pretrain against the JAX
    one on one stay, at a key with a full and one with a short future."""
    rng = np.random.default_rng(0)
    hours = 40
    stay = (rng.normal(0, 1, (hours, 18)),
            (rng.uniform(0, 1, (hours, 18)) < 0.3).astype(np.float64),
            rng.uniform(0, 24, (hours, 18)))
    for key, length in ((20, 12), (33, 24), (5, 24)):
        got = window.sequence_generator_pretrain(*stay, key, length, 24)
        want = jax_window.sequence_generator_pretrain(*stay, key, length, 24)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_synthetic_pretrain_windows():
    """Under --auxiliary-loss-input: 36-row grids, zeros between the
    window's input_length rows and row 24, the future hours from row 24,
    f_indices [B, 36] (1 where a row has more than 4 channels observed);
    to_wire and the Trainer's device batch carry f_indices."""
    cfg = parse_config(argv_for("auxcpc_early", "vslt_txt",
                                "--auxiliary-loss-input", "directInput"))
    b = synthetic_batch(cfg, 16, seed=2)
    assert b["vslt"].shape == (16, 3, 36, 16)
    assert b["f_indices"].shape == (16, 36)
    n = b["input_length"]
    assert n.min() >= 1 and n.max() <= 24
    for i in range(16):
        assert not b["vslt"][i, :, n[i]:24].any()
        assert b["vslt"][i, 1, 24:30].any()
    assert 0 < b["f_indices"][:, 24:].mean() < 1
    assert set(np.unique(b["f_indices"])) <= {0.0, 1.0}
    wire, dense, _ = to_wire([b])
    np.testing.assert_array_equal(wire[0]["f_indices"], b["f_indices"])
    tr = trainer.Trainer(cfg, get_model(cfg.replace(
        auxiliary_loss_type="cpc")), "cpu")
    got = tr.device_batch(b)["f_indices"]
    np.testing.assert_array_equal(got.numpy(), b["f_indices"])
    plain = synthetic_batch(parse_config(argv_for("auxcpc_early",
                                                  "vslt_txt")), 4)
    assert plain["vslt"].shape[2] == 24 and "f_indices" not in plain
