"""``tri_mbt_v2`` and ``tri_mbt_v3`` in the port against the JAX package on
the CPU, and the trainable trunk on the MBT models (--img-pretrain No).
Small MBT width (2 layers, d 64, 2 heads, TIE-len 64, batch 4, fp32),
weights from the JAX model carried across (tri_mbt_v3: its init
perturbed; tri_mbt_v2: seeded draws of its init's shapes, ``draw_like``).

tri_mbt_v3 (the patch stem, the BatchNorm head over the stacked cls
vectors, no trunk): the eval step and one JAX-Trainer train step at
--dropout 0 (tests/test_torch_variants.py::check_model). tri_mbt_v2 (the
trunk trains; its stochastic depth draws JAX's PRNG, which the port's
Philox masks cannot match): the eval step and the per-stream rmse head's
output (--auxiliary-loss-type rmse) within 1e-5, and the gradients of
the mean BCE with ``deterministic=True`` on both sides (``check_grads``),
the trunk's included, with both trunks at the narrow geometry of
tests/test_torch_swin_train.py (NARROW). The patch stem also takes every
--img-model-type but swin and vit, as the JAX ImageEncoder falls through
to it; the flagship at --img-pretrain No trains its trunk (training
mode, stochastic depth, its parameters moved); the bridges are
bijections."""
import functools

import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.models import models as jax_models
from medical_tri_modal_pilot_tpu.models import swin as jswin
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import get_model, models, swin
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_baselines import check_bridge, check_grads, jax_and_port
from test_torch_mbt_v1 import batch_for
from test_torch_swin_train import NARROW
from test_torch_variants import SMALL, check_model

TRI = ["--input-types", "vslt_img_txt"]


def argv_for(model, *extra):
    return SMALL + ["--model", model] + TRI + list(extra)


@pytest.fixture
def narrow_trunks(monkeypatch):
    monkeypatch.setattr(jax_models, "SwinTransformer", functools.partial(
        jswin.SwinTransformer, **NARROW))
    monkeypatch.setattr(models, "SwinTransformer", functools.partial(
        swin.SwinTransformer, **NARROW))
    yield
    jax_ops.configure(False)


def test_tri_mbt_v3_matches_jax():
    argv = argv_for("tri_mbt_v3")
    tr = check_model(argv, batch_for(parse_config(argv)))
    model = tr.model
    assert not hasattr(model, "img_encoder")
    assert model.patch_embedding.pos_embed.shape == (1, 196, 64)


def test_tri_mbt_v2_matches_jax(narrow_trunks):
    argv = argv_for("tri_mbt_v2", "--auxiliary-loss-type", "rmse",
                    "--dropout", "0")
    batch = batch_for(parse_config(argv))
    cfg, jt, variables, model = jax_and_port(argv, batch)
    assert not model.frozen and not model.img_pack
    grads = check_grads(cfg, jt, variables, model, batch, eval_step=True)
    assert np.abs(grads["img_encoder.features.0.0.weight"]).max() > 0
    assert trainer.Trainer(cfg, model, "cpu").eval_step(batch)[2] is not None


def test_patch_stem_fall_through_and_bridges(narrow_trunks):
    """--img-model-type resnet18 (or maxvit) takes the patch stem on both
    sides; vit the ViT, trainable (tests/test_torch_legacy_models.py);
    tri_mbt_v2's and tri_mbt_v3's trees cross leaf for leaf; v2 and v3
    take one image per sample and three streams."""
    for argv in (argv_for("tri_mbt_vsltcls", "--img-model-type", "resnet18"),
                 argv_for("tri_mbt_v2"), argv_for("tri_mbt_v3")):
        cfg = check_bridge(argv, batch_for(parse_config(argv)))
    model = get_model(parse_config(argv_for("tri_mbt_vsltcls",
                                            "--img-model-type", "maxvit")))
    assert hasattr(model, "patch_embedding") and not hasattr(model,
                                                             "img_encoder")
    vit = get_model(parse_config(argv_for("tri_mbt_vsltcls",
                                          "--img-model-type", "vit")))
    assert not hasattr(vit, "patch_embedding") and not vit.frozen
    assert isinstance(vit.img_encoder, models.VisionTransformer)
    for name in ("tri_mbt_v2", "tri_mbt_v3"):
        with pytest.raises(ValueError, match="one image per sample"):
            get_model(parse_config(argv_for(name, "--multiimages", "1")))
        with pytest.raises(ValueError, match="vslt_img_txt"):
            get_model(parse_config(SMALL + ["--model", name,
                                            "--input-types", "vslt_txt"]))
    del cfg


def test_flagship_trains_its_trunk(narrow_trunks):
    """tri_mbt_vsltcls at --img-pretrain No: the trunk in the optimizer,
    in training mode during the step (its stochastic depth drawing the
    step's seeds), run over every row (no packing), its parameters moved
    by one step."""
    cfg = parse_config(argv_for("tri_mbt_vsltcls", "--img-pretrain", "No",
                                "--img-pack", "1"))
    model = get_model(cfg)
    assert not model.frozen and not model.img_pack
    tr = trainer.Trainer(cfg, model, "cpu", eval_only=False)
    trunk = tr.model.img_encoder
    assert {id(p) for p in trunk.parameters()} <= {
        id(p) for p in tr.optimizer.params}
    before = {n: p.detach().clone() for n, p in trunk.named_parameters()}
    modes = []
    blk = trunk.features[1][1]
    hook = blk.register_forward_pre_hook(
        lambda m, a: modes.append(m.training))
    try:
        assert np.isfinite(tr.train_step(batch_for(cfg)))
    finally:
        hook.remove()
    assert modes == [True] and not trunk.training
    assert tr.model.trunk_rows == cfg.batch_size
    # the stem and block 0 (which never drops) moved; a dropping block's
    # branch may be dropped on every row that has an image
    moved = {n for n, p in trunk.named_parameters()
             if not torch.equal(p, before[n])}
    assert {n for n in before if n.startswith(("features.0.",
                                               "features.1.0."))} <= moved
