"""The legacy fusion archetypes of the port (models/legacy.py: early, mid
and late fusion, the cross-modal transformer over images) against the
JAX package on the CPU, at tests/test_torch_legacy_models.py's small
width: images through ResNet-18 on 64 x 64 CXRs (two of four present),
BioBERT notes present and missing. Eval within 1e-5 for each archetype on
each of its --input-types; two train steps at --dropout 0 against the
JAX Trainer for early fusion (vslt + notes) and the GRU-D mid fusion
(vslt + CXR, ResNet-18's BatchNorms moving); the route of the joint
stream through the ops, whose key mask holds valid image rows between
the masked vslt and note tails."""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_legacy_models import (B, argv_for, check_eval, check_train,
                                      configs, image_batch)

# the early fusion's train steps' batch (see its test)
STEP_B = 16

# (name, --input-types)
EVAL = [("earlyfusion_img_vslt", "vslt_img"),
        ("earlyfusion_vslt_txt_transformer", "vslt_txt"),
        ("earlyfusion_img_txt_vslt", "vslt_img_txt"),
        ("midfusion_img_trans_vslt_ttrans", "vslt_img"),
        ("midfusion_img_trans_vslt_grud", "vslt_img"),
        ("midfusion_vslt_txt_transformer", "vslt_txt"),
        ("latefusion_img_trans_vslt_grud", "vslt_img"),
        ("latefusion_img_trans_vslt_ttrans", "vslt_img"),
        ("latefusion_vslt_grud_txt_transformer", "vslt_txt"),
        ("latefusion_vslt_txt_transformer", "vslt_txt"),
        ("cross_transformer_img_vslt_sssccc", "vslt_img")]


def fusion_batch(cfg, seed=3, n=B):
    """Half the CXRs present; a one-step and a full-window vslt sample;
    notes present (one a single row) and missing, in turns."""
    b = image_batch(cfg, seed, n)
    b["input_length"][:2] = [1, 24]
    b["vslt"][0, :, 1:] = 0.0
    if "txt" in cfg.input_types:
        b["missing"][:, 2] = np.arange(n) % 2
        b["txt_length"][:4] = [128, 0, 1, 0]
        b["txt_length"][1::2] = 0
        b["txt"][1::2] = 0.0
        b["txt"][2, 1:] = 0.0
    return b


@pytest.mark.parametrize("name,inputs", EVAL)
def test_fusion_eval_matches_jax(name, inputs):
    cfg, jcfg = configs(argv_for(name, inputs), image_size=64)
    check_eval(cfg, jcfg, fusion_batch(cfg))


def test_earlyfusion_train_steps_match_jax():
    """At batch 16 (STEP_B): at init the cls row is nearly the same in
    every sample, so over 4 samples the head's BatchNorm takes some
    features' variance as E[h^2] - E[h]^2 of nearly equal terms (as flax
    computes it), where the noise Adam gives fc_list.0's bias (its true
    gradient is 0) moves the second step's loss by 4e-5 on either side
    (tests/test_torch_classification.py's train steps run at 16 for the
    same reason)."""
    argv = argv_for("earlyfusion_vslt_txt_transformer", "vslt_txt",
                    "--dropout", "0", "--batch-size", str(STEP_B))
    cfg, jcfg = configs(argv)
    check_train(cfg, jcfg, [fusion_batch(cfg, s, STEP_B) for s in (3, 4)])


def test_midfusion_grud_train_steps_match_jax():
    """GRU-D's gradients through its 24 steps, the ResNet-18's and its
    BatchNorms' statistics."""
    argv = argv_for("midfusion_img_trans_vslt_grud", "vslt_img",
                    "--dropout", "0")
    cfg, jcfg = configs(argv, image_size=64)
    tr = check_train(cfg, jcfg, [fusion_batch(cfg, s) for s in (3, 4)])
    assert int(tr.model.img_backbone.img_encoder.bn1.num_batches_tracked) \
        == 2


def test_earlyfusion_joint_stream_through_ops(monkeypatch):
    """At tri: [cls | 24 vslt | 4 image rows | 128 notes] = 157 rows, each
    layer one attn_block and one ffn over the joint key mask, whose image
    rows are valid whatever the vslt and note lengths; a dropping input
    dropout in training mode draws ops.dropout_masks."""
    cfg = parse_config(argv_for("earlyfusion_img_txt_vslt", "vslt_img_txt"))
    cfg = cfg.replace(image_size=64)
    model = get_model(cfg)
    calls = []
    for name in ("attn_block", "ffn", "dropout_masks"):
        real = getattr(ops, name)

        def spy(*args, _name=name, _real=real, **kw):
            calls.append((_name, args))
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    batch = fusion_batch(cfg)
    trainer.Trainer(cfg, model, "cpu").eval_step(batch)
    assert [c[0] for c in calls] == ["attn_block", "ffn"] * 2
    x, mask = calls[0][1][0], calls[0][1][5]
    assert x.shape == (B, 157, 64) and mask.shape == (B, 157)
    assert not mask[:, 0].any() and not mask[:, 25:29].any()
    want_vslt = np.arange(24)[None] >= batch["input_length"][:, None]
    np.testing.assert_array_equal(mask[:, 1:25].numpy(), want_vslt)
    txt = np.minimum(batch["txt_length"] + 2, 128)
    np.testing.assert_array_equal(mask[:, 29:].numpy(),
                                  np.arange(128)[None] >= txt[:, None])
    calls.clear()
    tr = trainer.Trainer(cfg, model, "cpu", eval_only=False)
    tr.train_step(batch)
    assert [c[0] for c in calls].count("dropout_masks") == 1


def test_cross_transformer_img_streams():
    """The image cross transformer: the backbone's tokens (ResNet-18 at
    256 wide) through ``img_proj``; no image row is masked."""
    cfg = parse_config(argv_for("cross_transformer_img_vslt_sssccc",
                                "vslt_img")).replace(image_size=64)
    model = get_model(cfg)
    assert model.img_proj.weight.shape == (64, 256)
    b = {k: torch.from_numpy(np.asarray(v))
         for k, v in fusion_batch(cfg).items()}
    tokens, valid = model.modal_tokens(b, None)
    assert [t.shape for t in tokens] == [(B, 24, 64), (B, 4, 64)]
    assert valid[1].all()
    patch = get_model(parse_config(argv_for(
        "cross_transformer_img_vslt_sssccc", "vslt_img",
        "--img-model-type", "swin")).replace(img_model_type="patch"))
    assert not hasattr(patch, "img_proj")
