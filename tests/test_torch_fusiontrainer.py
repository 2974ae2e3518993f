"""``fusiontrainer`` in the port against the JAX package on the CPU: the
MedFuse, MMTM and DAFT fusion baselines behind --fuse-baseline (None
takes Medfuse; Retain and Multi fall through to DAFT, as in the JAX
model), with weights carried across by ``from_jax_variables``. The Swin-T
trunk of both sides is swapped for the narrow geometry of
tests/test_torch_swin_train.py (NARROW: the same 768-wide 7 x 7 map at
224, four blocks), whose gradients that file holds to JAX's, so the JAX
compiles stay small. Per kind: the eval step within 1e-5 and the
gradients of the mean BCE with ``deterministic=True`` on both sides
(the LSTMs' fixed 0.3 dropout and the trunk's stochastic depth draw
JAX's PRNG, which the port's Philox masks cannot match), every tensor
within 1e-4 of its largest entry, the trunk's included (DAFT on
--berttype bert's mean token embedding); the bridge a bijection; and
under --fusion-type uni_ehr (MMTM) no trunk gradient on either side
(JAX's stop_gradient) and a port train step that moves the trunk by
AdamW's decay alone, as optax moves it. The weights are seeded draws of
the JAX tree's shapes (``draw_like``), and each kind's shapes are traced
once for the file (``shapes_of``)."""
import functools

import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.models import baselines as jax_baselines
from medical_tri_modal_pilot_tpu.models import swin as jswin
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import baselines, get_model
from medical_tri_modal_pilot_tpu_torch.models import swin
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_baselines import (SMALL, check_bridge, check_grads,
                                  init_shapes, jax_and_port)
from test_torch_mbt_v1 import batch_for
from test_torch_swin_train import NARROW

TRI = ["--input-types", "vslt_img_txt", "--vslt-type", "carryforward"]


@pytest.fixture(scope="module", autouse=True)
def narrow_trunks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_baselines, "SwinTransformer", functools.partial(
            jswin.SwinTransformer, **NARROW))
        mp.setattr(baselines, "SwinTransformer", functools.partial(
            swin.SwinTransformer, **NARROW))
        yield


# DAFT reads --berttype bert's notes: the mean of the token embeddings
# (padding ids included); MMTM runs under --fusion-type uni_ehr; each
# kind's bridge holds these flags too
FLAGS = {"Medfuse": (), "MMTM": ("--fusion-type", "uni_ehr"),
         "DAFT": ("--berttype", "bert")}


def argv_for(kind, *extra):
    base = SMALL + ["--model", "fusiontrainer"] + TRI + list(extra)
    return base + (["--fuse-baseline", kind] if kind else [])


@pytest.fixture(scope="module")
def shapes_of():
    """(argv, batch, the JAX variables' shapes) of a kind with its FLAGS,
    traced once for the file's cases."""
    memo = {}

    def get(kind):
        if kind not in memo:
            argv = argv_for(kind, *FLAGS.get(kind, ()))
            batch = batch_for(parse_config(argv))
            memo[kind] = argv, batch, init_shapes(argv, batch)
        return memo[kind]
    return get


@pytest.mark.parametrize("kind", list(FLAGS))
def test_fusiontrainer_matches_jax(kind, shapes_of):
    """Eval and deterministic gradients. Under uni_ehr both sides' trunk
    gradients are zero (JAX's stop_gradient, the port's no_grad), and one
    train step of the port's Trainer moves the trunk by AdamW's decay
    alone, p (1 - lr wd), as optax moves a parameter whose gradient is
    zero."""
    argv, batch, shapes = shapes_of(kind)
    cfg, jt, variables, model = jax_and_port(argv, batch, shapes)
    assert model.kind == kind
    grads = check_grads(cfg, jt, variables, model, batch, eval_step=True)
    trunk = [g for n, g in grads.items() if n.startswith("cxr_model.")]
    if kind != "MMTM":
        assert trunk and all(np.abs(g).max() > 0 for g in trunk[:3])
        return
    assert trunk and not any(np.abs(g).max() for g in trunk)
    tr = trainer.Trainer(cfg, model, "cpu", eval_only=False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lr = tr.current_lr()
    assert np.isfinite(tr.train_step(batch))
    decay = 1 - lr * cfg.weight_decay
    for n, p in model.named_parameters():
        if n.startswith("cxr_model."):
            assert torch.equal(p.grad, torch.zeros_like(p)), n
            torch.testing.assert_close(p.detach(), before[n] * decay,
                                       rtol=0, atol=1e-7)
        else:
            assert not torch.equal(p.detach(), before[n]), n


@pytest.mark.parametrize("kind", ["Medfuse", "MMTM", "DAFT", "Retain",
                                  "Multi", None])
def test_fusiontrainer_bridge(kind, shapes_of):
    """Each kind's tree carried across leaf for leaf (Retain's on both
    sides: the JAX model's fall-through to DAFT, pinned); Multi and None
    build the port model and state_dict names of DAFT and Medfuse."""
    argv = argv_for(kind)
    if kind in ("Multi", None):
        cfg = parse_config(argv)
        same = "DAFT" if kind else "Medfuse"
        model = get_model(cfg)
        assert model.kind == same
        assert model.state_dict().keys() == get_model(
            parse_config(argv_for(same))).state_dict().keys()
        return
    cfg = check_bridge(*shapes_of(kind))
    model = get_model(cfg)
    assert model.kind == ("DAFT" if kind == "Retain" else kind)
    if kind == "Retain":
        assert hasattr(model, "daft_head") and hasattr(model, "aux_base")
