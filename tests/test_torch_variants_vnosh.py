"""``tri_mbt_vnoshavgtr`` and ``tri_mbt_vnoshnoavgtr`` (a BatchNorm head
per stream) against the JAX package: tests/test_torch_variants.py's
``check_model`` with the raw outputs too (the [3, B] heads of
vnoshnoavgtr, the [B] in-model mean of vnoshavgtr, and the [3, B] rmse
heads with --auxiliary-loss-type rmse) within 1e-5; the Trainer's
vnoshnoavgtr loss (each head's BCE weighted by its stream's presence)
and eval selection (the mean of the available streams' heads) against
the JAX trainer's on seeded logits, and its substring test: a name
holding "mbt_vnoshnoavgtr" takes the branch, vnoshavgtr does not."""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_mbt_v1 import batch_for
from test_torch_variants import argv_for, check_model


@pytest.mark.parametrize("name,aux", [("tri_mbt_vnoshavgtr", "rmse"),
                                      ("tri_mbt_vnoshnoavgtr", "None")])
def test_vnosh_matches_jax(name, aux):
    argv = argv_for(name, "--auxiliary-loss-type", aux)
    tr = check_model(argv, batch_for(parse_config(argv)), logits=True)
    assert [f"fc_list_{m}" in dict(tr.model.named_children())
            for m in range(3)] == [True] * 3


def test_vnoshnoavgtr_trainer_branches_match_jax():
    """compute_loss and select_eval_output on seeded [3, B] logits over
    every missing case (a stream's head trained only where it is
    present), against the JAX trainer's; vnoshavgtr's [B] logits take the
    plain BCE and come back as they are."""
    rng = np.random.default_rng(5)
    n = 8
    logits = rng.normal(0, 2, (3, n)).astype(np.float32)
    targets = rng.integers(0, 2, n).astype(np.float32)
    missing = np.zeros((n, 3), np.float32)
    missing[:, 1] = [0, 0, 1, 1, 0, 1, 0, 1]
    missing[:, 2] = [0, 1, 0, 1, 1, 1, 0, 0]
    cfg = parse_config(argv_for("tri_mbt_vnoshnoavgtr"))
    mn = jax_trainer.compute_missing_num(cfg, missing)
    np.testing.assert_array_equal(
        trainer.compute_missing_num(cfg, torch.from_numpy(missing)).numpy(),
        np.asarray(mn))
    t = torch.from_numpy
    got = trainer.compute_loss(cfg, t(logits), None, t(targets), t(targets),
                               t(missing), t(np.asarray(mn)))
    want = jax_trainer.compute_loss(cfg, logits, None, targets, targets,
                                    missing, mn)
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    np.testing.assert_allclose(
        trainer.select_eval_output(cfg, t(logits), t(np.asarray(mn))).numpy(),
        np.asarray(jax_trainer.select_eval_output(cfg, logits, mn)),
        atol=1e-6)
    avg = parse_config(argv_for("tri_mbt_vnoshavgtr"))
    one = logits[0]
    got = trainer.compute_loss(avg, t(one), None, t(targets), t(targets),
                               t(missing), t(np.asarray(mn)))
    want = jax_trainer.compute_loss(avg, one, None, targets, targets,
                                    missing, mn)
    assert float(got) == pytest.approx(float(want), abs=1e-6)
    assert torch.equal(trainer.select_eval_output(avg, t(one), t(mn)), t(one))
