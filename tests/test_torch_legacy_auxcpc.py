"""The auxcpc_* family of the port (models/legacy.py::AUXCPC) against the
JAX package on the CPU, on the 36-row pretrain windows of
--auxiliary-loss-input (data/synthetic.py, f_indices from the windows'
observed channels), at tests/test_torch_legacy_models.py's small width
with BioBERT notes: for each of the ten names (early / early2 / grudtxt /
mbt predict, the three ct mirrors, the three direct wirings) and each loss
type (cpc, cosine, l2; with Wbrl on the predicting wirings), the logits
and the auxiliary loss of the eval forward within 1e-5 of the JAX
``model.apply``, from one draw of the JAX weights per name; two train
steps of auxcpc_mbt under cpcWbrl against the JAX Trainer (the loss with
its auxiliary term, parameters, Adam moments, brl_bn's running
statistics at momentum 0.9); no future rows, no auxiliary loss."""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import get_model, legacy
from medical_tri_modal_pilot_tpu_torch.train import trainer
from test_torch_legacy_models import (ATOL, B, Pair, argv_for, check_train,
                                      configs)

NAMES = sorted(n for n in legacy.LEGACY if n.startswith("auxcpc"))
PRETRAIN = ["--auxiliary-loss-input", "directInput"]
CASES = [(n, t) for n in NAMES for t in ("cpc", "cosine", "l2")] + [
    (n, t) for n in NAMES if not n.endswith("_ct")
    for t in ("cpcWbrl",)]
# one draw of the JAX weights per (name, Wbrl): the loss types share it
_VARIABLES = {}


def pretrain_batch(cfg, seed=3):
    """Pretrain windows; notes present (one a single row) and missing."""
    b = synthetic_batch(cfg, B, seed=seed)
    b["missing"][:, 2] = [0, 1, 0, 1]
    b["txt_length"][:] = [128, 0, 1, 0]
    b["txt"][1] = b["txt"][3] = 0.0
    b["txt"][2, 1:] = 0.0
    return b


@pytest.mark.parametrize("name,aux_type", CASES)
def test_auxcpc_matches_jax(name, aux_type):
    cfg, jcfg = configs(argv_for(name, "vslt_txt", *PRETRAIN),
                        auxiliary_loss_type=aux_type)
    batch = pretrain_batch(cfg)
    assert batch["vslt"].shape[2] == 36
    key = (name, "Wbrl" in aux_type)
    pair = Pair(cfg, jcfg, batch, _VARIABLES.get(key), jit=False)
    _VARIABLES[key] = pair.variables
    logits, _, aux = pair.jax_apply(batch)
    got_logits, rmse, got_aux = pair.port_apply(batch)
    assert rmse is None and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits),
                               atol=ATOL, rtol=ATOL)
    assert float(got_aux) == pytest.approx(float(aux), abs=ATOL, rel=ATOL)
    if name.endswith("_ct") and aux_type == "cpc":
        assert float(got_aux) == 0.0
    else:
        assert float(got_aux) != 0.0


def test_auxcpc_mbt_wbrl_train_steps_match_jax():
    argv = argv_for("auxcpc_mbt", "vslt_txt", "--dropout", "0", *PRETRAIN)
    cfg, jcfg = configs(argv, auxiliary_loss_type="cpcWbrl")
    tr = check_train(cfg, jcfg, [pretrain_batch(cfg, s) for s in (3, 4)])
    bn = tr.model.brl_bn
    assert int(bn.num_batches_tracked) == 2
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))


def test_no_future_rows_no_auxiliary_loss():
    """On the 24-row windows (no --auxiliary-loss-input) the model holds
    no auxiliary parameters and returns an auxiliary loss of exactly 0,
    as the JAX model does; a window with future rows needs the flag."""
    name = "auxcpc_early"
    cfg, jcfg = configs(argv_for(name, "vslt_txt"),
                        auxiliary_loss_type="cpcWbrl")
    batch = pretrain_batch(cfg)
    assert batch["vslt"].shape[2] == 24
    pair = Pair(cfg, jcfg, batch, jit=False)
    assert not hasattr(pair.model, "ct_weight")
    assert float(pair.jax_apply(batch)[2]) == 0.0
    logits, _, aux = pair.port_apply(batch)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(pair.jax_apply(batch)[0]),
                               atol=ATOL, rtol=ATOL)
    long = pretrain_batch(parse_config(argv_for(name, "vslt_txt",
                                                *PRETRAIN)))
    with pytest.raises(ValueError, match="--auxiliary-loss-input"):
        pair.port_apply(long)


def test_auxiliary_loss_reaches_the_train_loss():
    """The Trainer adds the model's auxiliary loss with
    --auxiliary-loss-weight: a weight of 0 leaves the head's BCE."""
    losses = {}
    for w in ("0", "2"):
        cfg = parse_config(argv_for("auxcpc_early", "vslt_txt", "--dropout",
                                    "0", "--auxiliary-loss-weight", w,
                                    *PRETRAIN)).replace(
                                        auxiliary_loss_type="l2")
        batch = pretrain_batch(cfg)
        model = get_model(cfg)
        b = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        with torch.no_grad():
            logits, _, aux = model.train()(b, trainer.compute_missing_num(
                cfg, b["missing"]))
        bce = float(trainer.bce(logits, b["target"]).mean())
        losses[w] = (trainer.Trainer(cfg, model, "cpu", eval_only=False)
                     .train_step(batch), bce, float(aux))
    assert losses["0"][0] == pytest.approx(losses["0"][1], abs=1e-6)
    loss, bce, aux = losses["2"]
    assert aux > 0 and loss == pytest.approx(bce + 2 * aux, rel=1e-5)
