"""The port's vslt+txt path as a whole: the tri_mbt_vsltcls eval step on
vslt+txt inputs (BASELINE config 2's flags at a small width) against the
JAX package's eval step, the weight bridge in both directions, and the
guarantees about what the port imports and refuses (the tri-modal path
is tests/test_torch_trimodal.py)."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import flax
import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.models.convert_ref import \
    convert_reference_state_dict
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.drivers.common import check_flags
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.convert import \
    from_jax_variables
from medical_tri_modal_pilot_tpu_torch.train import trainer

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "medical_tri_modal_pilot_tpu_torch"
B = 4
SMALL = ["--model", "tri_mbt_vsltcls", "--input-types", "vslt_txt",
         "--vslt-type", "TIE", "--imgtxt-time", "1",
         "--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--TIE-len", "64",
         "--transformer-num-layers", "2", "--transformer-dim", "64",
         "--transformer-num-head", "2", "--precision", "fp32"]


def _cfg(*extra):
    return parse_config(SMALL + list(extra))


def _batch(cfg, seed=3):
    """A synthetic batch with notes present and missing (a missing note
    has length 0, so its stream is masked by the vlen 3 -> 0 rule)."""
    b = synthetic_batch(cfg, B, seed=seed)
    b["missing"][:, 2] = [0, 1, 0, 1]
    b["txt_length"][:] = [128, 0, 1, 0]
    b["txt"][1] = b["txt"][3] = 0.0
    b["txt"][2, 1:] = 0.0
    return b


@pytest.fixture(scope="module", params=["None", "rmse"])
def jax_eval(request):
    """A JAX eval-only Trainer (XLA path on the CPU) with non-trivial
    BatchNorm running statistics, and its variables as numpy."""
    cfg = _cfg("--auxiliary-loss-type", request.param)
    batch = _batch(cfg)
    try:
        jt = jax_trainer.Trainer(cfg, jax_get_model(cfg), 1, batch,
                                 eval_only=True)
        variables = {
            "params": flax.core.unfreeze(jax.device_get(jt.state.params)),
            "batch_stats": flax.core.unfreeze(
                jax.device_get(jt.state.batch_stats))}
        rng = np.random.default_rng(1)
        bn = variables["batch_stats"]["fc_list"]["bn"]
        bn["mean"] = rng.normal(0, .3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(.5, 2, bn["var"].shape).astype(np.float32)
        jt.state = jt.state.replace(batch_stats=variables["batch_stats"])
        yield cfg, batch, jt, variables
    finally:
        # the JAX Trainer configures the module-global kernel dispatch
        jax_ops.configure(False)


def test_eval_step_matches_jax(jax_eval):
    """probs, loss and (with the aux head) rmse of one eval step. 1e-5 on
    probabilities and loss: fp32 on both sides, two layers, the same math
    summed in another order (logits agree to ~1e-6)."""
    cfg, batch, jt, variables = jax_eval
    model = get_model(cfg)
    model.load_state_dict(from_jax_variables(cfg, variables), strict=True)
    probs, loss, rmse = trainer.Trainer(cfg, model, "cpu").eval_step(batch)
    want_probs, want_loss, want_rmse = jt.eval_step(batch)
    assert probs.shape == (B,) and np.all(np.isfinite(probs))
    np.testing.assert_allclose(probs, np.asarray(want_probs), atol=1e-5)
    assert loss == pytest.approx(want_loss, abs=1e-5)
    if cfg.auxiliary_loss_type == "rmse":
        assert rmse == pytest.approx(want_rmse, abs=1e-5)
    else:
        assert rmse is None and want_rmse is None


def test_weight_bridge_round_trip(jax_eval):
    """JAX variables -> port state_dict -> the JAX package's own converter
    gives back the same tree, leaf for leaf, and uses every key."""
    cfg, _, _, variables = jax_eval
    model = get_model(cfg)
    model.load_state_dict(from_jax_variables(cfg, variables), strict=True)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = convert_reference_state_dict(cfg, sd)
    for tree, ref in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        want = dict(jax.tree_util.tree_leaves_with_path(ref))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), str(k))


def test_port_weights_survive_the_bridge():
    """The other direction: seeded port weights -> flax tree -> back."""
    cfg = _cfg()
    model = get_model(cfg, torch.Generator().manual_seed(5))
    sd = model.state_dict()
    params, stats = convert_reference_state_dict(
        cfg, {k: v.numpy() for k, v in sd.items()})
    back = from_jax_variables(cfg, {"params": params, "batch_stats": stats})
    assert back.keys() == sd.keys()
    for k in sd:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], sd[k]), k


def test_missing_num_and_losses_match_jax():
    cfg = _cfg("--auxiliary-loss-type", "rmse")
    rng = np.random.default_rng(0)
    missing = np.array([[0, 0, 0], [0, 1, 1], [0, 0, 1], [0, 1, 0]],
                       np.float32)
    for types in ("vslt_txt", "vslt_img_txt", "vslt_img", "vslt"):
        c = cfg.replace(input_types=types)
        np.testing.assert_array_equal(
            trainer.compute_missing_num(c, torch.from_numpy(missing)).numpy(),
            np.asarray(jax_trainer.compute_missing_num(c, missing)))
    logits = rng.normal(0, 3, B).astype(np.float32)
    rmse = rng.normal(5, 2, B).astype(np.float32)
    targets = np.array([1, 0, 1, 0], np.float32)
    aux = rng.uniform(0, 12, B).astype(np.float32)
    want = jax_trainer.compute_loss(cfg, logits, rmse, targets, aux,
                                    missing, np.zeros(B, np.int32))
    got = trainer.compute_loss(cfg, *map(torch.from_numpy,
                                         (logits, rmse, targets, aux)))
    assert float(got) == pytest.approx(float(want), abs=1e-5)
    np.testing.assert_allclose(
        trainer.bce(torch.from_numpy(logits), torch.from_numpy(targets)),
        np.asarray(jax_trainer._bce(logits, targets)), atol=1e-6)


def test_unported_paths_raise():
    """What the port does not run yet raises, naming its ROADMAP item:
    loading pretrained trunk weights, and several optimizer steps a
    dispatch (--train-multi-k > 1); a name outside the registry raises
    a KeyError listing the names it holds (gru_d and the legacy
    binary_t_transformer among them). The txt_id / uint8 / packed-image
    wire format runs (tests/test_torch_drivers.py); a txt_id batch
    without the note table is refused by name."""
    with pytest.raises(KeyError,
                       match="available: .*'binary_t_transformer'.*'gru_d'"):
        get_model(_cfg("--model", "binary_t_transformer_v9"))
    tri = ("--input-types", "vslt_img_txt")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        get_model(_cfg(*tri, "--img-pretrain-path", "swin_t.pth"))
    cfg = _cfg()
    model = get_model(cfg)
    batch = _batch(cfg)
    batch["txt_id"] = np.arange(B, dtype=np.int32)
    with pytest.raises(ValueError, match="txt_table"):
        trainer.Trainer(cfg, model, "cpu").eval_step(batch)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        check_flags(_cfg("--train-multi-k", "2"))


def test_port_imports_no_jax():
    """No module of the port (parallel/ and its launcher, the data path,
    the logger, the saver and the drivers included), nor
    chip_smoke.py, nor the rank bodies the launcher starts in the tests
    (tests/tp_worker.py, tests/tp_drivers_worker.py, tests/dp_worker.py),
    imports jax, flax or
    the JAX package (the port keeps its own copies of config, constants
    and metrics)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|medical_tri_modal_pilot_tpu)\b"
        r"(?!_torch)", re.M)
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "tp_worker.py",
        REPO / "tests" / "tp_drivers_worker.py",
        REPO / "tests" / "dp_worker.py"]
    assert PORT / "parallel" / "launch.py" in files
    for sub in ("data/pipeline.py", "data/dataset.py", "data/images.py",
                "train/logger.py", "train/checkpoints.py",
                "drivers/train.py", "drivers/test.py"):
        assert PORT / sub in files, sub
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
    assert pattern.search("from medical_tri_modal_pilot_tpu.config import x")
    assert pattern.search("import medical_tri_modal_pilot_tpu")
    assert not pattern.search(
        "from medical_tri_modal_pilot_tpu_torch import x")


def test_port_runs_without_jax_flax_pil_h5py():
    """The card's machine has none of these: block them, and the JAX
    package itself, and run one config-4 CPU eval step (packed trunk)
    through the port in a fresh interpreter."""
    argv = SMALL + ["--input-types", "vslt_img_txt"]
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "flax", "optax", "PIL", "h5py",
                     "medical_tri_modal_pilot_tpu"):
            sys.modules[name] = None
        from medical_tri_modal_pilot_tpu_torch.config import parse_config
        from medical_tri_modal_pilot_tpu_torch.data.synthetic import (
            synthetic_batch)
        from medical_tri_modal_pilot_tpu_torch.models import get_model
        from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
        from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
        cfg = parse_config({argv!r})
        model = get_model(cfg)
        batch = synthetic_batch(cfg, {B})
        probs, loss, _ = Trainer(cfg, model, "cpu").eval_step(batch)
        assert probs.shape == ({B},) and loss == loss
        assert model.trunk_rows == {B} // 2 + 1
        ev = Evaluator()
        ev.add_batch(batch["target"], probs)
        ev.performance_metric()
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_needs_a_gpu():
    """Without CUDA the smoke run fails and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
