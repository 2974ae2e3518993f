"""The port keeps its own copies of the JAX package's host-side modules
(config, constants, train/metrics). They must stay what they copy: the
same parsed Config for the BASELINE argvs, the same constants, and the
same metrics on the same probabilities."""
import dataclasses

import numpy as np
import pytest

from medical_tri_modal_pilot_tpu import config as jconfig
from medical_tri_modal_pilot_tpu import constants as jconstants
from medical_tri_modal_pilot_tpu.train import metrics as jmetrics
from medical_tri_modal_pilot_tpu_torch import config as tconfig
from medical_tri_modal_pilot_tpu_torch import constants as tconstants
from medical_tri_modal_pilot_tpu_torch.train import metrics as tmetrics

_FLAGSHIP = ["--model", "tri_mbt_vsltcls", "--vslt-type", "TIE",
             "--output-type", "intubation",
             "--modality-inclusion", "train-missing_test-missing",
             "--batch-size", "64"]
ARGVS = {
    "defaults": [],
    "config2": _FLAGSHIP + ["--input-types", "vslt_txt", "--imgtxt-time", "1"],
    "config4": _FLAGSHIP + ["--input-types", "vslt_img_txt",
                            "--imgtxt-time", "1"],
    "config5": _FLAGSHIP + ["--input-types", "vslt_img_txt",
                            "--imgtxt-time", "1", "--multiimages", "1"],
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_parse_config_matches_jax(name, tmp_path, monkeypatch):
    """Every Config field, for each argv (dir_root defaults to the cwd, so
    both parse in the same directory)."""
    monkeypatch.chdir(tmp_path)
    want = jconfig.parse_config(ARGVS[name])
    got = tconfig.parse_config(ARGVS[name])
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, f.name)
        else:
            assert a == b, f.name


def test_constants_match_jax():
    names = [n for n in vars(jconstants) if n.isupper()]
    assert names
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(tconstants, n)),
                                      np.asarray(getattr(jconstants, n)), n)


def test_evaluators_agree():
    """Seeded probabilities in three batches, one with rmse values: the
    same auc, apr, f1 sweep, threshold and rates."""
    rng = np.random.default_rng(0)
    evs = [jmetrics.Evaluator(), tmetrics.Evaluator()]
    for i in range(3):
        y = rng.integers(0, 2, 50).astype(np.float32)
        p = np.clip(0.3 * y + 0.7 * rng.random(50), 0, 1).astype(np.float32)
        rmse = rng.random(50) if i == 1 else None
        for ev in evs:
            ev.add_batch(y, p, rmse)
    want, got = (ev.performance_metric() for ev in evs)
    assert got.keys() == want.keys() and "f1" in got and "rmse" in got
    for k in want:
        assert got[k] == want[k], k
