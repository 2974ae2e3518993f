"""The port's copy of the host data path (``data/``) against the JAX
package's, on the synthetic fixtures: the train, validation and test
batches of ``get_data_loaders`` and ``get_test_data_loader``, key by key
(the same arrays, the same dtypes), for BASELINE configs 2 and 4 (TIE) and
the cross transformer's carryforward vslt+txt, with thread and native
workers, at --image-observed-prop 50; ``auto_img_pack_frac`` and
``build_txt_table`` the same; and the loader where PIL, h5py and jax
cannot be imported. One worker: thread workers share one random.Random
per dataset, so with several the train draws follow thread timing."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from medical_tri_modal_pilot_tpu import config as jconfig
from medical_tri_modal_pilot_tpu.data import indexer as jindexer
from medical_tri_modal_pilot_tpu.data import pipeline as jpipeline
from medical_tri_modal_pilot_tpu.data import txt_table as jtxt_table
from medical_tri_modal_pilot_tpu_torch import config as tconfig
from medical_tri_modal_pilot_tpu_torch.data import indexer as tindexer
from medical_tri_modal_pilot_tpu_torch.data import pipeline as tpipeline
from medical_tri_modal_pilot_tpu_torch.data import txt_table as ttxt_table

REPO = Path(__file__).resolve().parent.parent
SIDES = {"jax": (jconfig, jindexer, jpipeline, jtxt_table),
         "port": (tconfig, tindexer, tpipeline, ttxt_table)}
_TIE = ["--model", "tri_mbt_vsltcls", "--vslt-type", "TIE",
        "--imgtxt-time", "1", "--TIE-len", "64"]
CONFIGS = {
    "config2": _TIE + ["--input-types", "vslt_txt"],
    "config4": _TIE + ["--input-types", "vslt_img_txt",
                       "--img-pack-frac", "-1"],
    "cross": ["--model", "cross_transformer_txt_vslt",
              "--input-types", "vslt_txt", "--vslt-type", "carryforward"],
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_data")
    from tools.make_synthetic_fixtures import main as make
    make(["--out", str(out), "--n-train", "12", "--n-test", "6",
          "--seed", "3"])
    return str(out)


def _argv(synth, extra):
    return ["--train-data-path", f"{synth}/train",
            "--test-data-path", f"{synth}/test",
            "--image-data-path", f"{synth}/images/",
            "--biobert-path", f"{synth}/mimic4_embeddings.h5",
            "--dir-root", synth, "--output-type", "intubation",
            "--modality-inclusion", "train-missing_test-missing",
            "--batch-size", "4", "--num-workers", "1",
            "--seed-list", "412"] + list(extra)


def _loaders(side, argv, cwd, monkeypatch, table=False):
    """(cfg, train, val, test, note table) of one side, its eval index
    cache in a directory of its own."""
    config, indexer, pipeline, txt_table = SIDES[side]
    (cwd / "data").mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    cfg = config.parse_config(argv).replace(seed=412, log_fold=0)
    pd, kl = indexer.patient_wise_ordering(cfg)
    loaders = pipeline.get_data_loaders(cfg, pd, kl, 0)
    tab = (txt_table.build_txt_table(cfg, [ld.dataset for ld in loaders])
           if table else None)
    return (cfg, *loaders, tab)


def _same_batches(want, got, what):
    want, got = list(want), list(got)
    assert len(got) == len(want) > 0, what
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.keys() == b.keys(), (what, i)
        for k in a:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype, (what, i, k)
            assert np.array_equal(x, y), (what, i, k)


def _compare(synth, tmp_path, monkeypatch, extra, table=False):
    argv = _argv(synth, extra)
    sides = {s: _loaders(s, argv, tmp_path / s, monkeypatch, table)
             for s in SIDES}
    (_, jtr, jva, jte, jtab), (_, ttr, tva, tte, ttab) = (
        sides["jax"], sides["port"])
    for name, a, b in (("train", jtr, ttr), ("val", jva, tva),
                       ("test", jte, tte)):
        assert len(a) == len(b), name
        _same_batches(a, b, name)
    return sides


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loader_batches_match_jax(synth, tmp_path, monkeypatch, name):
    """Thread workers; the TIE configs with the device note table (txt_id
    rows), and config 4 with the uint8 image wire and the auto
    --img-pack-frac."""
    table = name != "cross"
    sides = _compare(synth, tmp_path, monkeypatch, CONFIGS[name], table)
    jtr, ttr = sides["jax"][1], sides["port"][1]
    assert tpipeline.auto_img_pack_frac(ttr) == \
        jpipeline.auto_img_pack_frac(jtr)
    jtab, ttab = sides["jax"][4], sides["port"][4]
    assert (jtab is None) == (ttab is None) == (not table)
    if table:
        np.testing.assert_array_equal(ttab.rows, jtab.rows)
        np.testing.assert_array_equal(ttab.lengths, jtab.lengths)
        assert ttab.rows_by_text == jtab.rows_by_text
    if name == "config4":
        batch = next(iter(sides["port"][3]))
        assert batch["img"].dtype == np.uint8 and "txt_id" in batch


@pytest.mark.parametrize("name", ["config2", "config4"])
def test_native_worker_batches_match_jax(synth, tmp_path, monkeypatch,
                                         name):
    """--worker-type native: both bind native/libtie_assembler.so."""
    from medical_tri_modal_pilot_tpu_torch.data.native import load_library
    assert load_library() is not None
    _compare(synth, tmp_path, monkeypatch,
             CONFIGS[name] + ["--worker-type", "native"])


def test_observed_prop_eval_batches_match_jax(synth, tmp_path, monkeypatch):
    """--image-observed-prop 50: the eval datasets draw each sample's
    image from their seeded random.Random, and replay is off."""
    extra = CONFIGS["config4"] + ["--image-observed-prop", "50"]
    sides = _compare(synth, tmp_path, monkeypatch, extra)
    cfg, val = sides["port"][0], sides["port"][2]
    assert tpipeline.maybe_replay(val, cfg) is val


def test_test_loader_matches_jax(synth, tmp_path, monkeypatch):
    argv = _argv(synth, CONFIGS["config2"])
    got = {}
    for side, (config, _, pipeline, _) in SIDES.items():
        (tmp_path / side / "data").mkdir(parents=True)
        monkeypatch.chdir(tmp_path / side)
        got[side] = list(pipeline.get_test_data_loader(
            config.parse_config(argv)))
    _same_batches(got["jax"], got["port"], "test")


def test_loader_runs_without_pil_h5py_jax(synth, tmp_path):
    """The card's machine has no PIL or h5py: the port's pipeline imports
    with them (and jax and the JAX package) blocked, and a vslt-only
    loader assembles its batches; an image sample raises naming PIL."""
    argv = _argv(synth, _TIE + ["--input-types", "vslt"])
    img_argv = _argv(synth, _TIE + ["--input-types", "vslt_img"])
    code = textwrap.dedent(f"""
        import sys
        for name in ("PIL", "h5py", "jax", "jaxlib", "flax", "optax",
                     "medical_tri_modal_pilot_tpu"):
            sys.modules[name] = None
        from medical_tri_modal_pilot_tpu_torch.config import parse_config
        from medical_tri_modal_pilot_tpu_torch.data import pipeline
        tr, va, te = pipeline.get_data_loaders(parse_config({argv!r}))
        batches = list(tr)
        assert batches and batches[0]["vslt"].shape[1:] == (64, 3)
        _tr, _va, te = pipeline.get_data_loaders(parse_config({img_argv!r}))
        try:
            list(te)
        except ImportError as e:
            assert "PIL" in str(e), e
            print("refused", len(batches))
        else:
            raise AssertionError("an image batch without PIL")
    """)
    (tmp_path / "data").mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("refused"), r.stdout
