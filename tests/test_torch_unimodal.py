"""BASELINE config 1's model in the port against the JAX package on the CPU:
every UMSE branch (TIE, QIE, carryforward; BioBERT and ``--berttype bert``
notes), ``TransformerEncoder`` (with and without the pad of a stream
longer than 512 rows), ``unimodal_transformer``'s eval step under each
``--vslt-type`` and two of its train steps against the JAX Trainer, the
weight bridge both ways, and ``--remat 1`` (the same gradients as
``--remat 0`` at dropout 0.1, the layers run twice). Small width: 2
layers, d 64, 4 heads; fp32; each check states its tolerance."""
import flax
import jax
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu import ops as jax_ops
from medical_tri_modal_pilot_tpu.config import parse_config as jax_parse
from medical_tri_modal_pilot_tpu.models import encoder as jenc
from medical_tri_modal_pilot_tpu.models import get_model as jax_get_model
from medical_tri_modal_pilot_tpu.models import umse as jumse
from medical_tri_modal_pilot_tpu.models.convert_ref import \
    convert_reference_state_dict
from medical_tri_modal_pilot_tpu.train import trainer as jax_trainer
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.data.synthetic import synthetic_batch
from medical_tri_modal_pilot_tpu_torch.models import convert, get_model
from medical_tri_modal_pilot_tpu_torch.models import umse
from medical_tri_modal_pilot_tpu_torch.models.convert import \
    from_jax_variables
from medical_tri_modal_pilot_tpu_torch.models.encoder import \
    TransformerEncoder
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
from test_torch_train import compare_train_state

# fp32 on both sides, the same math summed in another order
ATOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)
B = 4
D = 64
SMALL = ["--output-type", "intubation",
         "--modality-inclusion", "train-missing_test-missing",
         "--batch-size", str(B), "--TIE-len", "64",
         "--transformer-num-layers", "2", "--transformer-dim", str(D),
         "--transformer-num-head", "4", "--precision", "fp32"]
CONFIG1 = SMALL + ["--model", "unimodal_transformer", "--input-types",
                   "vslt"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(a, np.float32)


def perturb(tree, seed=1):
    """Flax initialises norms to identity, biases and cls tokens to zero;
    move every leaf so each weight is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)))
        .astype(np.float32), tree)


def draw_like(shapes, seed=1):
    """Seeded values for a flax tree of shapes (``jax.eval_shape`` of an
    init, a trace: the init itself costs seconds of XLA compile or
    dispatch on the CPU): kernels a normal of std 1/sqrt(fan-in), norm
    scales 1 + 0.1 n, every other leaf 0.1 n, so each weight is
    exercised."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        n = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "kernel":
            n = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            n = 1.0 + 0.1 * n
        else:
            n = 0.1 * n
        return n.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


# ------------------------------------------------------------- UMSE

@pytest.mark.parametrize("berttype", ["biobert", "bert"])
@pytest.mark.parametrize("vslt_type", ["TIE", "QIE", "carryforward"])
def test_umse_branch_matches_jax(vslt_type, berttype):
    """embed_vslt (the TIE kernel's tokens, plus demo under QIE; the
    carryforward stem over the grid's data channel), embed_txt (the
    BioBERT projection or the token table) and the txt timestamp
    enrichment (plus demo under QIE) against JAX ``UMSE``."""
    rng = np.random.default_rng(2)
    if vslt_type == "carryforward":
        x = rng.standard_normal((B, 3, 24, 16)).astype(np.float32)
    else:
        x = np.stack([rng.uniform(-24, 0, (B, 50)), rng.uniform(0, 1, (B, 50)),
                      rng.integers(0, 18, (B, 50))], -1).astype(np.float32)
    age, gen = rng.uniform(0, 1, (2, B)).astype(np.float32)
    if berttype == "bert":
        txt = rng.integers(0, 30000, (B, 20)).astype(np.float32)
    else:
        txt = rng.standard_normal((B, 20, 768)).astype(np.float32)
    t = rng.uniform(-24, 0, B).astype(np.float32)

    def run(mdl, x, age, gen, txt, t):
        tokens, demo = mdl.embed_vslt(x, age, gen)
        return tokens, demo, mdl.add_time_feature(mdl.embed_txt(txt), t, 19,
                                                  demo)

    jmod = jumse.UMSE(d_model=D, vslt_type=vslt_type, berttype=berttype,
                      imgtxt_time=1)
    p = perturb(jmod.init(KEY, x, age, gen, txt, t, method=run))["params"]
    want = jmod.apply({"params": p}, x, age, gen, txt, t, method=run)
    sd = {}
    convert._umse(sd, p)
    mod = umse.UMSE(D, vslt_type, berttype, vslt_len=16, txt=True,
                    timestamps=True)
    mod.load_state_dict(sd, strict=True)
    got = run(mod.eval(), *map(torch.from_numpy, (x, age, gen, txt, t)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **ATOL)


# ------------------------------------------------------- the encoder

@pytest.mark.parametrize("L,use_pe", [(40, True), (600, False)])
def test_transformer_encoder_matches_jax(L, use_pe):
    """cls token, layer_norm_in, the positional encoding, two layers; at
    L = 600 the 601 rows are padded to 768 before the key mask (JAX
    encoder.py:46-56): every row, padded ones included, within 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    lengths = np.array([L, 5, L // 2, 1]) + 1
    jmod = jenc.TransformerEncoder(d_input=D, n_layers=2, n_head=4,
                                   d_model=D, d_ff=4 * D, dropout=0.0,
                                   pe_maxlen=2000, use_pe=use_pe,
                                   classification=True)
    p = perturb(jmod.init(KEY, x, lengths))["params"]
    want = np.asarray(jmod.apply({"params": p}, x, lengths))
    sd = {}
    convert._encoder(sd, "enc", p)
    mod = TransformerEncoder(2, 4, D, 4 * D, dropout=0.0, pe_maxlen=2000,
                             use_pe=use_pe)
    mod.load_state_dict({k[4:]: v for k, v in sd.items()}, strict=True)
    got = mod.eval()(torch.from_numpy(x), torch.from_numpy(lengths))
    assert got.shape == want.shape == (B, 768 if L > 512 else L + 1, D)
    np.testing.assert_allclose(_np(got), want, **ATOL)


# ------------------------------------------------- the model, eval step

def jax_and_port(argv, batch, stats_seed=1):
    """A JAX eval-only Trainer with every parameter perturbed and random
    BatchNorm statistics, its variables, and the port's Trainer with
    those weights carried across (strict load)."""
    jcfg, cfg = jax_parse(argv), parse_config(argv)
    jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batch,
                             eval_only=True)
    variables = {
        "params": perturb(flax.core.unfreeze(jax.device_get(
            jt.state.params))),
        "batch_stats": flax.core.unfreeze(jax.device_get(
            jt.state.batch_stats))}
    if "fc_list" in variables["batch_stats"]:
        rng = np.random.default_rng(stats_seed)
        bn = variables["batch_stats"]["fc_list"]["bn"]
        bn["mean"] = rng.normal(0, .3, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(.5, 2, bn["var"].shape).astype(np.float32)
    jt.state = jt.state.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"])
    model = get_model(cfg)
    model.load_state_dict(from_jax_variables(cfg, variables), strict=True)
    return cfg, jt, variables, Trainer(cfg, model, "cpu")


def check_eval(jt, tr, batch):
    """probs and loss of one eval step within 1e-5."""
    probs, loss, _ = tr.eval_step(batch)
    want_probs, want_loss, _ = jt.eval_step(batch)
    assert probs.shape == (B,) and np.all(np.isfinite(probs))
    np.testing.assert_allclose(probs, np.asarray(want_probs), atol=1e-5)
    assert loss == pytest.approx(float(want_loss), abs=1e-5)


@pytest.mark.parametrize("vslt_type", ["TIE", "QIE", "carryforward"])
def test_unimodal_eval_step_matches_jax(vslt_type):
    """TIE and QIE at TIE-len 600 with bucketing off (601 rows with the
    cls token, padded to 768), carryforward on its 24-step grid with the
    positional encoding."""
    argv = CONFIG1 + ["--vslt-type", vslt_type, "--TIE-len", "600",
                      "--tie-buckets", "off"]
    batch = synthetic_batch(parse_config(argv), B, seed=4)
    if vslt_type != "carryforward":
        batch["input_length"][0] = 600
    try:
        _, jt, _, tr = jax_and_port(argv, batch)
        check_eval(jt, tr, batch)
    finally:
        jax_ops.configure(False)


def round_trip(cfg, variables, model):
    """The port's state_dict through the JAX package's reference
    converter gives back the JAX tree leaf for leaf and uses every key;
    seeded port weights come back through from_jax_variables."""
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
    seeded = get_model(cfg, torch.Generator().manual_seed(5)).state_dict()
    params, stats = convert_reference_state_dict(
        cfg, {k: v.numpy() for k, v in seeded.items()})
    back = from_jax_variables(cfg, {"params": params, "batch_stats": stats})
    assert back.keys() == seeded.keys()
    for k in seeded:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], seeded[k]), k


@pytest.mark.parametrize("vslt_type", ["TIE", "QIE"])
def test_unimodal_bridge_round_trip(vslt_type):
    """The reference names (transformer_encoder.layer_stack.i,
    layer_norm_final, fc_list) both ways. Carryforward is left out: its
    JAX model holds no ie_time stem (flax builds a stem where it is
    called), and the reference converter requires one."""
    argv = CONFIG1 + ["--vslt-type", vslt_type]
    batch = synthetic_batch(parse_config(argv), B, seed=4)
    try:
        cfg, _, variables, tr = jax_and_port(argv, batch)
        round_trip(cfg, variables, tr.model)
    finally:
        jax_ops.configure(False)


# ------------------------------------------------ train steps, remat

def check_train_steps(argv, batches):
    """Two optimizer steps (--dropout 0, adamw) from the same weights on
    both sides: loss (1e-5), parameters, Adam moments and BatchNorm
    statistics (tests/test_torch_train.py's bounds)."""
    argv = argv + ["--dropout", "0"]
    cfg, jcfg = parse_config(argv), jax_parse(argv)
    try:
        jt = jax_trainer.Trainer(jcfg, jax_get_model(jcfg), 1, batches[0])
        variables = jax.device_get({"params": jt.state.params,
                                    "batch_stats": jt.state.batch_stats})
        model = get_model(cfg)
        model.load_state_dict(from_jax_variables(cfg, variables),
                              strict=True)
        tr = Trainer(cfg, model, "cpu", eval_only=False)
        lr_sum = 0.0
        for batch in batches:
            assert tr.current_lr() == pytest.approx(jt.current_lr(),
                                                    rel=1e-6)
            lr_sum += tr.current_lr()
            loss = tr.train_step(batch)
            assert loss == pytest.approx(float(jt.train_step(batch)),
                                         abs=1e-5)
        compare_train_state(cfg, jt, tr, lr_sum)
    finally:
        jax_ops.configure(False)


def test_unimodal_train_steps_match_jax():
    cfg = parse_config(CONFIG1)
    check_train_steps(CONFIG1, [synthetic_batch(cfg, B, seed=s)
                                for s in (3, 4)])


def remat_step(argv, remat, batch):
    """One train step at --dropout 0.1 from seeded weights: the loss, the
    gradients, and how often the first encoder layer's attention ran."""
    cfg = parse_config(argv + ["--dropout", "0.1", "--remat", str(remat)])
    model = get_model(cfg, torch.Generator().manual_seed(0))
    layer = (model.transformer_encoder.layer_stack[0]
             if hasattr(model, "transformer_encoder")
             else model.fusion_transformer.layer_stacks[0][0])
    calls = []
    layer.self_attention.register_forward_hook(lambda *a: calls.append(1))
    tr = Trainer(cfg, model, "cpu", eval_only=False, seed=3)
    loss = tr.train_step(batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss, grads, len(calls)


@pytest.mark.parametrize("argv", [
    CONFIG1 + ["--vslt-type", "TIE"],
    SMALL + ["--model", "bi_vslttxt_mbt_v1", "--input-types", "vslt_txt",
             "--imgtxt-time", "1"]], ids=["unimodal", "bi_vslttxt"])
def test_remat_gradients_equal_no_remat(argv):
    """--remat 1 recomputes each encoder layer in the backward (the
    first layer's attention runs twice in a step, once without it) and
    its dropout masks are the same: the loss equal and every gradient
    within 1e-6 relative Frobenius of --remat 0's, dropout 0.1."""
    batch = synthetic_batch(parse_config(argv), B, seed=5)
    loss0, g0, calls0 = remat_step(argv, 0, batch)
    loss1, g1, calls1 = remat_step(argv, 1, batch)
    assert (calls0, calls1) == (1, 2)
    assert loss1 == loss0
    assert g1.keys() == g0.keys()
    for n, g in g0.items():
        err = float((g1[n] - g).norm() / g.norm().clamp_min(1e-30))
        assert err <= 1e-6, (n, err)
