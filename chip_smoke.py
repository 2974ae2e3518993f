"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each raising on failure (nothing is caught):
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles the CUDA C++ kernels (csrc/*.cu, one nvcc for sm_90a
     per source, all started together) and the Triton kernel from the
     checkout, and prints the build seconds.
  3. kernels: each kernel against its plain PyTorch version at every shape
     the eval steps give it (each fusion stream's length; the Swin stages
     over 33, 64 and 97 trunk rows), in fp32 and bf16, on live rows, with
     the stated tolerance; median kernel and plain times from CUDA events,
     beside the least time the card could take (bound) and, where one
     PyTorch call computes the same function, that call's time. swin_mlp's
     three-launch form is also timed at the widths it runs fused.
  4. config 2: BASELINE config 2 (tri_mbt_vsltcls, vslt+txt, TIE, full
     width, bf16) built by get_model with seeded random weights;
     Trainer.eval_step on seeded synthetic batches. Asserts the launch
     counts per step, that the probabilities are finite and match the
     plain path (and, tighter, in fp32), feeds them to the port's
     Evaluator, and times ms/step on both paths in turns.
  4b. config 4: the same for BASELINE config 4 (vslt+img+txt, one CXR per
     sample through the frozen Swin-T), over batches that take the
     presence-packed trunk and one that overflows it to the full batch;
     then a torch.profiler split of one step.
  5. config 5: one eval step of config 4 with --multiimages 1, the same
     checks, no timing.
Then one JSON line per the kernels and, last, {"ok": true, "device": ...}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 64
TIE_LEN = 1000
CONFIG2 = [
    "--model", "tri_mbt_vsltcls", "--input-types", "vslt_txt",
    "--vslt-type", "TIE", "--imgtxt-time", "1",
    "--output-type", "intubation",
    "--modality-inclusion", "train-missing_test-missing",
    "--batch-size", str(BATCH),
]
CONFIG4 = [a if a != "vslt_txt" else "vslt_img_txt" for a in CONFIG2]
CONFIG5 = CONFIG4 + ["--multiimages", "1"]
# present-image fractions of the batches: config 2 has no images; config 4
# packs 32 and 16 of 64 images (capacity 32, so 33 trunk rows) and
# overflows with 48 (64 rows); config 5 holds 1-3 images in 32 samples
# (at most 96 slots, the capacity of its 192 rows)
BATCHES = {"config2": [0.5] * 3, "config4": [0.5, 0.25, 0.75],
           "config5": [0.5]}
# per eval step: one TIE embedding; one attention and one FFN half per
# layer per stream (6 layers x {vslt, txt} or {vslt, img, txt}); one
# window attention and one MLP per Swin block (2 + 2 + 6 + 2)
LAUNCHES_PER_STEP = {
    "config2": {"umse": 1, "attn_block": 12, "ffn": 12},
    "config4": {"umse": 1, "attn_block": 18, "ffn": 18,
                "swin_attention": 12, "swin_mlp": 12},
}
LAUNCHES_PER_STEP["config5"] = LAUNCHES_PER_STEP["config4"]

# tolerances |kernel - plain| <= atol + rtol * |plain|, on live rows.
# fp32: both sides accumulate in fp32 in another order (C up to 768 and
# L = 1024 terms), so differences stay near 1e-5 of O(1) values.
# bf16: both sides round to bf16 at the same points, but a different
# accumulation order can flip a rounding by one unit (2**-8 relative) in
# q/k/v or the hidden layer, and the attn_block kernel keeps its
# probabilities in fp32 where the plain version casts them to bf16; an
# output of O(4) has a last unit of 2**-5.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (6e-2, 2e-2)}
# probabilities of the whole step: fp32 within 1e-4; bf16 within 5e-2,
# the drift of bf16 rounding flips through the trunk, six layers and the
# head.
PROB_TOL = {"fp32": 1e-4, "bf16": 5e-2}

KERNEL_SOURCES = {
    "umse": ("triton", "medical_tri_modal_pilot_tpu_torch/kernels/umse_triton.py",
             "medical_tri_modal_pilot_tpu/kernels/umse.py:100"),
    "attn_block": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attn_block.cu",
                   "medical_tri_modal_pilot_tpu/kernels/attn_block.py:245"),
    "ffn": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/ffn.cu",
            "medical_tri_modal_pilot_tpu/kernels/ffn.py:266"),
    "swin_attention": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/swin_attention.cu",
        "medical_tri_modal_pilot_tpu/kernels/swin_attention.py:162"),
    "swin_mlp": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/swin_mlp.cu",
                 "medical_tri_modal_pilot_tpu/kernels/swin_mlp.py:101"),
}

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, fp32 outside them,
# HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# Swin-T stages at 224 x 224: (map side, C, windows per image, whether the
# stage has shifted blocks)
SWIN_STAGES = [(56, 96, 64, True), (28, 192, 16, True), (14, 384, 4, True),
               (7, 768, 1, False)]
# trunk rows of config 4's packed batches (the main-path shapes), of its
# overflowing batch, and of config 5's packed batch
TRUNK_ROWS = (33, 64, 97)
# rows per sample of the fusion streams: vslt, txt, one image, three image
# slots (bottlenecks and cls included)
STREAM_LENGTHS = (1024, 133, 54, 152)


def check_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.kernels.umse import triton_umse
    t0 = time.perf_counter()
    _build.library()
    t1 = time.perf_counter()
    # the Triton kernel compiles at its first launch, per dtype
    dev = torch.device("cuda")
    x = torch.zeros(1, 8, 3, device=dev)
    vec = torch.zeros(256, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        triton_umse(x, vec[None], vec, vec, vec, vec[None], vec, vec, vec,
                    torch.zeros(20, 256, device=dev), dt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"build: nvcc {t1 - t0:.1f} s ({_build.library_path().name}), "
          f"triton {t2 - t1:.1f} s")


def _median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(nbytes: float, flops: float, dt) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over the peak for their type, whichever is longer."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _compare(name, dt, call, work, live=None, library=None, plain=None):
    """Run ``call`` through the kernel and ``plain`` (by default ``call``)
    through the plain version, check the tolerance on live rows, time both
    (and ``library``, one PyTorch call of the same function, where there is
    one). ``work``: (bytes, operations) the function needs on these
    inputs."""
    from medical_tri_modal_pilot_tpu_torch import ops
    plain = plain or call
    out = call()
    with ops.reference_path():
        ref = plain()
    torch.cuda.synchronize()
    if live is not None:
        out, ref = out[live], ref[live]
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    atol, rtol = TOL[dt]
    bad = int((err > atol + rtol * ref.abs()).sum())
    max_err = float(err.max())
    ms = _median_ms(call)
    with ops.reference_path():
        plain_ms = _median_ms(plain)
    library_ms = None if library is None else _median_ms(library)
    res = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           **_bound(*work, dt), "library_ms": library_ms}
    tag = "bf16" if dt == torch.bfloat16 else "fp32"
    lib = "" if library_ms is None else f" library_ms={library_ms:.3f}"
    print(f"kernel {name} {tag}: max_abs_err={max_err:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}, {bad} outside) "
          f"ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}){lib}")
    if not np.isfinite(max_err) or bad:
        raise AssertionError(f"{name} {tag} disagrees with its plain version")
    return res


def compare_kernels() -> dict:
    """Each kernel against its plain version at the eval steps' shapes. Returns
    the bf16 result at each kernel's main-path shape named in its entry."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import \
        cuda_swin_mlp
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    from medical_tri_modal_pilot_tpu_torch.models.swin import _shift_attn_mask
    dev = torch.device("cuda")
    lib = _build.library()
    g = torch.Generator(device="cpu").manual_seed(0)
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    results = {}
    D = 256
    with torch.inference_mode():
        # umse: [64, 1000, 3] (time, value, feature id)
        x = torch.stack([
            -24 * torch.rand(BATCH, TIE_LEN, generator=g),
            torch.rand(BATCH, TIE_LEN, generator=g),
            torch.randint(0, 18, (BATCH, TIE_LEN), generator=g).float()],
            dim=-1).to(dev)
        stems = [rnd(1, D), rnd(D, std=.1), rnd(D, std=.1, mean=1.),
                 rnd(D, std=.1)]
        stems += [rnd(1, D), rnd(D, std=.1), rnd(D, std=.1, mean=1.),
                  rnd(D, std=.1)]
        table = rnd(20, D)
        tokens = BATCH * TIE_LEN
        for dt in (torch.float32, bf16):
            # per token: two affine + LayerNorm + relu stems (about 10
            # operations per element each), the table row and the sum
            work = (_nbytes(x, table, *stems) + tokens * D * (2 if dt == bf16
                                                              else 4),
                    22 * tokens * D)
            r = _compare("umse[64,1000,3]", dt,
                         lambda: ops.umse(x, *stems, table, dt), work)
        results["umse"] = dict(r, shape="[64,1000,3]")

        # attn_block and ffn at each stream's length: vslt 1024 and txt 133
        # with random lengths (sample 3 with every key masked); the single
        # image (config 4) 54, unmasked; three image slots (config 5) 152
        H = 4
        for L in STREAM_LENGTHS:
            if L == 54:
                mask = None
                ends = torch.full((BATCH,), L, device=dev)
                live = None
            else:
                lengths = torch.randint(1, L + 1, (BATCH,), generator=g)
                lengths[3] = 0
                mask = length_key_mask(lengths.to(dev), L)
                ends = key_ends(mask).long()
                live = torch.arange(L, device=dev)[None, :] < ends[:, None]
            gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
            w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
            n = ends.double()
            # StdLN + q|k|v projection of the rows up to each sample's
            # last valid key, and the two attention products over them
            flops = float((6 * n * D * D + 4 * n * n * D).sum())
            for dt in (torch.float32, bf16):
                xa = rnd(BATCH, L, D).to(dt)
                wd, bd = w.to(dt), b.to(dt)
                call = lambda: ops.attn_block(xa, gamma, beta, wd, bd, mask,
                                              (D // H) ** .5, H)
                work = (2 * _nbytes(xa) + _nbytes(wd, bd, gamma, beta, mask),
                        flops)
                r = _compare(f"attn_block[64,{L},256]", dt, call, work, live)
                if L == 1024:
                    results["attn_block"] = dict(r, shape="[64,1024,256]")

            # ffn: C = 256, F = 1024 over the stream's 64*L rows; tile
            # flags where the rows align to whole tiles (vslt), else every
            # tile runs
            F = 4 * D
            gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
            w1, b1 = rnd(D, F, std=D ** -.5), rnd(F, std=.1)
            w2, b2 = rnd(F, D, std=F ** -.5), rnd(D, std=.1)
            for dt in (torch.float32, bf16):
                xf = rnd(BATCH, L, D).to(dt)
                flags = ffn_row_blocks(xf, mask)
                live = None if flags is None else flags.repeat_interleave(
                    L // flags.shape[1], dim=1)
                n_live = BATCH * L if live is None else float(live.sum())
                call = lambda: ops.ffn(xf, gamma, beta, w1, b1, w2, b2, flags)
                # the two products of the rows in live tiles
                wbytes = (D * F * 2 + F + D) * (2 if dt == bf16 else 4)
                work = (2 * _nbytes(xf) + wbytes + _nbytes(gamma, beta, flags),
                        4.0 * n_live * D * F)
                r = _compare(f"ffn[{BATCH * L},256]", dt, call, work, live)
                if live is not None:
                    skipped = ops.ffn(xf, gamma, beta, w1, b1, w2, b2,
                                      flags)[~live]
                    if not torch.equal(skipped, xf[~live]):
                        raise AssertionError("ffn: a skipped tile is not the "
                                             "residual")
            if L == 1024:
                results["ffn"] = dict(r, shape="[65536,256]")

        # swin_attention and swin_mlp at Swin-T's four stages over the trunk
        # rows of each branch; window attention with and without the shift
        # mask where the stage has shifted blocks
        for side, C, M, has_shift in SWIN_STAGES:
            nh = C // 32
            wqkv, bqkv = rnd(C, 3 * C, std=C ** -.5), rnd(3 * C, std=.1)
            wproj, bproj = rnd(C, C, std=C ** -.5), rnd(C, std=.1)
            bias = rnd(nh, 49, 49, std=.5)
            ln_s, ln_b = rnd(C, std=.1, mean=1.), rnd(C, std=.1)
            m1, c1 = rnd(C, 4 * C, std=C ** -.5), rnd(4 * C, std=.1)
            m2, c2 = rnd(4 * C, C, std=(4 * C) ** -.5), rnd(C, std=.1)
            masks = [None]
            if has_shift:
                masks.append(torch.from_numpy(
                    _shift_attn_mask(side, side, 7, 3)).to(dev))
            for rows in TRUNK_ROWS:
                I = rows * M
                T = I * 49
                for smask in masks:
                    for dt in (torch.float32, bf16):
                        xw = rnd(I, 49, C).to(dt)
                        ws = [t.to(dt) for t in (wqkv, bqkv, wproj, bproj)]
                        call = lambda: ops.swin_attention(xw, *ws, bias,
                                                          smask, nh)
                        work = (2 * _nbytes(xw) + _nbytes(*ws, bias, smask),
                                8.0 * T * C * C + 4.0 * T * 49 * C)
                        main = (rows == TRUNK_ROWS[0] and side == 56
                                and smask is not None and dt == bf16)
                        library = (_mha_library_call(xw, ws, bias, smask, nh)
                                   if main else None)
                        tag = (f"[{I},49,{C}]"
                               f"{'+mask' if smask is not None else ''}")
                        r = _compare(f"swin_attention{tag}", dt, call, work,
                                     library=library)
                        if main:
                            results["swin_attention"] = dict(r, shape=tag)
                R = rows * side * side
                for dt in (torch.float32, bf16):
                    xm = rnd(R, C).to(dt)
                    wm = [m1.to(dt), m2.to(dt)]
                    work = (2 * _nbytes(xm) + _nbytes(*wm, ln_s, ln_b, c1, c2),
                            16.0 * R * C * C)
                    call = lambda: ops.swin_mlp(xm, ln_s, ln_b, wm[0], c1,
                                                wm[1], c2)
                    r = _compare(f"swin_mlp[{R},{C}]", dt, call, work)
                    if rows == TRUNK_ROWS[0] and side == 56 and dt == bf16:
                        results["swin_mlp"] = dict(r, shape=f"[{R},{C}]")
                    if rows == TRUNK_ROWS[0] and lib.swin_mlp_fuses(C):
                        # the three-launch form at a width the fused kernel
                        # takes: the reading that keeps both forms
                        split = lambda: cuda_swin_mlp(xm, ln_s, ln_b, wm[0],
                                                      c1, wm[1], c2,
                                                      split=True)
                        _compare(f"swin_mlp[{R},{C}] split", dt, split, work,
                                 plain=call)
    return results


def _mha_library_call(xw, ws, bias, smask, nh):
    """torch's multi_head_attention_forward on the same windows: the q|k|v
    projection, scores + an additive mask holding the bias and -65504 at
    shift-masked keys, softmax, @v, the output projection. A yardstick
    only; the port never calls it."""
    import torch.nn.functional as F
    I, N, C = xw.shape
    wqkv, bqkv, wproj, bproj = ws
    sm = smask.repeat(I // smask.shape[0], 1, 1)[:, None]
    add = (bias[None] + torch.where(sm, -65504.0, 0.0)).to(xw.dtype)
    add = add.reshape(I * nh, N, N).contiguous()
    q = xw.transpose(0, 1).contiguous()
    w_in, w_out = wqkv.t().contiguous(), wproj.t().contiguous()

    def call():
        return F.multi_head_attention_forward(
            q, q, q, C, nh, w_in, bqkv, None, None, False, 0.0, w_out, bproj,
            training=False, need_weights=False, attn_mask=add)[0]
    return call


def _eval_steps(trainer, batches):
    probs, losses, rows = [], [], []
    for batch in batches:
        p, loss, _ = trainer.eval_step(batch)
        probs.append(p)
        losses.append(loss)
        rows.append(getattr(trainer.model, "trunk_rows", 0))
    return np.concatenate(probs), losses, rows


def _timed_ms(trainer, batches, reference: bool) -> float:
    from medical_tri_modal_pilot_tpu_torch import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if reference:
        with ops.reference_path():
            _eval_steps(trainer, batches)
    else:
        _eval_steps(trainer, batches)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def _profile_step(trainer, batch, power: str) -> None:
    """torch.profiler over one step (after warm-up): device time by kernel,
    the step's device total against its host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trainer.eval_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.eval_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # device events only (kernels, copies); the CPU ops that launched
    # them would count their time twice
    items = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                   reverse=True)
    total = sum(t for t, _, _ in items) / 1e3
    print(f"profile config4 bf16 step ({power}): device busy {total:.2f} ms "
          f"of {wall:.2f} ms host wall, device idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    for t, count, key in items[:16]:
        print(f"  {t / 1e3:8.3f} ms {100 * t / 1e3 / total:5.1f} % "
              f"x{count:<4d} {key[:90]}")


def run_config(name: str, argv, power: str, timed: bool) -> dict:
    """Drive one BASELINE configuration's eval step at full width: the
    launch counts of its run (reset just before, read just after), the
    plain path in bf16 and, on the same weights, in fp32, the Evaluator,
    and (``timed``) ms/step on both paths in turns."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.models.models import pack_capacity
    from medical_tri_modal_pilot_tpu_torch.train.metrics import Evaluator
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg = parse_config(argv)
    widths = (cfg.transformer_dim, cfg.transformer_num_layers,
              cfg.transformer_num_head, cfg.tie_len, cfg.precision)
    if widths != (256, 6, 4, TIE_LEN, "bf16"):
        raise AssertionError(f"{name} defaults changed: {widths}")
    fracs = BATCHES[name]
    batches = [synthetic_batch(cfg, BATCH, seed=s, present_frac=f)
               for s, f in enumerate(fracs)]
    model = get_model(cfg, torch.Generator().manual_seed(0))
    trainer = Trainer(cfg, model, device=dev, eval_only=True)

    # the main path: every kernel launch of these steps is counted
    ops.reset_launches()
    probs, losses, rows = _eval_steps(trainer, batches)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    n = len(batches)
    print(f"{name}: launches over {n} eval steps: {counts}; trunk rows per "
          f"step {rows}")
    for kernel in ops.KERNELS:
        want = LAUNCHES_PER_STEP[name].get(kernel, 0) * n
        if counts[kernel] != want:
            raise AssertionError(f"{name} {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")
    if "img" in cfg.input_types and name == "config4":
        cap = pack_capacity(cfg, BATCH)
        if cap + 1 not in rows or BATCH not in rows:
            raise AssertionError(f"{name}: trunk rows {rows} miss the packed "
                                 f"({cap + 1}) or the overflow ({BATCH}) "
                                 "branch")
    if probs.shape != (BATCH * n,) or not np.all(np.isfinite(probs)):
        raise AssertionError(f"bad probabilities {probs.shape}")
    with ops.reference_path():
        ref_probs, ref_losses, _ = _eval_steps(trainer, batches)
    d_bf16 = float(np.max(np.abs(probs - ref_probs)))
    print(f"{name} bf16: max |prob - plain prob| = {d_bf16:.3e} "
          f"(tol {PROB_TOL['bf16']}); loss {np.mean(losses):.5f} vs plain "
          f"{np.mean(ref_losses):.5f}")
    if d_bf16 > PROB_TOL["bf16"]:
        raise AssertionError(f"{name}: bf16 path disagrees with the plain "
                             "path")

    ev = Evaluator()
    for i, batch in enumerate(batches):
        ev.add_batch(batch["target"], probs[i * BATCH:(i + 1) * BATCH])
    metrics = ev.performance_metric()
    print(f"{name} evaluator (random weights): " + ", ".join(
        f"{k}={v:.4f}" for k, v in metrics.items()))
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")

    if timed:
        # timing in turns: plain, kernel, kernel, plain
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_ms(trainer, batches, reference))
        kernel_ms, plain_ms = np.mean(ms[False]), np.mean(ms[True])
        print(f"{name} eval step ({power}): kernels {kernel_ms:.2f} ms/step "
              f"({BATCH * 1e3 / kernel_ms:.1f} samples/s), plain "
              f"{plain_ms:.2f} ms/step ({BATCH * 1e3 / plain_ms:.1f} "
              f"samples/s); rounds {ms[False]} / {ms[True]}")
        if name == "config4":
            _profile_step(trainer, batches[0], power)

    # the same weights in fp32: a tight check of the kernel path (for
    # config 4 on a packed and on the overflowing batch)
    del trainer, model
    cfg32 = cfg.replace(precision="fp32")
    model32 = get_model(cfg32, torch.Generator().manual_seed(0))
    trainer32 = Trainer(cfg32, model32, device=dev, eval_only=True)
    checked = [batches[0]] + ([batches[-1]] if name == "config4" else [])
    p32, _, _ = _eval_steps(trainer32, checked)
    with ops.reference_path():
        r32, _, _ = _eval_steps(trainer32, checked)
    d32 = float(np.max(np.abs(p32 - r32)))
    print(f"{name} fp32: max |prob - plain prob| = {d32:.3e} "
          f"(tol {PROB_TOL['fp32']})")
    if d32 > PROB_TOL["fp32"]:
        raise AssertionError(f"{name}: fp32 path disagrees with the plain "
                             "path")
    del trainer32, model32
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    power = check_device()
    build_kernels()
    results = compare_kernels()
    run_config("config2", CONFIG2, power, timed=True)
    counts = run_config("config4", CONFIG4, power, timed=True)
    run_config("config5", CONFIG5, power, timed=False)
    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "steps": len(BATCHES["config4"]), **results[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
