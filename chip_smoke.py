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
  6. training kernels: the training forward of attn_block and its backward,
     ffn with dropout and its backward, at each fusion stream's length in
     fp32 and bf16, against autograd of the plain versions on the same
     inputs (the cotangent zero on rows no later layer reads), forward on
     live rows and every gradient; dropout_masks bit for bit against its
     plain version, and its keep rate within binomial bounds. Median
     kernel and plain ms of forward and backward, the bound, the library
     column.
  7. config 4 train: Trainer.train_step at full width (bf16, batch 64,
     --dropout 0.1, adamw) over seeded batches through the packed trunk
     and its overflow: launch counts per step, peak device memory; one
     step from identical weights on the kernel and the plain path, fp32
     and bf16 at dropout 0 and 0.1 (the plain path draws the same Philox
     masks): loss, every trainable parameter's gradient (bf16 held
     against the fp32 step) and the updated parameters; train ms/step on
     both paths in turns; a torch.profiler split of one kernel-path step;
     20 steps on one batch, the loss finite and falling.
  8. config 2 train: a few steps, launch counts, one step on both paths
     (fp32 and bf16, dropout 0.1); not timed.
  9. attention: the masked attention of the cross-modal layers, its lean
     form, its training form and its backward, against autograd of the
     plain version in fp32 and bf16: at both cross shapes ([64, 24] queries
     against [64, 128] keys with the txt key mask, and back with the vslt
     key mask) and at small shapes with no mask, a key mask with padding
     mid-sequence, an all-masked sample, a block mask and a
     self-attention with dead q tiles (compared on live rows). Median
     kernel and plain ms, the bound, and the library column at the cross
     shapes: one scaled_dot_product_attention call on the same inputs,
     and its backward (autograd.grad of that call).
  10. cross transformer eval: cross_transformer_txt_vslt (carryforward
     vslt + BioBERT notes, full width, bf16) as phase 4: launch counts,
     probabilities against the plain path in bf16 and fp32, ms/step in
     turns.
  11. cross transformer train: as phase 7 for that model (no image trunk):
     launch counts, peak memory, ms/step in turns, a profiler split, 20
     steps on one batch, one step on both paths in fp32 and bf16 at
     dropout 0 and 0.1.
  12. rowmm: the row-skipping projections of tensor parallelism, forward
     and backward against autograd of their plain versions in fp32 and
     bf16: the LN-fused form at one rank's q|k|v width under --mp-size 2
     (x [65536, 256], W [256, 384]) and at the single-device width (W
     [256, 768]), the plain form at [65536, 256] x [256, 768] beside
     torch.addmm; block flags from TIE lengths. Phase 9 also runs the
     attention at the tensor-parallel self shape ([64, 1024, 2, 64] with
     the TIE key mask) beside scaled_dot_product_attention.
  13. tensor parallelism: config 4 under --mp-size 2 --dp-size 1 in two
     ranks (parallel.launch) that share the one card over gloo, weights
     seeded as the single-process run: eval probabilities against the
     single-process kernel path (bf16 and fp32), one fp32 train step at
     dropout 0.1 (every gradient, gathered, against the single process's),
     launch counts per rank, ms/step and peak memory per rank (two ranks on
     one card: not a speed figure of tensor parallelism), a profiler split
     with gloo's share, a few steps on one batch with the loss falling.
The kernel phases (3, 6, 9, 12) run first, then 4-5, 7-8, 10-11 and 13.
Then one JSON line per the kernels (each with the path that launches it
and its launches over that path's steps) and, last, {"ok": true,
"device": ...}.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
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
# the cross-modal transformer over carryforward vital signs (window 24, 16
# channels plus age and gender) and BioBERT notes (128 x 768): 3 self
# layers per stream, then 3 bidirectional cross layers
CROSS = [
    "--model", "cross_transformer_txt_vslt", "--input-types", "vslt_txt",
    "--vslt-type", "carryforward", "--output-type", "intubation",
    "--modality-inclusion", "train-missing_test-missing",
    "--batch-size", str(BATCH),
]
# present-image fractions of the batches: config 2 has no images; config 4
# packs 32 and 16 of 64 images (capacity 32, so 33 trunk rows) and
# overflows with 48 (64 rows); config 5 holds 1-3 images in 32 samples
# (at most 96 slots, the capacity of its 192 rows)
BATCHES = {"config2": [0.5] * 3, "config4": [0.5, 0.25, 0.75],
           "config5": [0.5], "cross": [0.5] * 3}
# per eval step: one TIE embedding; one attention and one FFN half per
# layer per stream (6 layers x {vslt, txt} or {vslt, img, txt}); one
# window attention and one MLP per Swin block (2 + 2 + 6 + 2)
LAUNCHES_PER_STEP = {
    "config2": {"umse": 1, "attn_block": 12, "ffn": 12},
    "config4": {"umse": 1, "attn_block": 18, "ffn": 18,
                "swin_attention": 12, "swin_mlp": 12},
}
LAUNCHES_PER_STEP["config5"] = LAUNCHES_PER_STEP["config4"]
# the cross transformer: an attention and an FFN half per self layer and
# stream (3 x 2), an attention and an FFN per cross layer and direction
# (3 x 2)
LAUNCHES_PER_STEP["cross"] = {"attn_block": 6, "ffn": 12, "attention": 6}
# per train step: the forward's launches; a backward per fusion layer and
# stream whose output the loss reaches (the last layer's non-vslt streams
# feed only the bottleneck mix, which nothing reads after the last layer,
# so autograd runs no backward for them: 16 of 18, 11 of 12); one
# dropout_masks per stream for the input dropout at --dropout 0.1 (the
# FFN's masks are drawn inside its kernels)
TRAIN_LAUNCHES_PER_STEP = {
    "config2": {"umse": 1, "attn_block": 12, "attn_block_bwd": 11,
                "ffn": 12, "ffn_bwd": 11, "dropout_masks": 2},
    "config4": {"umse": 1, "attn_block": 18, "attn_block_bwd": 16,
                "ffn": 18, "ffn_bwd": 16, "dropout_masks": 3,
                "swin_attention": 12, "swin_mlp": 12},
}
# the cross transformer's both streams reach the head through their
# pooled features, so every layer gets its backward
TRAIN_LAUNCHES_PER_STEP["cross"] = {
    "attn_block": 6, "attn_block_bwd": 6, "ffn": 12, "ffn_bwd": 12,
    "attention": 6, "attention_bwd": 6}
TRAIN_BATCHES = {"config2": [0.5, 0.5], "config4": [0.5, 0.25, 0.75],
                 "cross": [0.5] * 3}
DROPOUT_SEED = 20231016

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
# gradients: |kernel - plain|_F / |plain|_F per tensor (the largest
# element difference over the largest plain entry is printed beside it).
# A ReLU pre-activation within rounding of 0 takes the other branch on one
# side (about 50 of the 67M hidden units of the vslt FFN in fp32, measured
# as a 2e-2 max-element gap in dx and 7e-3 in dW1, with dW2 within 1e-6):
# each such unit moves one row of dx and one column of dW1 by a few
# percent, which the Frobenius ratio weighs by their share. fp32: the same
# math summed in another order, plus those flips. bf16: the plain version
# is autograd of a bf16 graph, which rounds every intermediate gradient to
# bf16 (2**-9 relative) where the kernels keep fp32 and round where the
# TPU kernels do.
GRAD_TOL = {torch.float32: 5e-3, torch.bfloat16: 5e-2}
# a whole train step from the same weights, kernel vs plain path, per
# trainable tensor with a nonzero true gradient, as GRAD_TOL: fp32 within
# 1e-2 (six layers of such flips, the head's BatchNorm over 64 samples).
# bf16 gradients of this model lie 0.1-0.2 from the fp32 ones on either
# path, so each bf16 path is held against the fp32 plain step at the same
# dropout: the kernel path's median and largest errors must stay within
# STEP_BF16_RATIO of the plain path's (plus 1e-2). The loss within 1e-4
# (fp32) and 2e-2 (bf16) absolute.
STEP_FP32_TOL = 1e-2
STEP_BF16_RATIO = 1.5
STEP_LOSS_TOL = {"fp32": 1e-4, "bf16": 2e-2}

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
    # the weight-gradient sums of both backward kernels run in
    # csrc/wgrad.cu
    "attn_block_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attn_block_bwd.cu",
        "medical_tri_modal_pilot_tpu/kernels/attn_block.py:577"),
    "ffn_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/ffn.cu",
                "medical_tri_modal_pilot_tpu/kernels/ffn.py:298"),
    "dropout_masks": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/ffn.cu",
                      "medical_tri_modal_pilot_tpu/kernels/ffn.py:230"),
    "attention": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attention.cu",
                  "medical_tri_modal_pilot_tpu/kernels/attention.py:257"),
    "attention_bwd": (
        "cuda", "medical_tri_modal_pilot_tpu_torch/csrc/attention.cu",
        "medical_tri_modal_pilot_tpu/kernels/attention.py:431"),
    # the backward kernels' weight sums run in csrc/wgrad.cu
    "rowmm_ln": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
                 "medical_tri_modal_pilot_tpu/kernels/rowmm.py:240"),
    "rowmm_ln_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
                     "medical_tri_modal_pilot_tpu/kernels/rowmm.py:269"),
    "rowmm": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
              "medical_tri_modal_pilot_tpu/kernels/rowmm.py:182"),
    "rowmm_bwd": ("cuda", "medical_tri_modal_pilot_tpu_torch/csrc/rowmm.cu",
                  "medical_tri_modal_pilot_tpu/kernels/rowmm.py:208"),
}
# the path whose train steps give each kernel's launches in the kernels
# line: the masked attention runs in the cross transformer, the LN-fused
# projection under tensor parallelism, the plain projection on no path
# (the JAX package dispatches it nowhere), every other kernel in config 4
KERNEL_PATHS = {name: "cross" if name.startswith("attention") else "config4"
                for name in KERNEL_SOURCES}
KERNEL_PATHS.update(rowmm_ln="tp", rowmm_ln_bwd="tp", rowmm=None,
                    rowmm_bwd=None)

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


def _grad_errors(grads, ref_grads):
    """Per tensor: |g - r|_F / |r|_F."""
    return [float((g - r).norm()) / max(float(r.norm()), 1e-30)
            for g, r in zip(grads, ref_grads)]


def _max_errors(grads, ref_grads):
    """Per tensor: the largest difference over the largest plain entry."""
    return [float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
            for g, r in zip(grads, ref_grads)]


def _compare_train(name, dt, fwd, inputs, cot, live, work_fwd, work_bwd,
                   library=None):
    """The training forward and the backward of ``fwd`` on the kernel path
    against the plain path: the output on live rows (TOL), every gradient
    (GRAD_TOL); median ms of forward and backward on both paths, and of
    ``library`` (a forward and a backward call of PyTorch's own, where
    there are such)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    runs = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        ctx = ops.reference_path() if plain else contextlib.nullcontext()
        with ctx:
            out = fwd(*leaves)
            grads = torch.autograd.grad(out, leaves, cot, retain_graph=True)
            f_ms = _median_ms(lambda: fwd(*leaves), reps=10)
            b_ms = _median_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True), reps=10)
        runs.append((out.detach().float(), [g.float() for g in grads],
                     f_ms, b_ms))
        del out, grads, leaves
    (out, grads, f_ms, b_ms), (ref, ref_grads, pf_ms, pb_ms) = runs
    torch.cuda.synchronize()
    if live is not None:
        out, ref = out[live], ref[live]
    err = (out - ref).abs()
    atol, rtol = TOL[dt]
    bad = int((err > atol + rtol * ref.abs()).sum())
    g_err = _grad_errors(grads, ref_grads)
    tag = "bf16" if dt == torch.bfloat16 else "fp32"
    lib_f, lib_b = ((None, None) if library is None
                    else (_median_ms(library[0]), _median_ms(library[1])))
    fwd_res = {"max_abs_err": float(err.max()), "ms": f_ms,
               "plain_ms": pf_ms, **_bound(*work_fwd, dt),
               "library_ms": lib_f}
    bwd_res = {"max_abs_err": max(float((g - r).abs().max())
                                  for g, r in zip(grads, ref_grads)),
               "grad_err_f": max(g_err), "ms": b_ms, "plain_ms": pb_ms,
               **_bound(*work_bwd, dt), "library_ms": lib_b}
    lib = ("" if library is None else
           f" library_ms={lib_f:.3f} / {lib_b:.3f} (forward / backward)")
    print(f"kernel {name} train fwd {tag}: max_abs_err="
          f"{fwd_res['max_abs_err']:.3e} ({bad} outside) ms={f_ms:.3f} "
          f"plain_ms={pf_ms:.3f} bound_ms={fwd_res['bound_ms']:.4f} "
          f"({fwd_res['bound_by']}){lib}")
    m_err = _max_errors(grads, ref_grads)
    print(f"kernel {name} bwd {tag}: grad |err|_F/|plain|_F "
          f"{' '.join(f'{e:.2e}' for e in g_err)} (tol {GRAD_TOL[dt]:g}); "
          f"max |err| / max |plain| {' '.join(f'{e:.2e}' for e in m_err)} "
          f"ms={b_ms:.3f} plain_ms={pb_ms:.3f} "
          f"bound_ms={bwd_res['bound_ms']:.4f} ({bwd_res['bound_by']})")
    if bad or not np.isfinite(fwd_res["max_abs_err"]):
        raise AssertionError(f"{name} {tag}: training forward disagrees")
    if not all(np.isfinite(e) and e <= GRAD_TOL[dt] for e in g_err):
        raise AssertionError(f"{name} {tag}: gradients disagree")
    return fwd_res, bwd_res


def compare_training_kernels() -> dict:
    """The training kernels against autograd of their plain versions at each
    fusion stream's length, and the dropout masks. Returns the bf16 results
    at the main-path shapes (vslt: [64, 1024, 256], R = 65536)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import (
        keep_threshold, plain_dropout_masks)
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    bf16 = torch.bfloat16
    D, H, F, P = 256, 4, 1024, 0.1

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    results = {}
    for L in STREAM_LENGTHS:
        if L == 54:
            mask, ends = None, torch.full((BATCH,), L, device=dev)
        else:
            lengths = torch.randint(1, L + 1, (BATCH,), generator=g)
            lengths[3] = 0
            mask = length_key_mask(lengths.to(dev), L)
            ends = key_ends(mask).long()
        live = torch.arange(L, device=dev)[None, :] < ends[:, None]
        n = ends.double()
        gamma, beta = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
        w, b = rnd(D, 3 * D, std=D ** -.5), rnd(3 * D, std=.1)
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            xa = rnd(BATCH, L, D).to(dt)
            cot = rnd(BATCH, L, D).to(dt) * live[:, :, None]
            stream_bytes = BATCH * L * D * es
            # forward: the lean form's work plus O and the (m, l) stats;
            # backward: s, dp, dv, dk and dq over the live pairs (10 n^2 C)
            # and the q|k|v recompute, dln and dW products (18 n C^2)
            work_f = (3 * stream_bytes + 8 * BATCH * H * L
                      + (3 * D * D + 3 * D) * es,
                      float((6 * n * D * D + 4 * n * n * D).sum()))
            work_b = (4 * stream_bytes + 8 * BATCH * H * L
                      + (3 * D * D + 3 * D) * (es + 4),
                      float((10 * n * n * D + 18 * n * D * D).sum()))
            fr, br = _compare_train(
                f"attn_block[64,{L},256]", dt,
                lambda *a: ops.attn_block(*a, mask, (D // H) ** .5, H),
                (xa, gamma, beta, w.to(dt), b.to(dt)), cot, live, work_f,
                work_b)
            if L == 1024 and dt == bf16:
                results["attn_block_train"] = dict(fr, shape="[64,1024,256]")
                results["attn_block_bwd"] = dict(br, shape="[64,1024,256]")

        g1, be1 = rnd(D, std=.1, mean=1.), rnd(D, std=.1)
        w1, b1 = rnd(D, F, std=D ** -.5), rnd(F, std=.1)
        w2, b2 = rnd(F, D, std=F ** -.5), rnd(D, std=.1)
        for dt in (torch.float32, bf16):
            es = 2 if dt == bf16 else 4
            xf = rnd(BATCH, L, D).to(dt)
            flags = ffn_row_blocks(xf, mask)
            rows = (None if flags is None else
                    flags.repeat_interleave(L // flags.shape[1], dim=1))
            n_live = BATCH * L if rows is None else float(rows.sum())
            cot = rnd(BATCH, L, D).to(dt)
            if rows is not None:
                cot = cot * rows[:, :, None]
            wbytes = (2 * D * F + F + D) * 4
            work_f = (2 * BATCH * L * D * es + wbytes, 4.0 * n_live * D * F)
            # h recompute, dh, dln, dW1 and dW2: five products
            work_b = (3 * BATCH * L * D * es + 2 * wbytes,
                      10.0 * n_live * D * F)
            fr, br = _compare_train(
                f"ffn[{BATCH * L},256] dropout {P}", dt,
                lambda *a: ops.ffn(*a, flags, p=P, training=True,
                                   seed=DROPOUT_SEED),
                (xf, g1, be1, w1, b1, w2, b2), cot, rows, work_f, work_b)
            if L == 1024 and dt == bf16:
                results["ffn_train"] = dict(fr, shape="[65536,256]")
                results["ffn_bwd"] = dict(br, shape="[65536,256]")

    # dropout masks at the vslt stream's FFN shapes: bit for bit, keep rate
    R = BATCH * 1024
    with torch.inference_mode():
        got = ops.dropout_masks(R, F, D, DROPOUT_SEED, P, dev)
        with ops.reference_path():
            want = ops.dropout_masks(R, F, D, DROPOUT_SEED, P, dev)
        torch.cuda.synchronize()
        same = all(torch.equal(a, e) for a, e in zip(got, want))
        keep = [float(k.float().mean()) for k in got]
        sds = [((1 - P) * P / k.numel()) ** .5 for k in got]
        ms = _median_ms(lambda: ops.dropout_masks(R, F, D, DROPOUT_SEED, P,
                                                  dev))
        with ops.reference_path():
            plain_ms = _median_ms(lambda: plain_dropout_masks(
                R, F, D, DROPOUT_SEED, P, dev), reps=5)
    # the int8 masks written once; Philox4x32-10 is ~25 integer operations
    # per mask element (10 rounds of 2 multiplies, 2 high words, 3 xors and
    # 2 key additions per 4 words), held to the card's non-tensor rate
    work = (R * (F + D), 25.0 * R * (F + D))
    res = {"max_abs_err": 0.0 if same else 1.0, "ms": ms,
           "plain_ms": plain_ms, **_bound(*work, torch.float32),
           "library_ms": None, "shape": f"[{R},{F}]+[{R},{D}]",
           "keep_rate": keep, "threshold": keep_threshold(P)}
    print(f"kernel dropout_masks [{R},{F}]+[{R},{D}] p={P}: bit-identical "
          f"{same}; keep rate {keep[0]:.6f} / {keep[1]:.6f} (q {1 - P}, "
          f"sd {sds[0]:.2e} / {sds[1]:.2e}) ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={res['bound_ms']:.4f} "
          f"({res['bound_by']})")
    if not same:
        raise AssertionError("dropout_masks differs from its plain version")
    if any(abs(k - (1 - P)) > 5 * sd for k, sd in zip(keep, sds)):
        raise AssertionError(f"dropout keep rate {keep} outside 5 sd of "
                             f"{1 - P}")
    results["dropout_masks"] = res
    return results


# the cross-modal layers' attention, 4 heads of 64 over batch 64: (name,
# Lq, Lk, key mask) with the mask of the kv stream: cross_v's vslt queries
# against the txt stream (clip(txt_length + 2, 1, 128) valid keys),
# cross_o's txt queries against the vslt stream (input_length in [1, 24])
CROSS_SHAPES = (("cross_v", 24, 128, "txt"), ("cross_o", 128, 24, "vslt"))
# the tensor-parallel self-attention of config 4, one rank's 2 of 4 heads
# over each fusion stream: (name, L, mask) for the TIE stream's 1024 rows
# (key mask at input_length + 1 cls + 4 bottlenecks), the notes' 133 (key
# mask at the note length + 1 cls + 4 bottlenecks) and the image's 54 (no
# mask)
TP_SELF = (("tp_self", 1024, "tie"), ("tp_txt", 133, "txt_self"),
           ("tp_img", 54, "img_self"))
# small shapes: (B, H, Lq, Lk, d_head, mask form)
ATTN_SMALL = ((3, 2, 54, 54, 32, "none"), (3, 2, 130, 130, 32, "noncontig"),
              (3, 2, 40, 100, 32, "all_masked"),
              (2, 2, 130, 70, 32, "block"), (3, 2, 300, 300, 64, "self"))


def _attention_case(g, dev, B, H, Lq, Lk, D, kind):
    """fp32 q, k, v, the mask, is_self and the live rows [B, Lq] (under
    is_self, the rows before each sample's last valid key)."""
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    from medical_tri_modal_pilot_tpu_torch.models.modules import \
        length_key_mask

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    q, k, v = rnd(B, Lq, H, D), rnd(B, Lk, H, D), rnd(B, Lk, H, D)
    lengths = {
        "txt": (torch.randint(0, 129, (B,), generator=g) + 2).clamp(1, Lk),
        "vslt": torch.randint(1, Lk + 1, (B,), generator=g),
        "tie": torch.randint(5, TIE_LEN + 1, (B,), generator=g) + 5,
        "self": torch.tensor([10, 150, Lk]),
        "all_masked": torch.linspace(0, Lk, B).long()}.get(kind)
    if kind == "txt_self":
        # 4 bottleneck keys, then cls and the notes; samples 0 and 3
        # without notes: the bottleneck keys alone
        lengths = torch.randint(5, Lk + 1, (B,), generator=g)
        lengths[:4] = torch.tensor([4, 40, Lk, 4])
    mask = None
    if lengths is not None:
        mask = length_key_mask(lengths.to(dev), Lk)
    elif kind == "noncontig":
        mask = torch.rand(B, Lk, generator=g).to(dev) < 0.5
    elif kind == "block":
        mask = torch.rand(B, Lq, Lk, generator=g).to(dev) < 0.5
        mask[:, :, 0] = False
        mask[0, 3] = True   # a query whose every key is masked
    live = torch.ones(B, Lq, dtype=torch.bool, device=dev)
    is_self = kind in ("self", "tie", "txt_self", "img_self")
    if is_self and mask is not None:
        live = torch.arange(Lq, device=dev)[None] < key_ends(mask)[:, None]
    return q, k, v, mask, is_self, live


def _attention_work(q, k, mask, is_self, backward=False):
    """(bytes, operations) of the attention on these inputs: q, k, v, the
    mask and the output once (the backward: q, k, v, out, dout, the stats
    and the mask read, dq, dk, dv written); the products over the (query,
    key) pairs the data needs: with a key mask, the keys up to each
    sample's last valid one and, under is_self, the queries before it. Two
    products forward (s and p v), five backward (s, dp, dv, dk, dq)."""
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import key_ends
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    nq = torch.full((B,), float(Lq), dtype=torch.float64)
    nk = torch.full((B,), float(Lk), dtype=torch.float64)
    if mask is not None and mask.dim() == 2:
        nk = key_ends(mask).double().cpu()
        if is_self:
            nq = nk
    pairs = float((nq * nk).sum())
    stats = B * H * Lq * 8
    if backward:
        nbytes = 4 * _nbytes(q) + 4 * _nbytes(k) + stats + _nbytes(mask)
        return nbytes, 10.0 * H * D * pairs
    return 2 * _nbytes(q) + 2 * _nbytes(k) + _nbytes(mask), 4.0 * H * D * pairs


def compare_attention_kernels() -> dict:
    """The masked attention against its plain version: the lean form, the
    training form and the backward, fp32 and bf16, at the cross-modal
    layers' shapes and at the tensor-parallel self shapes of the three
    streams (with scaled_dot_product_attention on the same inputs as the
    library column) and at the small shapes of every mask form. Returns the
    bf16 results at cross_v's shape and (``attention_tp*``) at the TIE
    stream's TP shape."""
    import torch.nn.functional as F
    from medical_tri_modal_pilot_tpu_torch import ops
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    cases = [(name, BATCH, 4, Lq, Lk, 64, kind)
             for name, Lq, Lk, kind in CROSS_SHAPES]
    cases += [(name, BATCH, 2, L, L, 64, kind) for name, L, kind in TP_SELF]
    cases += [(c[5], *c) for c in ATTN_SMALL]
    results = {}
    for name, B, H, Lq, Lk, D, kind in cases:
        q, k, v, mask, is_self, live = _attention_case(g, dev, B, H, Lq, Lk,
                                                       D, kind)
        tag = f"attention {name} q[{B},{Lq},{H},{D}] kv[{B},{Lk},{H},{D}]"
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            cot = torch.randn(B, Lq, H, D, generator=g).to(dev).to(dt)
            cot = cot * live[:, :, None, None]
            library = None
            if name.startswith(("cross", "tp_")):
                # [B, H, L, Dh] copies made before the timing; True = attend
                qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                              for t in (qd, kd, vd))
                keep = None if mask is None else ~mask[:, None, None, :]

                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=keep)
                out_t, cot_t = sdpa(), cot.transpose(1, 2).contiguous()

                def sdpa_bwd():
                    return torch.autograd.grad(out_t, (qt, kt, vt), cot_t,
                                               retain_graph=True)
                library = (sdpa, sdpa_bwd)
            with torch.inference_mode():
                r = _compare(tag, dt, lambda: ops.attention(
                    qd, kd, vd, mask, D ** .5, is_self),
                    _attention_work(qd, kd, mask, is_self), live,
                    library=library and library[0])
            fr, br = _compare_train(
                tag, dt, lambda *a: ops.attention(*a, mask, D ** .5, is_self),
                (qd, kd, vd), cot, live,
                _attention_work(qd, kd, mask, is_self),
                _attention_work(qd, kd, mask, is_self, backward=True),
                library=library)
            shape = f"q[{B},{Lq},{H},{D}] kv[{B},{Lk},{H},{D}]"
            key = {"cross_v": "attention", "tp_self": "attention_tp"}.get(
                name)
            if key and dt == torch.bfloat16:
                results[key] = dict(r, shape=shape)
                results[f"{key}_train"] = dict(fr, shape=shape)
                results[key.replace("attention", "attention_bwd")] = dict(
                    br, shape=shape)
    return results


# the row-skipping projections: (result key, output width, LN-fused): one
# rank's q|k|v under --mp-size 2, the single-device q|k|v, and the plain
# form at the single-device width (no path reaches it)
ROWMM_SHAPES = (("rowmm_ln", 384, True), ("rowmm_ln_768", 768, True),
                ("rowmm", 768, False))


def compare_rowmm_kernels() -> dict:
    """rowmm_ln and rowmm, forward and backward, against autograd of their
    plain versions in fp32 and bf16 over x [64 * 1024, 256], the 256-row
    block flags of TIE lengths uniform in [5, 1000] (the fusion stream's
    key mask), the cotangent zero on dead blocks. torch.addmm (and its
    autograd.grad) is the library column of the plain form; no PyTorch call
    computes the LN form. Returns the bf16 results by kernel name."""
    import torch.nn.functional as F
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import BLOCK_R
    from medical_tri_modal_pilot_tpu_torch.models.modules import (
        ffn_row_blocks, length_key_mask)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(3)
    L, D = 1024, 256
    lengths = torch.randint(5, TIE_LEN + 1, (BATCH,), generator=g) + 5
    mask = length_key_mask(lengths.to(dev), L)

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    flags = ffn_row_blocks(mask[:, :, None], mask, BLOCK_R)
    live = flags.repeat_interleave(BLOCK_R, dim=1)
    n_live = float(live.sum())
    R = BATCH * L
    print(f"rowmm: {int(flags.sum())} of {flags.numel()} row blocks live "
          f"({n_live / R:.3f} of the rows)")
    results = {}
    for key, cout, ln in ROWMM_SHAPES:
        name = "rowmm_ln" if ln else "rowmm"
        for dt in (torch.float32, torch.bfloat16):
            es = 2 if dt == torch.bfloat16 else 4
            x = rnd(BATCH, L, D).to(dt)
            w, b = rnd(D, cout, std=D ** -.5).to(dt), rnd(cout, std=.1).to(dt)
            cot = rnd(BATCH, L, cout).to(dt) * live[:, :, None]
            if ln:
                inputs = (x, rnd(D, std=.1, mean=1.), rnd(D, std=.1), w, b)
                fwd = lambda *a: torch.cat(ops.rowskip_ln_affine(*a, flags),
                                           -1)
            else:
                inputs = (x, w, b)
                fwd = lambda *a: ops.rowskip_affine(*a, flags)
            # x read on the live rows, every output row written once (dead
            # blocks as zeros); backward: x and dy read on the live rows, dx
            # written on every row, dW and db (and dgamma, dbeta) in fp32;
            # the products over the live rows (dx and dW backward)
            wbytes = (D * cout + cout) * es + (8 * D if ln else 0)
            work_f = ((n_live * D + R * cout) * es + wbytes,
                      2.0 * n_live * D * cout)
            work_b = ((n_live * (D + cout) + R * D) * es + wbytes
                      + (D * cout + cout + (2 * D if ln else 0)) * 4,
                      4.0 * n_live * D * cout)
            library = None
            if not ln:
                xl, wl, bl = (t.detach().clone().requires_grad_()
                              for t in (x.reshape(R, D), w, b))
                out_t = torch.addmm(bl, xl, wl)
                cot_t = cot.reshape(R, cout)
                library = (lambda: torch.addmm(b, x.reshape(R, D), w),
                           lambda: torch.autograd.grad(
                               out_t, (xl, wl, bl), cot_t, retain_graph=True))
            tag = f"{name}[{R},{D}]x[{D},{cout}]"
            fr, br = _compare_train(tag, dt, fwd, inputs, cot, live, work_f,
                                    work_b, library)
            del library
            if dt == torch.bfloat16:
                shape = f"[{R},{D}]x[{D},{cout}]"
                results[key] = dict(fr, shape=shape)
                results[key.replace(name, f"{name}_bwd")] = dict(br,
                                                                 shape=shape)
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


def _profile_step(name, trainer, batch, power: str,
                  train: bool = False) -> None:
    """torch.profiler over one step (after warm-up): device time by kernel,
    the step's device total against its host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = trainer.train_step if train else trainer.eval_step
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch)
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
    kind = "train" if train else "eval"
    print(f"profile {name} bf16 {kind} step ({power}): device busy "
          f"{total:.2f} ms of {wall:.2f} ms host wall, device idle share "
          f"{max(0.0, 1 - total / wall):.3f}")
    for t, count, key in items[:24 if train else 16]:
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
            _profile_step(name, trainer, batches[0], power)

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


def _train_run(cfg, state, batch, plain: bool):
    """One train step from ``state`` on one path: (loss, gradients and
    updated values of the trainable parameters, the step's learning
    rate)."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    model = get_model(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    tr = Trainer(cfg, model, torch.device("cuda"), eval_only=False, seed=0)
    lr = tr.current_lr()
    with ops.reference_path() if plain else contextlib.nullcontext():
        loss = tr.train_step(batch)
    torch.cuda.synchronize()
    params = tr.optimizer.params
    names = {id(p): n for n, p in model.named_parameters()}
    out = {names[id(p)]: (p.grad.float().clone(), p.detach().float().clone())
           for p in params}
    del tr, model
    torch.cuda.empty_cache()
    return loss, out, lr


# tensors whose true gradient is 0, so that both paths hold rounding noise
# there: a key-projection bias (softmax is shift invariant per query), and
# the biases the head's BatchNorm cancels (fc_list.0 and the LayerNorm
# before it add the same vector to every sample: layer_norms_after_concat
# in tri_mbt_vsltcls, final_ln in the cross transformer)
ZERO_GRAD = ("key_proj.linear.bias", "fc_list.0.bias",
             "layer_norms_after_concat.bias", "final_ln.bias")


def _step_errors(a, b):
    """|a - b|_F / |b|_F per trainable tensor with a nonzero true
    gradient."""
    return {n: _grad_errors([a[n][0]], [b[n][0]])[0] for n in b
            if not n.endswith(ZERO_GRAD)}


def _summary(errs) -> str:
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:2]
    return (f"median {statistics.median(errs.values()):.3e}, max "
            f"{max(errs.values()):.3e} {[(n, round(e, 4)) for n, e in worst]}")


def _check_step_parity(name, cfg, state, batch, precs) -> None:
    """One step from the same weights on the kernel and the plain path,
    for each (precision, dropout) in ``precs``; every bf16 entry needs an
    fp32 one at its dropout, the step its gradients are held against."""
    runs, failures = {}, []
    for prec, p in precs:
        c = cfg.replace(precision=prec, dropout=p)
        for plain in (False, True):
            runs[prec, p, plain] = _train_run(c, state, batch, plain)
    for (prec, p, plain), (loss, got, lr) in runs.items():
        if plain:
            continue
        ref_loss, want, _ = runs[prec, p, True]
        errs = _step_errors(got, want)
        # each side's Adam step is at most lr per element, plus the
        # parameter's fp32 rounding
        p_err = max(float((got[n][1] - want[n][1]).abs().max())
                    for n in want)
        moved = max(float((got[n][1] - state[n].float().cuda()).abs().max())
                    for n in want)
        print(f"{name} train step {prec} dropout {p}: loss {loss:.6f} vs "
              f"plain {ref_loss:.6f}; grads |kernel - plain|_F/|plain|_F "
              f"over {len(errs)} tensors: {_summary(errs)}; updated params "
              f"max |diff| {p_err:.3e} (bound {2.01 * lr:.3e} = 2.01 lr; "
              f"moved up to {moved:.3e})")
        if not np.isfinite(loss) or abs(loss - ref_loss) > STEP_LOSS_TOL[prec]:
            failures.append(f"{prec} {p}: loss")
        if p_err > 2.01 * lr + 1e-7 or moved == 0.0:
            failures.append(f"{prec} {p}: updated parameters")
        if prec == "fp32":
            if max(errs.values()) > STEP_FP32_TOL:
                failures.append(f"fp32 {p}: gradients")
            continue
        fp32 = runs["fp32", p, True][1]
        k_err, p_err32 = _step_errors(got, fp32), _step_errors(want, fp32)
        print(f"{name} train step dropout {p}, bf16 against the fp32 plain "
              f"step: kernel path {_summary(k_err)}; plain path "
              f"{_summary(p_err32)}")
        for stat in (statistics.median, max):
            if stat(k_err.values()) > STEP_BF16_RATIO * stat(
                    p_err32.values()) + 1e-2:
                failures.append(f"bf16 {p}: {stat.__name__} against fp32")
    if failures:
        raise AssertionError(f"{name} train step parity: {failures}")


def _timed_train_ms(trainer, batches, reference: bool) -> float:
    from medical_tri_modal_pilot_tpu_torch import ops
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.reference_path() if reference else contextlib.nullcontext():
        for batch in batches:
            trainer.train_step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(batches)


def run_train(name: str, argv, power: str, timed: bool) -> dict:
    """Drive one BASELINE configuration's train step at full width: the
    launch counts of its run (reset just before, read just after), peak
    memory, kernel vs plain path on one step, and (``timed``) 20 steps on
    one batch, ms/step on both paths in turns and a profiler split."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.models.models import pack_capacity
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    cfg = parse_config(argv)
    widths = (cfg.transformer_dim, cfg.transformer_num_layers,
              cfg.transformer_num_head, cfg.tie_len, cfg.precision,
              cfg.dropout, cfg.optim)
    if widths != (256, 6, 4, TIE_LEN, "bf16", 0.1, "adamw"):
        raise AssertionError(f"{name} defaults changed: {widths}")
    batches = [synthetic_batch(cfg, BATCH, seed=10 + s, present_frac=f)
               for s, f in enumerate(TRAIN_BATCHES[name])]
    model = get_model(cfg, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(cfg, model, dev, eval_only=False, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    # the main path: every kernel launch of these steps is counted
    ops.reset_launches()
    losses, rows = [], []
    for batch in batches:
        losses.append(trainer.train_step(batch))
        rows.append(getattr(model, "trunk_rows", 0))
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    n = len(batches)
    print(f"{name}: launches over {n} train steps: {counts}; trunk rows per "
          f"step {rows}; losses {losses}")
    print(f"{name} train peak device memory: {peak / 2 ** 30:.3f} GiB "
          f"(parameters, optimizer state and batch before the steps "
          f"{base / 2 ** 30:.3f} GiB)")
    for kernel in ops.KERNELS:
        want = TRAIN_LAUNCHES_PER_STEP[name].get(kernel, 0) * n
        if counts[kernel] != want:
            raise AssertionError(f"{name} train {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite train loss {losses}")
    if name == "config4":
        cap = pack_capacity(cfg, BATCH)
        if cap + 1 not in rows or BATCH not in rows:
            raise AssertionError(f"{name}: trunk rows {rows} miss the packed "
                                 f"({cap + 1}) or the overflow ({BATCH}) "
                                 "branch")

    if timed:
        # in turns: plain, kernel, kernel, plain
        ms = {True: [], False: []}
        for reference in (True, False, False, True):
            ms[reference].append(_timed_train_ms(trainer, batches,
                                                 reference))
        kernel_ms, plain_ms = np.mean(ms[False]), np.mean(ms[True])
        print(f"{name} train step ({power}): kernels {kernel_ms:.2f} ms/step "
              f"({BATCH * 1e3 / kernel_ms:.1f} samples/s), plain "
              f"{plain_ms:.2f} ms/step ({BATCH * 1e3 / plain_ms:.1f} "
              f"samples/s); rounds {ms[False]} / {ms[True]}")
        _profile_step(name, trainer, batches[0], power, train=True)

        # 20 steps on one batch from the starting weights: the loss falls
        model.load_state_dict(state)
        fit = Trainer(cfg, model, dev, eval_only=False, seed=0)
        curve = [fit.train_step(batches[0]) for _ in range(20)]
        print(f"{name} 20 steps on one batch: losses "
              f"{[round(x, 5) for x in curve]}")
        if not all(np.isfinite(curve)) or not (
                np.mean(curve[-5:]) < np.mean(curve[:5])):
            raise AssertionError(f"{name}: the loss does not fall on one "
                                 f"batch: {curve}")
        del fit
    del trainer, model
    torch.cuda.empty_cache()

    # one step from the same weights on both paths; the plain path draws
    # the same Philox masks
    parity = ([("fp32", 0.0), ("bf16", 0.0), ("fp32", 0.1), ("bf16", 0.1)]
              if timed else [("fp32", 0.1), ("bf16", 0.1)])
    _check_step_parity(name, cfg, state, batches[0], parity)
    return counts


# tensor parallelism: config 4 under --mp-size 2 in two ranks on the one
# card; the batches (images for 32, 16 and 48 of 64 samples: the packed
# trunk and its overflow) and, per step and rank, the launches: the
# forward's as config 4's with attn_block and ffn off, the vslt stream's
# attention through rowmm_ln (6 layers), every stream's through attention
# (18); the backward as config 4's (the last layer's img and txt streams
# get none); one dropout_masks per FFN (18) and per stream's input
# dropout (3)
TP_ARGV = CONFIG4 + ["--mp-size", "2", "--dp-size", "1"]
TP_BATCHES = [0.5, 0.25, 0.75]
TP_EVAL_LAUNCHES = {"umse": 1, "attention": 18, "rowmm_ln": 6,
                    "swin_attention": 12, "swin_mlp": 12}
TP_TRAIN_LAUNCHES = dict(TP_EVAL_LAUNCHES, attention_bwd=16, rowmm_ln_bwd=6,
                         dropout_masks=21)
TP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "tp_smoke")
TP_LABEL = "2 ranks share one H100 over gloo: not a TP speed figure"


def _tp_batches(cfg):
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    return [synthetic_batch(cfg, BATCH, seed=30 + s, present_frac=f)
            for s, f in enumerate(TP_BATCHES)]


def _check_counts(what, counts, per_step, steps):
    from medical_tri_modal_pilot_tpu_torch import ops
    for kernel in ops.KERNELS:
        want = per_step.get(kernel, 0) * steps
        if counts[kernel] != want:
            raise AssertionError(f"{what} {kernel}: {counts[kernel]} "
                                 f"launches, expected {want}")


def tp_rank(out_dir: str) -> None:
    """One rank of the tensor-parallel phase (started by parallel.launch):
    the same steps on every rank, rank 0 prints; each rank writes its
    numbers to ``out_dir``/rank{r}.pt, rank 0 also the probabilities and
    the gathered fp32 gradients."""
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.models.modules import DropoutSeeds
    from medical_tri_modal_pilot_tpu_torch.parallel.distributed import \
        maybe_init_distributed
    from medical_tri_modal_pilot_tpu_torch.parallel.mesh import (
        gather_state_dict, make_mesh)
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    rank, world = maybe_init_distributed(None, "gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else \
        (lambda *a: None)
    dev = torch.device("cuda")
    cfg = parse_config(TP_ARGV)
    mesh = make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)
    batches = _tp_batches(cfg)
    n = len(batches)
    res = {}

    def trainer(c, eval_only=True):
        model = get_model(c, torch.Generator().manual_seed(0))
        return Trainer(c, model, dev, eval_only=eval_only, seed=0, mesh=mesh)

    # eval, bf16: the main path's launches, then ms/step
    tr = trainer(cfg)
    ops.reset_launches()
    probs, _, _ = _eval_steps(tr, batches)
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    say(f"tp rank {rank}/{world}: launches over {n} eval steps: {counts}")
    _check_counts(f"tp rank {rank} eval", counts, TP_EVAL_LAUNCHES, n)
    res["eval_ms"] = _timed_ms(tr, batches, reference=False)
    res["probs"] = probs
    del tr
    tr32 = trainer(cfg.replace(precision="fp32"))
    res["probs32"], _, _ = _eval_steps(tr32, batches[:1])
    del tr32

    # one fp32 train step at dropout 0.1 from the seeded weights: the
    # gradients, gathered into whole tensors
    c32 = cfg.replace(precision="fp32", dropout=0.1)
    tr32 = trainer(c32, eval_only=False)
    res["loss32"] = tr32.train_step(batches[0])
    names = {id(p): nm for nm, p in tr32.model.named_parameters()}
    grads = {names[id(p)]: p.grad.detach().float()
             for p in tr32.optimizer.params}
    grads = gather_state_dict(grads, tr32.split, mesh)
    res["grads"] = {k: v.cpu() for k, v in grads.items()} if rank == 0 \
        else None
    res["replicated_grads"] = {k: v.cpu() for k, v in grads.items()
                               if k not in tr32.split}
    del tr32, grads
    torch.cuda.empty_cache()

    # train, bf16: launches, peak memory, ms/step, a profiler split, the
    # loss over steps on one batch
    tr = trainer(cfg, eval_only=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses = [tr.train_step(b) for b in batches]
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    res["peak"], res["base"] = torch.cuda.max_memory_allocated(), base
    res["train_counts"] = counts
    say(f"tp rank {rank}: launches over {n} train steps: {counts}; losses "
        f"{losses}")
    _check_counts(f"tp rank {rank} train", counts, TP_TRAIN_LAUNCHES, n)
    res["train_ms"] = _timed_train_ms(tr, batches, reference=False)
    res["profile"] = _profile_tp_step(tr, batches[0], rank)
    curve = [tr.train_step(batches[0]) for _ in range(8)]
    res["curve"] = curve
    say(f"tp 8 steps on one batch (after {2 * n + 2} others): losses "
        f"{[round(x, 5) for x in curve]}")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def _profile_tp_step(trainer, batch, rank: int) -> dict:
    """torch.profiler over one train step: the device's busy time and the
    host wall; and the host's time blocked in the collective calls (a
    clock around each all_reduce and all_gather, which return once gloo
    has staged the tensor through the host, exchanged it and copied it
    back, so the time includes the device work queued before it)."""
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    trainer.train_step(batch)
    torch.cuda.synchronize()
    blocked = {"s": 0.0, "calls": 0}

    def timed(fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                blocked["s"] += time.perf_counter() - t
                blocked["calls"] += 1
        return call
    plain = dist.all_reduce, dist.all_gather
    dist.all_reduce, dist.all_gather = map(timed, plain)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        dist.all_reduce, dist.all_gather = plain
    events = prof.key_averages()

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    busy = sum(dev_us(e) for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    copies = sum(dev_us(e) for e in events if e.device_type ==
                 DeviceType.CUDA and "Memcpy" in e.key) / 1e3
    return {"wall_ms": wall, "busy_ms": busy,
            "blocked_ms": blocked["s"] * 1e3, "blocked_calls":
            blocked["calls"], "copy_ms": copies,
            "top": sorted(((dev_us(e) / 1e3, e.count, e.key) for e in events
                           if e.device_type == DeviceType.CUDA
                           and dev_us(e) > 0), reverse=True)[:12]}


def run_tp(power: str) -> dict:
    """The tensor-parallel phase: single-process references on the card,
    then two ranks of tp_rank, then the comparisons. Returns rank 0's train
    launch counts."""
    from medical_tri_modal_pilot_tpu_torch.config import parse_config
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.parallel.launch import launch
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda")
    single = parse_config(TP_ARGV).replace(mp_size=0, dp_size=0)
    batches = _tp_batches(single)

    def trainer(c):
        return Trainer(c, get_model(c, torch.Generator().manual_seed(0)),
                       dev, eval_only=True)

    probs, _, _ = _eval_steps(trainer(single), batches)
    c32 = single.replace(precision="fp32")
    probs32, _, _ = _eval_steps(trainer(c32), batches[:1])
    state = get_model(c32, torch.Generator().manual_seed(0)).state_dict()
    loss32, ref, _ = _train_run(c32.replace(dropout=0.1), state, batches[0],
                                plain=False)
    torch.cuda.empty_cache()

    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    t0 = time.perf_counter()
    launch("chip_smoke:tp_rank", 2, f"file://{TP_DIR}/rendezvous", [TP_DIR],
           timeout=900)
    print(f"tp: two ranks done in {time.perf_counter() - t0:.1f} s")
    ranks = [torch.load(os.path.join(TP_DIR, f"rank{r}.pt"),
                        weights_only=False) for r in (0, 1)]
    r0 = ranks[0]
    d_bf16 = float(np.max(np.abs(r0["probs"] - probs)))
    d32 = float(np.max(np.abs(r0["probs32"] - probs32)))
    same = float(np.max(np.abs(r0["probs"] - ranks[1]["probs"])))
    print(f"tp config 4 eval, against the single-process kernel path: max "
          f"|prob diff| bf16 {d_bf16:.3e} (tol {PROB_TOL['bf16']}), fp32 "
          f"{d32:.3e} (tol {PROB_TOL['fp32']}); the two ranks' "
          f"probabilities differ by {same:.3e}")
    errs = _step_errors({k: (v.to(dev), None) for k, v in r0["grads"].items()},
                        ref)
    print(f"tp fp32 train step dropout 0.1: loss {r0['loss32']:.6f} vs single "
          f"{loss32:.6f}; grads |tp - single|_F/|single|_F over {len(errs)} "
          f"tensors: {_summary(errs)} (tol {STEP_FP32_TOL})")
    rep = [k for k in ranks[0]["replicated_grads"]
           if not torch.equal(ranks[0]["replicated_grads"][k],
                              ranks[1]["replicated_grads"][k])]
    print(f"tp: replicated gradients equal on both ranks: {not rep} "
          f"({len(ranks[0]['replicated_grads'])} tensors)")
    for r, res in enumerate(ranks):
        prof = res["profile"]
        print(f"tp rank {r} ({power}; {TP_LABEL}): eval {res['eval_ms']:.1f} "
              f"ms/step, train {res['train_ms']:.1f} ms/step, peak device "
              f"memory {res['peak'] / 2 ** 30:.3f} GiB (before the steps "
              f"{res['base'] / 2 ** 30:.3f} GiB); profiled train step: wall "
              f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} "
              f"ms (idle share {1 - prof['busy_ms'] / prof['wall_ms']:.3f}),"
              f" host blocked in {prof['blocked_calls']} collective calls "
              f"{prof['blocked_ms']:.1f} ms "
              f"({prof['blocked_ms'] / prof['wall_ms']:.3f} of the wall), "
              f"device copies {prof['copy_ms']:.1f} ms")
    for t, count, key in r0["profile"]["top"]:
        print(f"  device {t:8.3f} ms x{count:<4d} {key[:90]}")
    curve = r0["curve"]
    failures = []
    if d_bf16 > PROB_TOL["bf16"] or d32 > PROB_TOL["fp32"] or same != 0.0:
        failures.append("eval probabilities")
    if abs(r0["loss32"] - loss32) > STEP_LOSS_TOL["fp32"] or \
            max(errs.values()) > STEP_FP32_TOL:
        failures.append("fp32 train step")
    if rep:
        failures.append(f"replicated gradients differ: {rep[:3]}")
    if not all(np.isfinite(curve)) or not np.mean(curve[-3:]) < np.mean(
            curve[:3]):
        failures.append(f"the loss does not fall: {curve}")
    if failures:
        raise AssertionError(f"tensor parallelism: {failures}")
    return r0["train_counts"]


PATH_NAMES = {"config4": "tri_mbt_vsltcls config 4 train",
              "cross": "cross_transformer_txt_vslt train",
              "tp": "tri_mbt_vsltcls config 4 train, --mp-size 2 (rank 0)",
              None: "none: no path of the JAX package dispatches it"}
PATH_STEPS = dict({k: len(v) for k, v in TRAIN_BATCHES.items()},
                  tp=len(TP_BATCHES))


def main() -> None:
    power = check_device()
    build_kernels()
    results = compare_kernels()
    results.update(compare_training_kernels())
    results.update(compare_attention_kernels())
    results.update(compare_rowmm_kernels())
    run_config("config2", CONFIG2, power, timed=True)
    run_config("config4", CONFIG4, power, timed=True)
    run_config("config5", CONFIG5, power, timed=False)
    counts = {"config4": run_train("config4", CONFIG4, power, timed=True)}
    run_train("config2", CONFIG2, power, timed=False)
    run_config("cross", CROSS, power, timed=True)
    counts["cross"] = run_train("cross", CROSS, power, timed=True)
    counts["tp"] = run_tp(power)
    kernels = []
    for name, (route, source, replaces) in KERNEL_SOURCES.items():
        path = KERNEL_PATHS[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "path": PATH_NAMES[path],
                        "launches": counts[path][name] if path else 0,
                        "steps": PATH_STEPS[path] if path else 0,
                        **results[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
