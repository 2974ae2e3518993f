"""Seeded synthetic batches in the batch contract
(medical_tri_modal_pilot_tpu/data/dataset.py:354-370), restricted to the
keys the train and eval steps read. Counterpart of
``__graft_entry__._synthetic_batch``.

The real loader cannot run where the port runs yet: ``data/dataset.py``
imports ``data/images.py``, which imports PIL at module level.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import Config
from ..constants import N_FEATURES


def _images(cfg: Config, rng, present: np.ndarray):
    """CXRs as the loader emits them: fp32 [B, 1, S, S] with values k/255,
    a missing image as zeros with time -1 (data/dataset.py:148-153). With
    ``--multiimages 1``: [B, 3, 1, S, S] holding 1-3 images of a present
    sample, absent slots zeros with time 10."""
    B, S = len(present), cfg.image_size
    slots = 3 if cfg.multiimages == 1 else 1
    img = np.zeros((B, slots, 1, S, S), np.float32)
    times = np.full((B, slots), 10.0 if slots == 3 else -1.0, np.float32)
    for i in np.flatnonzero(present):
        n = rng.integers(1, 4) if slots == 3 else 1
        img[i, :n] = rng.integers(0, 256, (n, 1, S, S)) / np.float32(255)
        times[i, :n] = rng.uniform(-24, 0, n)
    if slots == 1:
        return img[:, 0], times[:, 0]
    return img, times


def _tie(cfg: Config, rng, B: int):
    """TIE streams [B, TIE-len, 3] (time, value, feature id) of random
    valid lengths in [5, TIE-len], time-sorted, padding at the end."""
    L = cfg.tie_len
    tie = np.zeros((B, L, 3), np.float32)
    lengths = rng.integers(5, L + 1, B).astype(np.int32)
    for i, n in enumerate(lengths):
        tie[i, :n, 0] = np.sort(rng.uniform(-24, 0, n))
        tie[i, :n, 1] = rng.uniform(0, 1, n)
        tie[i, :n, 2] = rng.integers(0, N_FEATURES, n)
    return tie, lengths


def _carryforward(cfg: Config, rng, B: int):
    """Carryforward grids [B, 3, window, vslt_len] as data/dataset.py:264-270
    builds them: normalised values, observation mask and hours since the
    last observation over the first input_length steps (input_length in
    [1, window]), zeros past them."""
    T, F = cfg.window_size, cfg.vslt_len
    vslt = np.zeros((B, 3, T, F), np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    for i, n in enumerate(lengths):
        vslt[i, 0, :n] = rng.normal(0, 1, (n, F))
        vslt[i, 1, :n] = rng.integers(0, 2, (n, F))
        vslt[i, 2, :n] = rng.uniform(0, 24, (n, F))
    return vslt, lengths


def synthetic_batch(cfg: Config, batch_size: int, seed: int = 0,
                    present_frac: float = 0.5) -> Dict[str, np.ndarray]:
    """Vital signs as TIE streams (``--vslt-type TIE``) or carryforward
    grids (``carryforward``), BioBERT note embeddings [txt_token_size, 768]
    with a missing note as zeros of length 0, random targets and, when
    ``--input-types`` has img, images for round(present_frac * batch_size)
    samples at random positions (so a caller can force the packed trunk or
    its overflow)."""
    rng = np.random.default_rng(seed)
    B = batch_size
    if cfg.vslt_type == "carryforward":
        vslt, lengths = _carryforward(cfg, rng, B)
    else:
        vslt, lengths = _tie(cfg, rng, B)
    missing = np.zeros((B, 3), np.float32)
    missing[:, 2] = rng.integers(0, 2, B)
    T, E = cfg.txt_token_size, cfg.token_max_length
    txt = rng.normal(0, 1, (B, T, E)).astype(np.float32)
    txt_length = rng.integers(1, T + 1, B).astype(np.int32)
    for i in range(B):
        if missing[i, 2]:
            txt[i] = 0.0
            txt_length[i] = 0
        else:
            txt[i, txt_length[i]:] = 0.0
    batch = {
        "vslt": vslt,
        "static": rng.uniform(0, 1, (B, 2)).astype(np.float32),
        "input_length": lengths,
        "txt": txt,
        "txt_length": txt_length,
        "txt_time": rng.uniform(-24, 0, B).astype(np.float32),
        "missing": missing,
        "target": rng.integers(0, 2, B).astype(np.float32),
        "target_aux": rng.uniform(0, 12, B).astype(np.float32),
    }
    if "img" in cfg.input_types.split("_"):
        present = np.zeros(B, bool)
        present[rng.permutation(B)[:int(round(present_frac * B))]] = True
        missing[:, 1] = ~present
        batch["img"], batch["img_time"] = _images(cfg, rng, present)
    return batch
