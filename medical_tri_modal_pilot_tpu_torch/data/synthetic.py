"""Seeded synthetic batches in the batch contract
(medical_tri_modal_pilot_tpu/data/dataset.py:354-370), restricted to the
keys the train and eval steps read. Counterpart of
``__graft_entry__._synthetic_batch``. ``to_wire`` gives such batches in the
real loader's H2D wire format, and ``BatchList`` serves them where the
drivers take a loader (``drivers.train.run_fold``): the real loader
(``data/pipeline.py``) needs the data files, and PIL for images.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..config import Config
from ..constants import N_FEATURES
from .txt_table import TxtTable


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


def _token_ids(cfg: Config, rng, missing: np.ndarray):
    """Notes as ``--berttype bert`` token ids [B, token_max_length] (fp32,
    as the loader ships them, data/text.py:129-139): BOS (2), then
    txt_length ids in [4, 30000), zeros past them; a missing note is zeros
    of length 0."""
    B, E = len(missing), cfg.token_max_length
    txt = np.zeros((B, E), np.float32)
    txt_length = rng.integers(1, E, B).astype(np.int32)
    for i in range(B):
        if missing[i]:
            txt_length[i] = 0
            continue
        txt[i, 0] = 2
        txt[i, 1:txt_length[i] + 1] = rng.integers(4, 30000, txt_length[i])
    return txt, txt_length


def synthetic_batch(cfg: Config, batch_size: int, seed: int = 0,
                    present_frac: float = 0.5) -> Dict[str, np.ndarray]:
    """Vital signs as TIE streams (``--vslt-type TIE`` or QIE) or
    carryforward grids (``carryforward``), BioBERT note embeddings
    [txt_token_size, 768] (or ``--berttype bert`` token ids) with a
    missing note as zeros of length 0, random targets and, when
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
    if cfg.berttype == "bert":
        txt, txt_length = _token_ids(cfg, rng, missing[:, 2])
    else:
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


def to_wire(batches: Sequence[Dict[str, np.ndarray]]
            ) -> Tuple[List[dict], List[dict], TxtTable]:
    """Synthetic batches as the real loader sends them with its defaults
    (--img-wire-u8 1 and a device note table): CXR pixels as uint8 (the
    k/255 values back to k), notes as ``txt_id`` rows into a ``TxtTable``
    of the batches' present notes (row 0 zeros, as data/txt_table.py
    builds it). Returns (wire batches, their dense form, the table): the
    dense form is what the wire resolves to, pixels k / 255 in fp32 as the
    loader's to_tensor computes them and notes the table's rows."""
    rows, lengths = [None], [0]
    wire, dense = [], []
    for b in batches:
        w = {k: v for k, v in b.items() if k != "txt"}
        ids = np.zeros(len(b["missing"]), np.int32)
        for i in np.flatnonzero(b["missing"][:, 2] == 0):
            ids[i] = len(rows)
            rows.append(b["txt"][i])
            lengths.append(int(b["txt_length"][i]))
        w["txt_id"] = ids
        if "img" in b:
            w["img"] = np.rint(b["img"] * 255.0).astype(np.uint8)
        wire.append(w)
    rows[0] = np.zeros_like(batches[0]["txt"][0])
    table = TxtTable(rows=np.stack(rows),
                     lengths=np.asarray(lengths, np.int32))
    u8 = np.arange(256, dtype=np.float32) / 255.0
    for w in wire:
        d = {k: v for k, v in w.items() if k != "txt_id"}
        d["txt"] = table.rows[w["txt_id"]]
        if "img" in w:
            d["img"] = u8[w["img"]]
        dense.append(d)
    return wire, dense, table


class BatchList:
    """A loader over fixed batches: ``len`` and iteration, as the drivers
    read a loader."""

    def __init__(self, batches: Sequence[Dict[str, np.ndarray]]):
        self.batches = list(batches)

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)
