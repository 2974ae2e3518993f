"""Native host-pipeline bindings: flat record cache + C++ TIE batch
assembler (native/tie_assembler.cpp).

The reference re-unpickles the entire stay and rebuilds the TIE stream in
Python per __getitem__ (dataset_new.py:591-663). Here stays are converted
once into flat float32 arrays (normalized grid, delta grid, concatenated
per-hour event stream with offsets) and whole batches are assembled by C++
threads without the GIL. Falls back to the pure-numpy window.py path when
the shared library hasn't been built (native/build.sh).

The port's own copy of ``medical_tri_modal_pilot_tpu/data/native.py``.
"""
from __future__ import annotations

import ctypes
import os
import pickle
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..constants import FEATURE_MAX_MINS, FEATURE_MINS
from . import window as W

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libtie_assembler.so")


def load_library() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.assemble_tie_batch.argtypes = [
        f32p, f32p, f32p, i32p, i64p, i64p, i32p,
        i32p, i32p, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, i32p, f32p, ctypes.c_int,
    ]
    lib.assemble_tie_batch.restype = None
    return lib


@dataclass
class RecordCache:
    """Flat arrays over all stays of a split."""
    data: np.ndarray        # [sumT, 18] f32 normalized
    delta: np.ndarray       # [sumT, 18] f32
    stream: np.ndarray      # [sumN, 3] f32
    hour_off: np.ndarray    # [sumT + n_stays] i32 (per-stay [T+1] blocks)
    grid_off: np.ndarray    # [n_stays] i64 row offsets into data/delta
    hour_off_off: np.ndarray  # [n_stays] i64 offsets into hour_off
    T: np.ndarray           # [n_stays] i32
    paths: List[str]

    def stay_index(self, path: str) -> int:
        return self._path_idx[path]

    def __post_init__(self):
        self._path_idx = {p: i for i, p in enumerate(self.paths)}


def build_record_cache(pkl_paths: Sequence[str]) -> RecordCache:
    datas, deltas, streams, hour_offs = [], [], [], []
    grid_off, hour_off_off, Ts = [], [], []
    grid_pos = 0
    hour_pos = 0
    stream_pos = 0
    for p in pkl_paths:
        with open(p, "rb") as f:
            raw = pickle.load(f)
        data = ((raw["data"] - FEATURE_MINS) / FEATURE_MAX_MINS).astype(np.float32)
        delta = raw["delta"].astype(np.float32)
        T = data.shape[0]
        off = np.zeros(T + 1, np.int32)
        ev_rows = []
        for t, rows in enumerate(raw["data_in_time"]):
            n = 0 if rows is None else len(rows)
            off[t + 1] = off[t] + n
            if n:
                ev_rows.append(np.asarray(rows, np.float32))
        stream = (np.concatenate(ev_rows, 0) if ev_rows
                  else np.zeros((0, 3), np.float32))
        datas.append(data)
        deltas.append(delta)
        streams.append(stream)
        hour_offs.append(off + stream_pos)
        grid_off.append(grid_pos)
        hour_off_off.append(hour_pos)
        Ts.append(T)
        grid_pos += T
        hour_pos += T + 1
        stream_pos += stream.shape[0]
    return RecordCache(
        data=np.concatenate(datas, 0),
        delta=np.concatenate(deltas, 0),
        stream=(np.concatenate(streams, 0) if stream_pos
                else np.zeros((0, 3), np.float32)),
        hour_off=np.concatenate(hour_offs, 0).astype(np.int32),
        grid_off=np.asarray(grid_off, np.int64),
        hour_off_off=np.asarray(hour_off_off, np.int64),
        T=np.asarray(Ts, np.int32),
        paths=list(pkl_paths),
    )


class TIEBatchAssembler:
    """Batched TIE assembly over a RecordCache — C++ when built, numpy
    fallback otherwise."""

    def __init__(self, cache: RecordCache, tie_len: int, realtime: bool,
                 adjust_key: bool, n_threads: int = 0):
        self.cache = cache
        self.tie_len = tie_len
        self.realtime = realtime
        self.adjust_key = adjust_key
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self.lib = load_library()
        self._fast = None
        if self.lib is not None:
            # the cache arrays never change: resolve their pointers once and
            # call through an argtype-free handle, skipping ndpointer
            # validation on the 7 big arrays for every sample
            # (~19k from_param calls per 1000-stay epoch)
            c = self.cache
            self._cache_arrays = tuple(
                np.ascontiguousarray(a) for a in
                (c.data, c.delta, c.stream, c.hour_off, c.grid_off,
                 c.hour_off_off, c.T))
            self._cache_ptrs = tuple(a.ctypes.data_as(ctypes.c_void_p)
                                     for a in self._cache_arrays)
            self._fast = ctypes.CDLL(_LIB_PATH).assemble_tie_batch
            self._fast.restype = None

    def assemble(self, stay_idx: np.ndarray, keys: np.ndarray,
                 lengths: np.ndarray):
        """Returns (vslt [B, tie_len, 3], input_length [B],
        min_time [B] — the non-realtime anchor, 0.0 under realtime)."""
        B = len(stay_idx)
        out = np.zeros((B, self.tie_len, 3), np.float32)
        out_len = np.zeros(B, np.int32)
        out_min_time = np.zeros(B, np.float32)
        if self._fast is not None:
            sidx = np.ascontiguousarray(stay_idx.astype(np.int32))
            kk = np.ascontiguousarray(keys.astype(np.int32))
            ll = np.ascontiguousarray(lengths.astype(np.int32))
            self._fast(
                *self._cache_ptrs,
                sidx.ctypes.data_as(ctypes.c_void_p),
                kk.ctypes.data_as(ctypes.c_void_p),
                ll.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(B), ctypes.c_int(self.tie_len),
                ctypes.c_int(int(self.realtime)),
                ctypes.c_int(int(self.adjust_key)),
                out.ctypes.data_as(ctypes.c_void_p),
                out_len.ctypes.data_as(ctypes.c_void_p),
                out_min_time.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(self.n_threads))
            return out, out_len, out_min_time

        # numpy fallback — same semantics via window.py
        return self._assemble_numpy(stay_idx, keys, lengths, out, out_len,
                                    out_min_time)

    def assemble_one(self, pkl_path: str, key: int, length: int):
        """Single-sample entry for the dataset hot path (--worker-type
        native): TIE assembly without re-touching the unpickled stay. The
        ctypes call releases the GIL, so thread workers scale."""
        idx = np.array([self.cache.stay_index(pkl_path)], np.int32)
        out, n, mt = self.assemble(idx, np.array([key]), np.array([length]))
        return out[0], int(n[0]), float(mt[0])

    def _assemble_numpy(self, stay_idx, keys, lengths, out, out_len,
                        out_min_time):
        c = self.cache
        B = len(stay_idx)
        for b in range(B):
            st = int(stay_idx[b])
            g0 = c.grid_off[st]
            h0 = c.hour_off_off[st]
            T = int(c.T[st])
            data = c.data[g0:g0 + T]
            delta = c.delta[g0:g0 + T]
            off = c.hour_off[h0:h0 + T + 1]
            key, length = int(keys[b]), int(lengths[b])
            hours = []
            for t in range(key - length + 1, key + 1):
                lo, hi = off[t], off[t + 1]
                hours.append(None if hi == lo else c.stream[lo:hi].astype(np.float64))
            data_seq, _m, delta_seq, _il = W.sequence_generator(
                data.astype(np.float64), data.astype(np.float64),
                delta.astype(np.float64), key, length, max(length, 24))
            hours, length2, kdelta, _late = W.trim_nones(hours, length,
                                                         self.adjust_key)
            tie, n, mt = W.assemble_tie(data_seq, delta_seq, hours,
                                        key + kdelta, length2, self.tie_len,
                                        self.realtime)
            out[b], out_len[b], out_min_time[b] = tie, n, mt
        return out, out_len, out_min_time
