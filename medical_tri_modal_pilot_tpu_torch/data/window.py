"""Window slicing + TIE/QIE triplet-stream assembly (pure numpy, host-side).

Reimplements sequenceGenerator (reference builder/data/data_utils.py:28-43),
the pretrain variant (:45-85), and the TIE assembly of Dataset.__getitem__
(dataset_new.py:611-663). All outputs are statically shaped so the device
sees fixed-size arrays.

The port's own copy of ``medical_tri_modal_pilot_tpu/data/window.py``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

N_RAW_FEATURES = 18


def sequence_generator(data: np.ndarray, mask: np.ndarray, delta: np.ndarray,
                       key: int, length: int, window_size: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Slice a window ending at hour-index ``key`` of size ``length``,
    zero-padded at the back to ``window_size`` rows."""
    if key >= length - 1:
        pad = np.zeros((window_size - length, N_RAW_FEATURES))
        d = np.append(data[key - length + 1:key + 1], pad, axis=0)
        m = np.append(mask[key - length + 1:key + 1], pad, axis=0)
        dl = np.append(delta[key - length + 1:key + 1], pad, axis=0)
        input_length = length
    else:
        pad = np.zeros((window_size - 1 - key, N_RAW_FEATURES))
        d = np.append(data[:key + 1], pad, axis=0)
        m = np.append(mask[:key + 1], pad, axis=0)
        dl = np.append(delta[:key + 1], pad, axis=0)
        input_length = key + 1
    return d, m, dl, input_length


def sequence_generator_pretrain(data, mask, delta, key, length, window_size):
    """+12-future-hour variant for the aux pretraining input
    (data_utils.py:45-85); emits 36-row sequences and feasibility indices."""
    d, m, dl, input_length = sequence_generator(data, mask, delta, key, length, window_size)
    d = np.append(d, data[key + 1:key + 13], axis=0)
    m = np.append(m, mask[key + 1:key + 13], axis=0)
    dl = np.append(dl, delta[key + 1:key + 13], axis=0)
    f_indices = np.append((np.sum(m, 1) > 4), np.zeros(36 - m.shape[0]), axis=0)
    n = d.shape[0]
    if n < 36:
        pad = np.zeros((36 - n, N_RAW_FEATURES))
        d = np.append(d, pad, axis=0)
        m = np.append(m, pad, axis=0)
        dl = np.append(dl, pad, axis=0)
    return d, m, dl, input_length, f_indices


def trim_nones(time_data_list: List[Optional[np.ndarray]], length: int,
               adjust_key: bool) -> Tuple[List[np.ndarray], int, int, int]:
    """Strip leading/trailing all-None hours of the in-window TIE stream
    (dataset_new.py:620-637). Returns (trimmed list, new length,
    key delta, late_nones)."""
    early_nones = 0
    late_nones = 0
    if time_data_list and (time_data_list[0] is None or time_data_list[-1] is None):
        non_none = [i for i, x in enumerate(time_data_list) if x is not None]
        if time_data_list[0] is None and time_data_list[-1] is not None:
            early_nones = non_none[0]
        elif time_data_list[-1] is None and time_data_list[0] is not None:
            late_nones = length - non_none[-1] - 1
        else:
            early_nones = non_none[0]
            late_nones = length - non_none[-1] - 1
        length -= early_nones
        if late_nones == 0:
            time_data_list = list(time_data_list[early_nones:])
        else:
            time_data_list = list(time_data_list[early_nones:-late_nones])
    key_delta = -late_nones if adjust_key else 0
    return time_data_list, length, key_delta, late_nones


def assemble_tie(data_seq: np.ndarray, delta_seq: np.ndarray,
                 time_data_list: List[Optional[np.ndarray]],
                 key: int, length: int, tie_len: int, realtime: bool
                 ) -> Tuple[np.ndarray, int, float]:
    """Build the [tie_len, 3] triplet stream (time, value, feature-id).

    Mirrors dataset_new.py:645-663: a carried-forward initial-state row per
    feature (timestamped by last observation before the window, rows at the
    window start hour dropped) is prepended to the concatenated per-hour
    event arrays; times are anchored at the window end (realtime) or the
    stream minimum. Truncated/padded to ``tie_len``.
    Returns (stream [tie_len,3] float32, input_length, min_time anchor).
    """
    feature_init = data_seq[0, :][:, None]
    delta_init = (delta_seq[0, :][:, None] * -1) + key - length + 2
    idx_init = np.arange(N_RAW_FEATURES, dtype=np.float64)[:, None]
    init_tie = np.concatenate([delta_init, feature_init, idx_init], axis=1)
    init_tie = np.delete(init_tie, init_tie[:, 0] == (key - length + 1), axis=0)
    events = [x for x in time_data_list if x is not None]
    if events:
        stream = np.concatenate([init_tie] + events, axis=0)
    else:
        stream = init_tie
    min_time = 0.0
    if realtime:
        stream = stream.copy()
        stream[:, 0] -= key
    else:
        min_time = float(stream[:, 0].min()) if stream.shape[0] else 0.0
        stream = stream.copy()
        stream[:, 0] -= min_time
    if stream.shape[0] > tie_len:
        stream = stream[:tie_len, :]
    out = np.zeros((tie_len, 3), dtype=np.float32)
    out[:stream.shape[0]] = stream.astype(np.float32)
    return out, int(stream.shape[0]), min_time
