"""Shared zero-array singletons for missing-modality sample fields.

In missing-modality regimes most rows carry a zero image (only remapped
type codes 0/5 load pixels, dataset.py:_fetch_image) and many carry zero
text. The reference allocates a fresh zero tensor per sample and the
batch collate copies it (dataset_new.py:677-738); here missing rows
share one immutable zero array per (shape, dtype) and the batch stacker
(pipeline._stack) skips copying rows it recognizes as shared zeros —
np.zeros batch buffers are calloc'd, so untouched rows are already zero.

Identity is established by `is` against the live canonical array (never
by id(): a raced-and-dropped duplicate's id can be recycled by a later
unrelated ndarray, which would then silently skip its batch copy). The
creation path is locked so exactly one canonical array exists per key.

The port's own copy of ``medical_tri_modal_pilot_tpu/data/zeros.py``.
"""
from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np

_ZEROS: Dict[Tuple[tuple, str], np.ndarray] = {}
_LOCK = threading.Lock()


def zero_array(shape, dtype=np.float32) -> np.ndarray:
    """Shared immutable zero array of the given shape/dtype."""
    key = (tuple(shape), np.dtype(dtype).str)
    a = _ZEROS.get(key)
    if a is None:
        with _LOCK:
            a = _ZEROS.get(key)
            if a is None:
                a = np.zeros(shape, dtype)
                a.setflags(write=False)
                _ZEROS[key] = a
    return a


def is_shared_zero(a) -> bool:
    if not isinstance(a, np.ndarray):
        return False
    z = _ZEROS.get((a.shape, a.dtype.str))
    return z is a
