"""Clinical-note loaders: token-file dictionaries and BioBERT h5 embeddings.

Reimplements txtDictLoad (reference builder/data/data_utils.py:104-127) and
the biobert h5 / token paths of Dataset.__getitem__
(dataset_new.py:740-781).

The port's own copy of ``medical_tri_modal_pilot_tpu/data/text.py``.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import Config
from .zeros import zero_array

_TXT_DICT_CACHE: Dict[Tuple[str, str, str], dict] = {}


def txt_dataset_path(cfg: Config, flow_type: str) -> str:
    token_type = cfg.txt_tokenization
    return os.path.join(
        cfg.dir_root, "builder", "data", "text", "textDataset",
        f"mimic_icu_{flow_type}_{token_type}_textDataset.txt")


def txt_files_present(cfg: Config) -> bool:
    """True when any token file exists under cfg.dir_root. Gates the
    strict reference missing-branch semantics (a txt1 stay with no token
    entry is DROPPED, dataset_new.py:306-307): with no token files at all
    the reference cannot run (txtDictLoad raises), so the indexer falls
    back to the lenient txt1->txt0 rewrite instead of silently emptying
    the index."""
    return any(os.path.exists(txt_dataset_path(cfg, ft))
               for ft in ("train", "test"))


def load_txt_dict(cfg: Config, flow_type: str) -> Dict[Tuple[int, int], List[int]]:
    """Parse lines 'patid chid / tok tok ...' into {(pat, chid): [ids]}.
    Missing file → empty dict (sample-data runs have no token files)."""
    path = txt_dataset_path(cfg, flow_type)
    cache_key = (path, flow_type, cfg.txt_tokenization)
    if cache_key in _TXT_DICT_CACHE:
        # return a shallow copy: callers .update() into it
        return dict(_TXT_DICT_CACHE[cache_key])
    out: Dict[Tuple[int, int], List[int]] = {}
    if os.path.exists(path):
        with open(path, "r") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                fields = line.split("/")
                parts = fields[0].split()
                pat_id, chid = int(parts[0]), int(parts[1])
                out[(pat_id, chid)] = [int(x) for x in fields[1].split()]
    _TXT_DICT_CACHE[cache_key] = out
    return dict(out)


def clinical_note_transform(tokens: List[int], max_length: int) -> np.ndarray:
    """BOS/EOS + pad/truncate (dataset_new.py:162-194). ``tokens`` already
    has BOS (2) inserted by the caller; appends EOS (3) and pads with 1."""
    tokens = list(tokens)
    if len(tokens) < max_length - 1:
        tokens.append(3)
        arr = np.append(np.array(tokens, dtype=np.float32),
                        np.ones(max_length - len(tokens), dtype=np.float32))
    else:
        tokens = tokens[:max_length - 1]
        tokens.append(3)
        arr = np.array(tokens, dtype=np.float32)
    return arr


class BioBertStore:
    """Lazy h5py access to precomputed BioBERT note embeddings, keyed by the
    raw note text (dataset_new.py:746)."""

    def __init__(self, path: str):
        self.path = path
        self._h5 = None

    def _file(self):
        if self._h5 is None:
            import h5py
            self._h5 = h5py.File(self.path, "r")
        return self._h5

    def available(self) -> bool:
        return os.path.exists(self.path)

    def lookup(self, text: str) -> Optional[np.ndarray]:
        f = self._file()
        if text not in f:
            return None
        return np.asarray(f[text]["embedding"][:], dtype=np.float32)


def fetch_text(cfg: Config, data_pkl: dict, file_name: str, txt_dict: dict,
               bioemb: Optional[BioBertStore], phase_missing_key: str,
               force_missing: bool, txt_token_size: int, token_max_length: int,
               observed: bool = True) -> Tuple[np.ndarray, int, bool]:
    """Text branch of __getitem__ (dataset_new.py:740-781 / :1491-1541).

    Returns (tokens array with static shape, text length, missing flag).
    ``phase_missing_key`` is 'train-missing' or 'test-missing'.
    """
    inclusion_ok = (
        ("txt" in cfg.input_types and "txt1" in cfg.fullmodal_definition
         and phase_missing_key.replace("missing", "full") in cfg.modality_inclusion)
        or (phase_missing_key in cfg.modality_inclusion and "txt" in cfg.input_types))

    if cfg.berttype == "biobert" and cfg.txt_tokenization == "bert":
        shape = (txt_token_size, token_max_length) if txt_token_size > 1 else (token_max_length,)
        if inclusion_ok and "txt1" in file_name and not force_missing and observed:
            text_data = data_pkl["txt_input"][0].strip()
            if len(text_data) != 0 and bioemb is not None and bioemb.available():
                tokens = bioemb.lookup(text_data)
                if tokens is not None:
                    if tokens.ndim == 1:
                        return tokens, 1, False
                    text_len = tokens.shape[0]
                    # the configured shape, as the device note table's
                    # rows (the JAX package's copy writes (128, 768))
                    out = np.zeros(shape, dtype=np.float32)
                    out[:text_len] = tokens
                    return out, text_len, False
        return zero_array(shape), 0, True

    # integer-token path
    if inclusion_ok and "txt1" in file_name and observed:
        tokens = list(txt_dict.get((int(data_pkl["pat_id"]), int(data_pkl["chid"])), []))
        if len(tokens) == 0 or force_missing:
            return zero_array((token_max_length,)), 0, True
        text_len = len(tokens)
        tokens.insert(0, 2)
        arr = clinical_note_transform(tokens, token_max_length)
        arr[arr == 1] = 0
        return arr, text_len, False
    return zero_array((token_max_length,)), 0, True


def fetch_text_id(cfg: Config, data_pkl: dict, file_name: str, table,
                  phase_missing_key: str, force_missing: bool,
                  observed: bool = True) -> Tuple[int, int, bool]:
    """Device-table twin of ``fetch_text``'s biobert branch: returns
    ``(table_row_id, text_length, missing_flag)`` without reading the h5.

    Row 0 of the table is all-zero, so a missing/ineligible sample maps to
    the same zeros ``fetch_text`` would emit (``zero_array``). Every gate
    mirrors fetch_text exactly (inclusion, txt1 in file name, forced
    missing-combination, observed-prop dropout, empty note, embedding
    present in the store — table membership implies the h5 lookup
    succeeded at build time, data/txt_table.py). Only valid when the
    table was built (biobert + bert tokenization + txt_token_size > 1)."""
    inclusion_ok = (
        ("txt" in cfg.input_types and "txt1" in cfg.fullmodal_definition
         and phase_missing_key.replace("missing", "full") in cfg.modality_inclusion)
        or (phase_missing_key in cfg.modality_inclusion and "txt" in cfg.input_types))
    if inclusion_ok and "txt1" in file_name and not force_missing and observed:
        text_data = data_pkl["txt_input"][0].strip()
        if len(text_data) != 0:
            row = table.rows_by_text.get(text_data)
            if row is not None:
                return row, int(table.lengths[row]), False
    return 0, 0, True


