"""Per-sample assembly: the __getitem__ semantics of the reference datasets
(dataset_new.py:581-788 train, :1292-1547 eval, :1946-2182 multiple-train),
emitting dicts of statically-shaped numpy arrays ready to stack into device
batches.

Differences from the reference (deliberate):
  * every sample has identical shapes — no collate-time surprises;
  * each dataset carries its own seeded RNG instead of the process-global
    ``random`` module (parity targets are distribution-level);
  * stay pkls are LRU-cached instead of re-unpickled per item
    (the reference reloads the full stay every __getitem__,
    dataset_new.py:591-592).

The port's own copy of ``medical_tri_modal_pilot_tpu/data/dataset.py``.
"""
from __future__ import annotations

import math
import pickle
import random
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Union

import numpy as np

from ..config import Config
from ..constants import FEATURE_MINS, FEATURE_MAX_MINS
from . import window as W
from .images import load_cxr
from .indexer import EvalIndex, TrainIndex, MULTIPLE_TASKS
from .text import BioBertStore, fetch_text, fetch_text_id, load_txt_dict
from .zeros import is_shared_zero, zero_array


class _StayCache:
    """Byte-budgeted LRU over parsed stay pkls (raw, un-normalized).

    Budgeted by estimated in-memory size rather than entry count so a
    typical split fits entirely (a stay is ~25-200 KB; the old 256-entry
    cap evicted half of a 1000-stay epoch and re-unpickled ~750 times).
    Thread-safe for the worker pool; the unpickle runs outside the lock."""

    def __init__(self, budget_mb: int = 512):
        self.budget = budget_mb << 20
        self._d: "OrderedDict[str, dict]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _size(raw: dict) -> int:
        n = 4096
        for v in raw.values():
            if isinstance(v, np.ndarray):
                n += v.nbytes
            elif isinstance(v, (list, tuple)):
                n += 64
                for e in v:
                    n += e.nbytes if isinstance(e, np.ndarray) else 64
            elif isinstance(v, str):
                n += len(v)
        return n

    def get(self, path: str) -> dict:
        with self._lock:
            raw = self._d.get(path)
            if raw is not None:
                self._d.move_to_end(path)
                return raw
        with open(path, "rb") as f:
            raw = pickle.load(f)
        if raw.get("cxr_input") is None:
            raw.pop("cxr_input", None)
        size = self._size(raw)
        with self._lock:
            if path not in self._d:
                self._d[path] = raw
                self._bytes += size
                while self._bytes > self.budget and self._d:
                    _, old = self._d.popitem(last=False)
                    self._bytes -= self._size(old)
        return raw


def _normalized_data(raw: dict) -> np.ndarray:
    return (raw["data"] - FEATURE_MINS) / FEATURE_MAX_MINS


class _Base:
    def __init__(self, cfg: Config, phase: str):
        assert phase in ("train", "val", "test")
        self.cfg = cfg
        self.phase = phase
        self.cache = _StayCache()
        self.txt_dict = load_txt_dict(cfg, "train")
        self.txt_dict.update(load_txt_dict(cfg, "test"))
        self.bioemb = BioBertStore(cfg.biobert_path) if cfg.berttype == "biobert" else None
        if phase == "train":
            self.img_kind = {"random": "random", "resize": "resize",
                             "resize_crop": "resize_crop",
                             "resize_affine_crop": "resize_affine_crop",
                             "randaug": "randaug"}[cfg.image_train_type]
        else:
            self.img_kind = {"center": "center", "resize": "resize_eval",
                             "resize_crop": "resize_crop",
                             "resize_larger": "resize_crop"}[cfg.image_test_type]
        self.image_size = cfg.image_size
        from .images import set_image_cache_dir, set_image_cache_mb
        set_image_cache_mb(cfg.image_cache_mb)
        set_image_cache_dir(getattr(cfg, "image_cache_dir", ""))
        self.is_event_task = cfg.output_type in MULTIPLE_TASKS
        self._vslt_keep = ~np.array(cfg.vslt_mask)
        self._native = None
        self._native_ready = False
        # wire-format toggles (H2D byte reduction, bit-exact after the
        # trainer's resolution on the device — Trainer.resolve_wire):
        self._txt_table = None   # set via set_txt_table (data/txt_table.py)
        self._img_u8 = bool(getattr(cfg, "img_wire_u8", 0))

    def set_txt_table(self, table) -> None:
        """Switch this dataset to emit ``txt_id`` int32 rows into ``table``
        instead of dense (txt_token_size, 768) embeddings (txt_table.py)."""
        self._txt_table = table

    @property
    def native(self):
        """C++ TIE batch assembler (--worker-type native): built lazily from
        this split's stays on first item. TIE-only — the carryforward grid
        and the pretrain sequence generator (auxiliary_loss_input) keep the
        numpy path. Falls back silently if native/build.sh hasn't run."""
        if self._native_ready:
            return self._native
        self._native_ready = True
        cfg = self.cfg
        if (cfg.worker_type == "native" and cfg.vslt_type != "carryforward"
                and cfg.auxiliary_loss_input is None):
            from .native import TIEBatchAssembler, build_record_cache, load_library
            if load_library() is not None:
                paths = sorted({s.pkl_path for s in self.index.samples})
                adjust_key = ("train-missing" in cfg.modality_inclusion
                              if self.phase == "train"
                              else "test-missing" in cfg.modality_inclusion)
                self._native = TIEBatchAssembler(
                    build_record_cache(paths), cfg.tie_len,
                    cfg.realtime == 1, adjust_key, n_threads=1)
        return self._native

    # -- modality branches --------------------------------------------------

    def _zero_image(self):
        s = self.image_size
        if self.cfg.multiimages == 0:
            return zero_array((1, s, s)), np.float32(-1.0)
        return (zero_array((3, 1, s, s)),
                np.array([10, 10, 10], dtype=np.float32))

    def _fetch_image(self, raw: dict, file_name: str, type_code: int,
                     selected_key: int, min_time: float, rng: random.Random,
                     missing_comb: int, observed: bool):
        """Image branch (dataset_new.py:677-738). Returns (img, img_time,
        missing flag).

        Reference quirk preserved bug-for-bug: ``type_code`` here is the
        POST-remap code (class2dict_missing, dataset_new.py:544-547/1203)
        while the gate set (0, 2, 3, 5) is the PRE-remap image-available
        set — so images silently go missing for remapped codes 1/4 (which
        DO have images by key) and the gate passes for 2/3 (which don't;
        their cxr_li filter comes up empty). Only remapped codes 0 and 5
        actually load images, in training and eval alike — matching the
        reference's shipped behavior (its own gate is dataset_new.py:677/
        :1424 against the remapped self._type_list)."""
        cfg = self.cfg
        phase_full = "train-full" if self.phase == "train" else "test-full"
        phase_missing = "train-missing" if self.phase == "train" else "test-missing"
        gate = (
            ("img" in cfg.input_types and "img1" in cfg.fullmodal_definition
             and phase_full in cfg.modality_inclusion)
            or (phase_missing in cfg.modality_inclusion
                and type_code in (0, 2, 3, 5) and "img" in cfg.input_types))
        if not (gate and "cxr_input" in raw):
            img, t = self._zero_image()
            return img, t, True
        cxr_li = [c for c in raw["cxr_input"] if c[0] <= selected_key]
        forced = missing_comb in (1, 2)
        if not cxr_li or forced or not observed:
            img, t = self._zero_image()
            return img, t, True
        if cfg.multiimages == 0:
            cxr_time, cxr_path = sorted(cxr_li, key=lambda c: (c[0], c[1]))[-1]
            try:
                img = load_cxr(cfg.image_data_path + cxr_path, self.img_kind,
                               self.image_size, rng)
            except (FileNotFoundError, OSError):
                # pkl metadata references a jpeg missing from
                # --image-data-path (e.g. the bundled sample_data):
                # degrade to a missing image instead of crashing
                img, t = self._zero_image()
                return img, t, True
            if cfg.realtime == 1:
                cxr_time = cxr_time - selected_key
            else:
                cxr_time = cxr_time - min_time
            return img.astype(np.float32), np.float32(cxr_time), False
        # multi-image: up to 3 latest, padded with zeros / time 10
        infos = sorted(cxr_li, key=lambda c: (c[0], c[1]))[-3:]
        imgs, times = [], []
        for cxr_time, cxr_path in infos:
            try:
                imgs.append(load_cxr(cfg.image_data_path + cxr_path,
                                     self.img_kind, self.image_size, rng))
            except (FileNotFoundError, OSError):
                continue
            times.append(cxr_time - selected_key)
        if not imgs:
            img, t = self._zero_image()
            return img, t, True
        while len(imgs) < 3:
            imgs.append(np.zeros((1, self.image_size, self.image_size), np.float32))
            times.append(10)
        return (np.stack(imgs).astype(np.float32),
                np.array(times, dtype=np.float32), False)

    # -- core ----------------------------------------------------------------

    def _assemble(self, pkl_path: str, file_name: str, type_code: int,
                  selected_key: int, rand_length: int,
                  labels_by_key: dict, target: int, event_times: list,
                  missing_comb: int, rng: random.Random,
                  img_observed: bool = True, txt_observed: bool = True
                  ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        raw = self.cache.get(pkl_path)
        gender = 1.0 if raw["gender"] == "M" else 0.0
        static = np.array([gender, raw["age"]], dtype=np.float32)

        old_key = selected_key
        orig_length = rand_length
        native = self.native if cfg.vslt_type != "carryforward" else None

        time_data_list = list(raw["data_in_time"][selected_key - rand_length + 1:
                                                  selected_key + 1])
        f_indices = np.zeros(36, dtype=np.float32)
        if native is None:
            data = _normalized_data(raw)
            mask, delta = raw["mask"], raw["delta"]
            data_seq, mask_seq, delta_seq, input_length = W.sequence_generator(
                data, mask, delta, selected_key, rand_length, cfg.window_size)
            if cfg.auxiliary_loss_input is not None:
                data_seq, mask_seq, delta_seq, input_length, f_indices = (
                    W.sequence_generator_pretrain(data, mask, delta, selected_key,
                                                  rand_length, cfg.window_size))
                f_indices = f_indices.astype(np.float32)

        # trim_nones still runs host-side even on the native path: its
        # late_nones / key shift feed the target relabeling and the
        # realtime txt_time below (the C++ redoes the same trim internally
        # for the stream itself)
        adjust_key = ("train-missing" in cfg.modality_inclusion
                      if self.phase == "train"
                      else "test-missing" in cfg.modality_inclusion)
        time_data_list, rand_length, key_delta, late_nones = W.trim_nones(
            time_data_list, rand_length, adjust_key)
        selected_key = selected_key + key_delta

        min_time = 0.0
        if cfg.vslt_type == "carryforward":
            n = data_seq.shape[0]
            vslt = np.zeros((3, cfg.window_size, cfg.vslt_len), dtype=np.float32)
            keep = self._vslt_keep
            vslt[0, :n] = data_seq[:, keep]
            vslt[1, :n] = mask_seq[:, keep]
            vslt[2, :n] = delta_seq[:, keep]
        elif native is not None:
            vslt, input_length, min_time = native.assemble_one(
                pkl_path, old_key, orig_length)
        else:
            vslt, input_length, min_time = W.assemble_tie(
                data_seq, delta_seq, time_data_list, selected_key,
                rand_length, cfg.tie_len, cfg.realtime == 1)

        # target relabeling (dataset_new.py:665-674 / :2032-2065)
        target_aux = 0.0
        event_time = -1.0
        if target != 0 and event_times:
            if self.is_event_task:
                later = sorted(
                    (e[0] if isinstance(e, tuple) else e) for e in event_times
                    if (e[0] if isinstance(e, tuple) else e) > selected_key)
                event_time = later[0] if later else -1.0
            else:
                event_time = event_times[0]
        out_target: Union[float, np.ndarray]
        if cfg.model_types == "classification":
            t = labels_by_key[old_key][0][-1] + late_nones
            if t == 0:
                raise ValueError("Target 0 error for Multi-Classification Problem")
            t = min(t, 12) - 1
            if cfg.loss_types == "bces":
                multi = np.zeros(12, dtype=np.float32)
                multi[t] = 1
                out_target = multi
            elif cfg.loss_types == "bceandsoftmax":
                multi = np.zeros(12, dtype=np.float32)
                multi[t] = 1
                out_target = float(t)
                target_aux = multi  # type: ignore[assignment]
            elif cfg.loss_types == "rmse":
                out_target = float(event_time - selected_key)
            else:
                out_target = float(t)
        else:
            if target != 0:
                if labels_by_key[old_key][0][-1] + late_nones > cfg.prediction_range:
                    out_target, target_aux = 0.0, 0.0
                else:
                    out_target = 1.0
                    target_aux = float(event_time - selected_key)
            else:
                out_target = 0.0

        img, img_time, img_missing = self._fetch_image(
            raw, file_name, type_code, selected_key, min_time, rng,
            missing_comb, img_observed)

        phase_missing = ("train-missing" if self.phase == "train"
                         else "test-missing")
        if self._txt_table is not None:
            # wire format: int32 row id into the device-resident embedding
            # table instead of the dense (128, 768) fp32 payload — the
            # trainer gathers the identical row in-graph (txt_table.py)
            txt_id, txt_length, txt_missing = fetch_text_id(
                cfg, raw, file_name, self._txt_table, phase_missing,
                force_missing=(missing_comb in (1, 3)),
                observed=txt_observed)
        else:
            txt, txt_length, txt_missing = fetch_text(
                cfg, raw, file_name, self.txt_dict, self.bioemb, phase_missing,
                force_missing=(missing_comb in (1, 3)),
                txt_token_size=cfg.txt_token_size,
                token_max_length=cfg.token_max_length,
                observed=txt_observed)

        missing = np.array([0.0, float(img_missing), float(txt_missing)],
                           dtype=np.float32)
        txt_time = np.float32(-selected_key if cfg.realtime == 1 else 0.0)

        if self._img_u8 and isinstance(img, np.ndarray) \
                and img.dtype == np.float32:
            # wire format: pixels came out of to_tensor as k/255 fp32
            # (images.py:117), so rint(img*255) recovers the exact uint8
            # and the trainer's in-graph /255 reproduces identical fp32.
            # Shared zero rows stay shared (pipeline._stack skips them).
            img = (zero_array(img.shape, np.uint8) if is_shared_zero(img)
                   else np.rint(img * 255.0).astype(np.uint8))

        out = {
            "vslt": np.asarray(vslt, dtype=np.float32),
            "static": static,
            "target": (np.asarray(out_target, dtype=np.float32)),
            "input_length": np.int32(input_length),
            "img": img,
            "img_time": np.asarray(img_time, dtype=np.float32),
            "txt_length": np.int32(txt_length),
            "txt_time": txt_time,
            "missing": missing,
            "f_indices": f_indices,
            "target_aux": np.asarray(target_aux, dtype=np.float32),
        }
        if self._txt_table is not None:
            out["txt_id"] = np.int32(txt_id)
        else:
            out["txt"] = np.asarray(txt, dtype=np.float32)
        return out


class TrainingDataset(_Base):
    """Random (key, window) sampling per item, weighted-class compatible."""

    def __init__(self, cfg: Config, index: TrainIndex, seed: int = 0):
        super().__init__(cfg, "train")
        self.index = index
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.index.samples)

    @property
    def type_list(self) -> List[int]:
        return self.index.type_list

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.index.samples[i]
        code = self.index.type_list[i]
        key = self.rng.choice(s.keys)
        length = self.rng.choice(s.win_sizes[key])
        return self._assemble(s.pkl_path, s.file_name, code, key, length,
                              s.labels_by_key, s.target, s.event_times,
                              s.missing_comb, self.rng)


class EvalDataset(_Base):
    """Deterministic (key, max-window) per item; optional observed-prop
    modality dropout (dataset_new.py:1442-1508)."""

    def __init__(self, cfg: Config, index: EvalIndex, split: str, seed: int = 0):
        super().__init__(cfg, "val" if split == "validation" else "test")
        self.index = index
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.index.samples)

    @property
    def type_list(self) -> List[int]:
        return self.index.type_list

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.index.samples[i]
        code = self.index.type_list[i]
        img_observed = True
        txt_observed = True
        if self.cfg.image_observed_prop < 100:
            img_observed = self.rng.random() < self.cfg.image_observed_prop / 100.0
        if self.cfg.text_observed_prop < 100:
            txt_observed = self.rng.random() < self.cfg.text_observed_prop / 100.0
        return self._assemble(s.pkl_path, s.file_name, code, s.key, s.win_size,
                              s.labels_by_key, s.target, s.event_times, 0,
                              self.rng, img_observed, txt_observed)
