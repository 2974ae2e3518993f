"""Sample-index construction: eligibility, modality type codes, window caches.

This module reimplements the reference's dataset __init__ machinery
(builder/data/dataset_new.py:199-547 Onetime train, :790-1284 Onetime eval,
:1549-1943 Multiple train, :2183+ Multiple eval, and
builder/utils/utils.py:200-592 val-index makers) as pure host-side Python —
it runs once per training job, so it stays off the device.

Key-list semantics (dataset_new.py:333-339): for each stay we compute six
candidate lists of window *end indices* (``keys``):

  0  pp/nn keys (any)               3  patient-negative keys (any)
  1  pp/nn keys with image by then  4  pn keys with image by then
  2  pp/nn keys without image       5  pn keys without image

A training sample is a (stay, key list) pair tagged with a modality/target
type code later remapped to 8 sampler classes (class2dict_missing,
dataset_new.py:240,542-547). Eval samples pin one (stay, key) each with a
deterministic window size (max of possibleWinSizes[key]), cached to
./data/testIndexes/*.pkl with the reference's exact file-name contract so
existing caches remain valid.

The port's own copy of ``medical_tri_modal_pilot_tpu/data/indexer.py``.
"""
from __future__ import annotations

import math
import os
import pickle
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from .text import load_txt_dict, txt_files_present

# type-code remaps (dataset_new.py:240-241, 827-831)
CLASS2DICT_MISSING = {3: 1, 6: 2, 9: 3, 2: 4, 8: 6, 11: 7, 1: 4, 4: 5, 7: 6, 10: 7}
CLASS2DICT_MISSING_CLS = {6: 1, 9: 2}
CLASS2DICT_FULL = {2: 0}

# missing-exhaustive duplication maps (dataset_new.py:233-238)
EXH_TXT0_IMG1 = {3: 9, 4: 10, 5: 11}
EXH_TXT1_IMG0 = {6: 9, 7: 10, 8: 11}
EXH_TXT1_IMG1_1 = {0: 9, 1: 10, 2: 11}
EXH_TXT1_IMG1_2 = {0: 6, 1: 7, 2: 8}
EXH_TXT1_IMG1_3 = {0: 3, 1: 4, 2: 5}

MULTIPLE_TASKS = ("vasso", "intubation", "cpr", "transfer")


def search_walk(path: str, extension: str = ".pkl") -> List[str]:
    """Recursive file listing (reference utils.py:116-131), sorted for
    determinism across filesystems."""
    found = []
    for root, _dirs, files in os.walk(path):
        for fn in files:
            if os.path.splitext(fn)[-1] == extension:
                found.append(f"{root}/{fn}")
    return sorted(found)


def patient_wise_ordering(cfg: Config):
    """Group stays by patient-id filename prefix and split train/val
    (reference utils.py:141-160)."""
    train_dir = search_walk(cfg.train_data_path, ".pkl")
    patient_dict: Dict[str, List[str]] = {}
    for p in train_dir:
        pat_id = p.split("/")[-1].split("_")[0]
        patient_dict.setdefault(pat_id, []).append(p)
    keys = sorted(patient_dict.keys())
    if cfg.cross_fold_val == 1:
        rng = random.Random(cfg.seed)
        shuffled = list(keys)
        rng.shuffle(shuffled)
        keys_list = sorted([shuffled[i::len(cfg.seed_list)] for i in range(len(cfg.seed_list))])
    else:
        n_val = int(len(keys) * (cfg.val_data_ratio / 0.9))
        val, train = keys[:n_val], keys[n_val:]
        keys_list = [list(train), list(val)]
    return patient_dict, keys_list


# ---------------------------------------------------------------------------
# Stay loading
# ---------------------------------------------------------------------------

@dataclass
class Stay:
    path: str
    file_name: str          # after txt1/img1 availability rewrites
    raw: dict               # the pkl contents (cxr_input already AR-filtered)

    @property
    def pat_chid(self) -> Tuple[int, int]:
        return int(self.raw["pat_id"]), int(self.raw["chid"])


def _aspect_ratio_ok(cxr_entry, cfg: Config) -> bool:
    # filename suffix "..._aspect_ratio_<r>.jpg"; reference compares the
    # integer part of r against the bounds (dataset_new.py:287)
    val = float(cxr_entry[1].split("_")[-1].split(".")[0])
    return cfg.ar_lowerbound <= val <= cfg.ar_upperbound


def load_stay(pkl_path: str, cfg: Config, txt_dict: dict,
              full_branch: bool = False,
              txt_strict: bool = True) -> Optional[Stay]:
    """Load one stay pkl and apply the availability rewrites
    (dataset_new.py:276-311).

    ``full_branch`` selects the reference's train-full/test-full handling:
    only the aspect-ratio img rewrite applies and the fullmodal gate drops
    ineligible stays. In the missing branch (dataset_new.py:304-311), a
    txt1 stay whose (pat_id, chid) is absent from the token dict is
    DROPPED entirely (returns None, :306-307); present-but-empty tokens
    rewrite the name to txt0 (:308-309); and an img1 name with no
    cxr_input left rewrites to img0 (:310-311).

    ``txt_strict=False`` (set by the index builders when NO token file
    exists under cfg.dir_root — a layout the reference cannot run at all,
    its txtDictLoad raises) demotes the drop to the txt1->txt0 rewrite so
    token-file-less datasets keep their stays with text treated missing."""
    file_name = pkl_path.split("/")[-1]
    with open(pkl_path, "rb") as f:
        raw = pickle.load(f)
    if raw.get("cxr_input") is None:
        raw.pop("cxr_input", None)
    if "cxr_input" in raw:
        kept = [c for c in raw["cxr_input"] if _aspect_ratio_ok(c, cfg)]
        if kept:
            raw["cxr_input"] = kept
        else:
            del raw["cxr_input"]
            file_name = file_name.replace("_img1", "_img0")
    if not full_branch:
        if "txt1" in file_name:
            key = (int(raw["pat_id"]), int(raw["chid"]))
            if key not in txt_dict:
                if txt_strict:
                    return None
                file_name = file_name.replace("_txt1_", "_txt0_")
            elif len(txt_dict[key]) == 0:
                file_name = file_name.replace("_txt1_", "_txt0_")
        if "cxr_input" not in raw and "img1" in file_name:
            file_name = file_name.replace("_img1", "_img0")
    return Stay(path=pkl_path, file_name=file_name, raw=raw)


def _passes_fullmodal_gate(stay: Stay, cfg: Config, txt_dict: dict) -> bool:
    """train-full / test-full eligibility (dataset_new.py:294-303).

    Checked against the AR-rewritten name (full_branch load_stay applies
    no txt/img availability rewrites, matching the reference where the
    definition check at :295 sees only the AR rewrite from :291)."""
    if cfg.fullmodal_definition not in stay.file_name:
        return False
    if "cxr_input" not in stay.raw and "img1" in cfg.fullmodal_definition:
        return False
    if "txt1" in cfg.fullmodal_definition:
        key = stay.pat_chid
        if key not in txt_dict or len(txt_dict[key]) == 0:
            return False
    return True


def _common_gates(stay: Stay, cfg: Config) -> bool:
    seq_len = stay.raw["data"].shape[0]
    if seq_len < cfg.min_inputlen:
        return False
    order = stay.raw["feature_order"]
    if not all(f in order for f in cfg.mandatory_vitalsign_labtest):
        return False
    return True


def _filtered_win_sizes(stay: Stay, cfg: Config) -> Dict[int, List[int]]:
    out = {}
    for k, sizes in stay.raw["possibleWinSizes"].items():
        kept = [s for s in sizes if s >= cfg.min_inputlen]
        if kept:
            out[k] = kept
    return out


# ---------------------------------------------------------------------------
# Eligibility: six key lists + label dict
# ---------------------------------------------------------------------------

@dataclass
class Eligibility:
    keys_alltypes: List[List[int]]          # 6 lists of window-end indices
    labels_by_key: Dict[int, List[List[int]]]  # key -> [[lo,hi] hour ranges]
    target: int
    target_type: int                        # 0 nonpat, 1 patient, 2 pat-neg
    win_sizes: Dict[int, List[int]]
    event_times: list                       # [] or [hour] / [(hour, ...)] list


def _positive_indices(event_hour: float, seq_len: int, cfg: Config):
    """Window-end keys whose window ends within prediction_range of the event
    (dataset_new.py:364-379)."""
    event_hour = math.ceil(event_hour)
    pairs = [
        (event_hour - i, [i - 1, i])
        for i in range(1, cfg.prediction_range + 1)
        if (event_hour >= cfg.min_inputlen + i - 1) and (event_hour - i < seq_len)
    ]
    if not pairs:
        raise ValueError("Classification Error: no feasible positive indices")
    return pairs


def compute_eligibility(stay: Stay, cfg: Config, phase: str) -> Optional[Eligibility]:
    """Compute the six key lists for one stay.

    ``phase`` is 'train' or 'test' — selects which half of
    modality_inclusion applies (train-missing vs test-missing).
    Mirrors dataset_new.py:333-419 (mortality) and :1673-1783 (events).
    """
    raw = stay.raw
    seq_len = raw["data"].shape[0]
    inclusion = cfg.modality_inclusion
    missing_mode = (f"{phase}-missing" in inclusion)
    full_mode = (f"{phase}-full" in inclusion)
    img1_in_def = "img1" in cfg.fullmodal_definition

    keys6: List[List[int]] = [[] for _ in range(6)]
    labels_by_key: Dict[int, List[List[int]]] = {}
    event_times: list = []

    all_keys = list(range(cfg.min_inputlen - 1, seq_len - cfg.prediction_range))

    if cfg.output_type == "mortality":
        if raw["death_yn"] == 0:
            target, target_type = 0, 0
            keys6[0] = list(all_keys)
        else:
            death_time = raw["death_time"]
            event_times = [death_time]
            if (death_time > seq_len + cfg.prediction_range - 1) or (death_time < cfg.min_inputlen):
                target, target_type = 0, 2
                keys6[3] = list(all_keys)
            else:
                target, target_type = 1, 1
                for key, rng in _positive_indices(death_time, seq_len, cfg):
                    labels_by_key.setdefault(key, [])
                    if rng not in labels_by_key[key]:
                        labels_by_key[key].append(rng)
                    if key not in keys6[0]:
                        keys6[0].append(key)
                keys6[0].sort()
    else:
        time_key = f"{cfg.output_type}_time"
        outbreaks = raw.get(time_key)
        if outbreaks:
            outbreaks = sorted(outbreaks)
            first_is_tuple = isinstance(outbreaks[0], tuple)
            hour = (lambda o: o[0]) if first_is_tuple else (lambda o: o)
            outbreaks = [o for o in outbreaks
                         if cfg.min_inputlen <= hour(o) <= seq_len + cfg.prediction_range - 1]
            target = 1 if outbreaks else 0
            if target:
                event_times = list(outbreaks)
        else:
            target = 0
        if target == 0:
            target_type = 0
            keys6[0] = list(all_keys)
        else:
            target_type = 1
            seen_hours = set()
            for ob in event_times:
                h = math.ceil(ob[0] if isinstance(event_times[0], tuple) else ob)
                if h in seen_hours:
                    continue
                seen_hours.add(h)
                for key, rng in _positive_indices(h, seq_len, cfg):
                    labels_by_key.setdefault(key, [])
                    if rng not in labels_by_key[key]:
                        labels_by_key[key].append(rng)
                    if key not in keys6[0]:
                        keys6[0].append(key)
            keys6[0].sort()

    if cfg.model_types == "classification" and target != 1:
        return None

    # image-availability split of positive/nn keys (dataset_new.py:384-394)
    has_img = "cxr_input" in raw
    earliest_img = min(c[0] for c in raw["cxr_input"]) if has_img else None
    is_event_task = cfg.output_type in MULTIPLE_TASKS
    if is_event_task or target_type in (0, 1):
        if ((img1_in_def and full_mode) or missing_mode) and has_img:
            keys6[1] = [k for k in keys6[0] if earliest_img <= k]
            keys6[2] = [k for k in keys6[0] if earliest_img > k]
        elif missing_mode:
            keys6[2] = list(keys6[0])

    if img1_in_def and full_mode and (is_event_task or target_type != 2):
        if not keys6[1]:
            return None

    # patient-negative keys (dataset_new.py:396-406 / :1753-1762)
    if target == 1 or target_type == 2:
        if target == 1:
            keys6[3] = [k for k in all_keys if k not in keys6[0]]
        pn_gate = (not is_event_task) or len(keys6[3]) > 0
        if pn_gate:
            if ((full_mode and img1_in_def) or missing_mode) and has_img:
                keys6[4] = [k for k in keys6[3] if earliest_img <= k]
                keys6[5] = [k for k in keys6[3] if earliest_img > k]
            elif missing_mode:
                keys6[5] = list(keys6[3])

    win_sizes = _filtered_win_sizes(stay, cfg)
    keys6 = [[k for k in lst if k in win_sizes] for lst in keys6]
    if all(len(lst) == 0 for lst in keys6):
        return None

    return Eligibility(
        keys_alltypes=keys6,
        labels_by_key=labels_by_key,
        target=target,
        target_type=target_type,
        win_sizes=win_sizes,
        event_times=event_times,
    )


# ---------------------------------------------------------------------------
# Training index
# ---------------------------------------------------------------------------

@dataclass
class TrainSample:
    pkl_path: str
    keys: List[int]
    labels_by_key: Dict[int, List[List[int]]]
    win_sizes: Dict[int, List[int]]
    target: int
    event_times: list        # mortality: [hour]; events: [(hour, ...)]
    missing_comb: int        # 0 original, 1 vslt-only, 2 vslt+txt, 3 vslt+img
    file_name: str


@dataclass
class TrainIndex:
    samples: List[TrainSample] = field(default_factory=list)
    type_list: List[int] = field(default_factory=list)


def _append_exhaustive(index: TrainIndex, s: TrainSample, raw_code: int) -> None:
    """missing-exhaustive duplication (dataset_new.py:474-514)."""
    def clone(comb):
        return TrainSample(s.pkl_path, s.keys, s.labels_by_key, s.win_sizes,
                           s.target, s.event_times, comb, s.file_name)
    if raw_code in EXH_TXT0_IMG1:
        index.samples.append(clone(1))
        index.type_list.append(EXH_TXT0_IMG1[raw_code])
    elif raw_code in EXH_TXT1_IMG0:
        index.samples.append(clone(1))
        index.type_list.append(EXH_TXT1_IMG0[raw_code])
    elif raw_code in EXH_TXT1_IMG1_1:
        for comb, mapping in ((1, EXH_TXT1_IMG1_1), (2, EXH_TXT1_IMG1_2), (3, EXH_TXT1_IMG1_3)):
            index.samples.append(clone(comb))
            index.type_list.append(mapping[raw_code])


def _build_train_index(cfg: Config, pkl_paths: Sequence[str]) -> TrainIndex:
    txt_dict = load_txt_dict(cfg, "train")
    txt_dict.update(load_txt_dict(cfg, "test"))
    index = TrainIndex()

    inclusion_full = "train-full" in cfg.modality_inclusion
    strict = txt_files_present(cfg)
    for pkl_path in pkl_paths:
        stay = load_stay(pkl_path, cfg, txt_dict,
                         full_branch=inclusion_full, txt_strict=strict)
        if stay is None:   # missing branch: txt1 not in token dict
            continue
        if inclusion_full:
            if not _passes_fullmodal_gate(stay, cfg, txt_dict):
                continue
        if not _common_gates(stay, cfg):
            continue
        elig = compute_eligibility(stay, cfg, phase="train")
        if elig is None:
            continue

        # keep only lists 1,2,4,5 (dataset_new.py:424)
        kept = [elig.keys_alltypes[i] for i in (1, 2, 4, 5)]
        has_txt = "txt1" in stay.file_name
        for keylist_type, keys in enumerate(kept):
            if not keys:
                continue
            if keylist_type < 2:
                raw_code = {
                    (0, 1, True): 0, (0, 0, True): 2, (0, 1, False): 3, (0, 0, False): 5,
                    (1, 1, True): 6, (1, 0, True): 8, (1, 1, False): 9, (1, 0, False): 11,
                }[(keylist_type, 1 if elig.target_type == 1 else 0, has_txt)]
                sample = TrainSample(pkl_path, list(keys), elig.labels_by_key,
                                     elig.win_sizes, elig.target, elig.event_times,
                                     0, stay.file_name)
                index.samples.append(sample)
                index.type_list.append(raw_code)
            else:
                if cfg.model_types == "classification":
                    continue
                raw_code = {(2, True): 1, (2, False): 4, (3, True): 7, (3, False): 10}[
                    (keylist_type, has_txt)]
                sample = TrainSample(pkl_path, list(keys), {}, elig.win_sizes,
                                     0, elig.event_times, 0, stay.file_name)
                index.samples.append(sample)
                index.type_list.append(raw_code)
            if cfg.missing_exhaustive == 1 and index.type_list:
                _append_exhaustive(index, index.samples[-1], index.type_list[-1])

    if "train-full" in cfg.modality_inclusion:
        remap = CLASS2DICT_FULL
    else:
        remap = CLASS2DICT_MISSING
    index.type_list = [remap.get(t, t) for t in index.type_list]
    return index


def build_onetime_train_index(cfg: Config, pkl_paths: Sequence[str]) -> TrainIndex:
    assert cfg.output_type == "mortality"
    return _build_train_index(cfg, pkl_paths)


def build_multiple_train_index(cfg: Config, pkl_paths: Sequence[str]) -> TrainIndex:
    assert cfg.output_type in MULTIPLE_TASKS
    return _build_train_index(cfg, pkl_paths)


# ---------------------------------------------------------------------------
# Eval (validation / test) index — deterministic, cached
# ---------------------------------------------------------------------------

@dataclass
class EvalSample:
    pkl_path: str
    key: int
    labels_by_key: Dict[int, List[List[int]]]
    win_size: int
    target: int
    event_times: list
    file_name: str


@dataclass
class EvalIndex:
    samples: List[EvalSample] = field(default_factory=list)
    type_list: List[int] = field(default_factory=list)


def _cache_paths(cfg: Config, split: str) -> Tuple[str, str]:
    """Reference cache filename contract (dataset_new.py:834-837)."""
    base = "./data/testIndexes"
    if split == "test":
        ds = cfg.test_data_path.split("/")[-2]
        prefix = "testIndexes__"
    else:
        ds = cfg.train_data_path.split("/")[-2]
        prefix = "valIndexes__"
    stem = (f"{base}/{prefix}{ds}__{cfg.modality_inclusion.split('_')[-1]}"
            f"__fullmodaldefinition{cfg.fullmodal_definition}"
            f"__winsize{cfg.window_size}__minlen{cfg.min_inputlen}"
            f"__{cfg.output_type}__PW{cfg.prediction_range}")
    return stem + ".pkl", stem + "_winsize.pkl"


def _eval_key_selection(cfg: Config, elig: Eligibility, rng: random.Random) -> List[List[int]]:
    """Per-patient sample caps (utils.py:357-365)."""
    out = []
    for pidx, keys in enumerate(elig.keys_alltypes):
        if not keys:
            out.append([])
            continue
        cap = cfg.pat_pos_sample_n if pidx < 3 else cfg.pat_neg_sample_n
        if len(keys) >= cap:
            out.append(rng.sample(keys, cap))
        else:
            out.append(list(keys))
    return out


def build_eval_index(cfg: Config, pkl_paths: Sequence[str], split: str) -> EvalIndex:
    """Deterministic eval index with the reference's caching contract.

    ``split`` is 'validation' or 'test'. Validation indices are generated
    from the full train directory (utils.py:200-384) and then intersected
    with the provided ``pkl_paths``; test indices are generated from the
    given paths directly (dataset_new.py:991-1104).
    """
    assert split in ("validation", "test")
    txt_dict = load_txt_dict(cfg, "train")
    txt_dict.update(load_txt_dict(cfg, "test"))
    pat_dict_path, win_dict_path = _cache_paths(cfg, split)
    os.makedirs(os.path.dirname(pat_dict_path), exist_ok=True)

    pat_dict: Dict[Tuple[int, int], tuple] = {}
    win_dict: Dict[str, int] = {}
    loaded = False
    if os.path.exists(pat_dict_path) and os.path.exists(win_dict_path):
        with open(pat_dict_path, "rb") as f:
            pat_dict = pickle.load(f)
        with open(win_dict_path, "rb") as f:
            win_dict = pickle.load(f)
        loaded = True

    if split == "validation" and not loaded:
        # generate from the whole train dir, like onetime_outbreak_valdataset_maker
        gen_paths = search_walk(cfg.train_data_path, ".pkl")
        rng = random.Random(cfg.seed)
        val_full = "test-full" in cfg.modality_inclusion
        strict = txt_files_present(cfg)
        for p in gen_paths:
            stay = load_stay(p, cfg, txt_dict,
                             full_branch=val_full, txt_strict=strict)
            if stay is None:   # missing branch: txt1 not in token dict
                continue
            if val_full:
                if not _passes_fullmodal_gate(stay, cfg, txt_dict):
                    continue
            if not _common_gates(stay, cfg):
                continue
            elig = compute_eligibility(stay, cfg, phase="test")
            if elig is None:
                continue
            picked = _eval_key_selection(cfg, elig, rng)
            pat_dict[stay.pat_chid] = (picked, elig.labels_by_key, elig.target,
                                       elig.win_sizes, elig.target_type)
            stem = "_".join(p.split("/")[-1].split("_")[:2])
            for keys in picked:
                for key in keys:
                    name = f"{stem}_{key}"
                    if name not in win_dict:
                        win_dict[name] = max(elig.win_sizes[key])
        with open(pat_dict_path, "wb") as f:
            pickle.dump(pat_dict, f, pickle.HIGHEST_PROTOCOL)
        with open(win_dict_path, "wb") as f:
            pickle.dump(win_dict, f, pickle.HIGHEST_PROTOCOL)
        loaded = True

    index = EvalIndex()
    rng = random.Random(cfg.seed + 1)
    inclusion_full = "test-full" in cfg.modality_inclusion
    img1_in_def = "img1" in cfg.fullmodal_definition
    new_test_entries = False

    staged: List[Tuple[EvalSample, int]] = []
    strict = txt_files_present(cfg)
    for p in pkl_paths:
        stay = load_stay(p, cfg, txt_dict,
                         full_branch=inclusion_full, txt_strict=strict)
        if stay is None:   # missing branch: txt1 not in token dict
            continue
        if inclusion_full and not _passes_fullmodal_gate(stay, cfg, txt_dict):
            continue
        if not _common_gates(stay, cfg):
            continue
        evt = []
        if cfg.output_type == "mortality":
            if stay.raw["death_yn"] != 0:
                evt = [stay.raw["death_time"]]

        if stay.pat_chid in pat_dict:
            picked, labels_by_key, target, win_sizes, target_type = pat_dict[stay.pat_chid]
            if all(len(lst) == 0 for lst in picked):
                continue
        else:
            if split == "validation":
                continue
            elig = compute_eligibility(stay, cfg, phase="test")
            if elig is None:
                continue
            picked = _eval_key_selection(cfg, elig, rng)
            labels_by_key, target = elig.labels_by_key, elig.target
            win_sizes, target_type = elig.win_sizes, elig.target_type
            evt = elig.event_times
            pat_dict[stay.pat_chid] = (picked, labels_by_key, target, win_sizes, target_type)
            new_test_entries = True
        if cfg.output_type in MULTIPLE_TASKS and not evt:
            # recompute event list (not stored in patDict)
            e = compute_eligibility(stay, cfg, phase="test")
            evt = e.event_times if e else []

        has_txt = "txt1" in stay.file_name
        if inclusion_full and not img1_in_def:
            pairs = [(0, picked[0]), (1, picked[3])]
            for kt, keys in pairs:
                for key in keys:
                    if kt == 0:
                        staged.append((EvalSample(p, key, labels_by_key, 0, target, evt, stay.file_name), target_type))
                    elif target == 1:
                        staged.append((EvalSample(p, key, {}, 0, 0, evt, stay.file_name), 2))
        elif inclusion_full and img1_in_def:
            pairs = [(0, picked[1]), (1, picked[4])]
            for kt, keys in pairs:
                for key in keys:
                    if kt == 0:
                        staged.append((EvalSample(p, key, labels_by_key, 0, target, evt, stay.file_name), target_type))
                    elif target == 1:
                        staged.append((EvalSample(p, key, {}, 0, 0, evt, stay.file_name), 2))
        else:  # missing modal: lists 1,2,4,5 (dataset_new.py:1136-1177)
            kept = [picked[1], picked[2], picked[4], picked[5]]
            for kt, keys in enumerate(kept):
                if kt < 2:
                    for key in keys:
                        code = {(0, 1, True): 0, (0, 0, True): 2, (0, 1, False): 3,
                                (0, 0, False): 5, (1, 1, True): 6, (1, 0, True): 8,
                                (1, 1, False): 9, (1, 0, False): 11}[
                            (kt, 1 if target_type == 1 else 0, has_txt)]
                        staged.append((EvalSample(p, key, labels_by_key, 0, target, evt, stay.file_name), code))
                else:
                    if cfg.model_types == "classification":
                        continue
                    for key in keys:
                        code = {(2, True): 1, (2, False): 4, (3, True): 7,
                                (3, False): 10}[(kt, has_txt)]
                        staged.append((EvalSample(p, key, {}, 0, 0, evt, stay.file_name), code))

    # type-code remap (dataset_new.py:1198-1203 / :827-831)
    if inclusion_full:
        remap = CLASS2DICT_FULL
    elif cfg.model_types == "classification":
        remap = CLASS2DICT_MISSING_CLS
    else:
        remap = CLASS2DICT_MISSING

    for sample, code in staged:
        if cfg.model_types == "classification" and sample.target != 1:
            continue
        stem = "_".join(sample.pkl_path.split("/")[-1].split("_")[:2])
        win_key = f"{stem}_{sample.key}"
        if win_key in win_dict:
            sample.win_size = win_dict[win_key]
        else:
            _, _, _, ws, _ = pat_dict[
                (int(stem.split("_")[0]), int(stem.split("_")[1]))]
            sample.win_size = max(ws[sample.key])
            win_dict[win_key] = sample.win_size
        index.samples.append(sample)
        index.type_list.append(remap.get(code, code))

    if split == "test" and (not loaded or new_test_entries):
        with open(pat_dict_path, "wb") as f:
            pickle.dump(pat_dict, f, pickle.HIGHEST_PROTOCOL)
        with open(win_dict_path, "wb") as f:
            pickle.dump(win_dict, f, pickle.HIGHEST_PROTOCOL)

    return index
