"""Batch assembly with host worker pools (the port's own copy of
``medical_tri_modal_pilot_tpu/data/pipeline.py``).

Replaces the reference's torch DataLoader (data_preprocess.py:89-95) with a
pooled batch builder and a bounded prefetch queue. Samples have static
shapes (dataset.py), so batches are plain stacked numpy dicts that the
Trainer copies to the device (``Trainer.device_batch``).

``--worker-type process`` forks its workers. A driver on the GPU has
initialised CUDA before it builds the loaders, and a forked child cannot
use CUDA: the workers touch numpy only (dataset assembly), never torch.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..config import Config
from .dataset import EvalDataset, TrainingDataset
from .indexer import (build_eval_index, patient_wise_ordering, search_walk,
                      _build_train_index)
from .sampler import SequentialSampler, WeightedClassSampler
from .zeros import is_shared_zero

Batch = Dict[str, np.ndarray]


def _stack(samples: List[dict]) -> Batch:
    """Batch collate. Large fields build into a calloc'd buffer and skip
    rows that are shared zero singletons (missing-modality images/text,
    data/zeros.py) — np.zeros pages are already zero, so the per-row copy
    for a 75%-missing image column disappears."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray) and first.nbytes >= 1 << 14:
            buf = np.zeros((len(vals),) + first.shape, first.dtype)
            for i, v in enumerate(vals):
                if not is_shared_zero(v):
                    buf[i] = v
            out[k] = buf
        else:
            out[k] = np.stack(vals)
    return out


# ---------------------------------------------------------------------------
# process workers (fork): the dataset transfers copy-on-write through this
# module global — no pickling of native caches / h5 stores
# ---------------------------------------------------------------------------

_WORKER_DATASET = None


def _worker_init():
    ds = _WORKER_DATASET
    # file handles opened pre-fork are not safe to share; drop them so each
    # worker lazily reopens its own
    bioemb = getattr(ds, "bioemb", None)
    if bioemb is not None:
        bioemb._h5 = None


def _worker_get(idx: int):
    return _WORKER_DATASET.__getitem__(idx)


class BatchLoader:
    """Iterates a dataset in fixed-size batches with worker threads and a
    bounded prefetch queue. drop_last is always on (static batch shapes)."""

    def __init__(self, dataset, batch_size: int, sampler, num_workers: int = 4,
                 prefetch: int = 2, worker_type: str = "thread"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.worker_type = worker_type

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _make_pool(self):
        if self.worker_type == "process":
            # fork + module-global dataset: the index tables and native
            # record cache transfer copy-on-write (the reference used torch
            # DataLoader worker processes, data_preprocess.py:89-95)
            global _WORKER_DATASET
            import multiprocessing
            _WORKER_DATASET = self.dataset
            ctx = multiprocessing.get_context("fork")
            pool = ctx.Pool(self.num_workers, initializer=_worker_init)
            return pool, lambda p, idx: p.map(_worker_get, idx), \
                lambda p: (p.terminate(), p.join())
        # "thread" and "native" both use threads: on the native path the
        # dataset's TIE assembly is a GIL-releasing C++ call (data/native.py)
        pool = ThreadPoolExecutor(self.num_workers)
        return pool, \
            lambda p, idx: list(p.map(self.dataset.__getitem__, idx)), \
            lambda p: p.shutdown(wait=False, cancel_futures=True)

    def __iter__(self) -> Iterator[Batch]:
        indices = self.sampler.epoch_indices()
        n_batches = len(indices) // self.batch_size
        if n_batches == 0:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            pool, run, close = self._make_pool()
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        break
                    batch_idx = indices[b * self.batch_size:(b + 1) * self.batch_size]
                    samples = run(pool, batch_idx)
                    q.put(_stack(samples))
            except BaseException as e:           # propagate, never deadlock
                q.put(e)
                return
            finally:
                close(pool)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # drain until the producer has exited (the JAX package's loader
            # drains and leaves it running): a pass given up early, as the
            # drivers' first_batch gives one up, then finishes its batch
            # before a later pass starts, so the two never interleave
            # their draws from the dataset's shared random.Random
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(0.01)


def get_data_loaders(cfg: Config, patient_dict=None, keys_list=None,
                     k_indx: int = 0) -> Tuple[BatchLoader, BatchLoader, BatchLoader]:
    """(train, val, test) loaders — reference get_data_loader
    (data_preprocess.py:23-97)."""
    if patient_dict is None or keys_list is None:
        patient_dict, keys_list = patient_wise_ordering(cfg)
    if cfg.cross_fold_val == 1:
        folds = list(range(len(cfg.seed_list)))
        fold_val = folds.pop(k_indx)
        train_keys = [k for f in folds for k in keys_list[f]]
        val_keys = keys_list[fold_val]
    else:
        train_keys, val_keys = keys_list[0], keys_list[1]
    train_paths = [p for k in train_keys for p in patient_dict[k]]
    val_paths = [p for k in val_keys for p in patient_dict[k]]
    test_paths = search_walk(cfg.test_data_path, ".pkl")

    train_index = _build_train_index(cfg, train_paths)
    train_data = TrainingDataset(cfg, train_index, seed=cfg.seed)
    val_index = build_eval_index(cfg, val_paths, "validation")
    val_data = EvalDataset(cfg, val_index, "validation", seed=cfg.seed)
    test_index = build_eval_index(cfg, test_paths, "test")
    test_data = EvalDataset(cfg, test_index, "test", seed=cfg.seed)

    sampler = WeightedClassSampler(train_data.type_list, seed=cfg.seed)
    wt = cfg.worker_type
    train_loader = BatchLoader(train_data, cfg.batch_size, sampler,
                               cfg.num_workers, worker_type=wt)
    val_loader = BatchLoader(val_data, cfg.batch_size,
                             SequentialSampler(len(val_data)), cfg.num_workers,
                             worker_type=wt)
    test_loader = BatchLoader(test_data, cfg.batch_size,
                              SequentialSampler(len(test_data)),
                              cfg.num_workers, worker_type=wt)
    return train_loader, val_loader, test_loader


def auto_img_pack_frac(train_loader: BatchLoader) -> float:
    """Data-driven packed capacity for the frozen image trunk
    (models.ImageEncoder._packed_trunk, --img-pack-frac -1).

    The batch's image-present row count is a binomial draw: the weighted
    sampler (sampler.WeightedClassSampler) picks index entries i.i.d.
    with known per-entry probabilities, and only entries whose remapped
    type code is 0 or 5 can load pixels (dataset._fetch_image docstring —
    the gate set intersected with non-empty cxr filters). Capacity is
    sized at p + 3.5 sigma + 1/B of the batch, so overflow (which falls
    back in-graph to the full-batch trunk, correct but slower) is a
    <0.1% event; p uses the upper bound "every 0/5 draw carries pixels",
    so real overflow is rarer still. Full-modality regimes return 1.0
    (every row has an image — packing is off there anyway)."""
    ds = train_loader.dataset
    cfg = ds.cfg
    if "train-missing" not in cfg.modality_inclusion:
        return 1.0
    sampler = train_loader.sampler
    types = np.asarray(ds.type_list if hasattr(ds, "type_list")
                       else ds.index.type_list)
    if types.size == 0:
        return 0.5
    can_img = np.isin(types, (0, 5)).astype(np.float64)
    probs = getattr(sampler, "probs", None)
    p = float(can_img @ probs if probs is not None else can_img.mean())
    B = max(2, train_loader.batch_size)
    frac = p + 3.5 * float(np.sqrt(p * (1.0 - p) / B)) + 1.0 / B
    return float(min(1.0, max(2.0 / B, frac)))


def get_test_data_loader(cfg: Config) -> BatchLoader:
    """Reference get_test_data_loader (data_preprocess.py:100-126)."""
    test_paths = search_walk(cfg.test_data_path, ".pkl")
    test_index = build_eval_index(cfg, test_paths, "test")
    test_data = EvalDataset(cfg, test_index, "test", seed=cfg.seed)
    return BatchLoader(test_data, cfg.batch_size,
                       SequentialSampler(len(test_data)), cfg.num_workers,
                       worker_type=cfg.worker_type)


class ReplayLoader:
    """Cache assembled eval batches in RAM and replay them on later
    iterations.

    The eval datasets are deterministic by contract (cached index/window
    dicts, dataset_new.py:833-894; deterministic eval transforms), so the
    per-epoch validation loop and 3_test.py's per-checkpoint walk assemble
    byte-identical batches every pass — all host pkl/jpeg/h5 work after
    the first pass is waste (a warm validation pass measured ~26 s/epoch
    on the 1000-stay fixtures vs ~1 s of device eval steps). Bounded by
    ``budget_mb``: a set that exceeds the budget drops the cache and
    streams from the inner loader every pass (the batch producer assembles
    in order, so a partial cache could not skip any host work). Cached
    arrays are marked read-only so an accidental downstream mutation
    raises instead of corrupting later epochs."""

    def __init__(self, loader, budget_mb: int = 2048):
        self.loader = loader
        self.budget = budget_mb * 2 ** 20
        self._cache: list = []
        self._bytes = 0
        self._complete = False
        self._overflow = False
        self._gen = 0

    def __len__(self) -> int:
        return len(self.loader)

    @property
    def dataset(self):
        return self.loader.dataset

    def __iter__(self):
        if self._complete:
            yield from self._cache
            return
        # accumulate into pass-local state and publish only at a complete
        # pass whose generation is still current: an abandoned pass-1
        # generator resumed after a newer pass rebuilt the cache (or two
        # concurrently-live iterators) can then neither duplicate prefix
        # batches nor interleave appends into the shared list
        self._gen += 1
        gen = self._gen
        cache: list = []
        nbytes = 0
        overflow = self._overflow   # a past overflow pins streaming mode
        for batch in self.loader:
            if not overflow:
                size = sum(v.nbytes for v in batch.values()
                           if hasattr(v, "nbytes"))
                if nbytes + size <= self.budget:
                    for v in batch.values():
                        if hasattr(v, "flags"):
                            v.flags.writeable = False
                    cache.append(batch)
                    nbytes += size
                else:
                    overflow = True
                    cache = []
                    nbytes = 0
            yield batch
        if gen != self._gen:   # a newer pass superseded this generator
            return
        if overflow:
            self._overflow = True
        else:
            self._cache, self._bytes, self._complete = cache, nbytes, True


def maybe_replay(loader, cfg):
    """Wrap an eval loader in ReplayLoader unless replay is disabled or the
    eval batches are not pass-deterministic: --image/text-observed-prop
    < 100 draws per-item modality dropout from a stateful ``random.Random``
    on EVERY assembly (data/dataset.py:389-392, matching the reference's
    per-__getitem__ draw), so a streaming pass redraws while a replayed
    pass would freeze pass-1's draws — and whether a run streams or
    replays must never depend on the cache byte budget."""
    if (cfg.eval_batch_cache_mb > 0
            and cfg.image_observed_prop >= 100
            and cfg.text_observed_prop >= 100):
        return ReplayLoader(loader, cfg.eval_batch_cache_mb)
    return loader


def length_rebatch(loader, pool_batches: int):
    """Regroup consecutive train batches by TIE length (--length-rebatch):
    pool P assembled batches, stable-sort their samples by input_length,
    re-chunk into the same batch sizes. Combined with --tie-buckets this
    turns a uniform-length pool into mostly-short batches that hit the
    small compiled buckets (a pool's sorted prefix batches pay only their
    own max length; only the tail batch pays the pool max).

    Each pool holds exactly the sampler's sample multiset — only batch
    COMPOSITION changes, a bounded, documented deviation from the
    reference's i.i.d. batch order (default off; the reference has no
    analogous knob). Deterministic given the sampler's epoch order."""
    if pool_batches <= 1:
        yield from loader
        return

    def resort(pool):
        if "input_length" not in pool[0] or len(pool) == 1:
            yield from pool
            return
        keys = list(pool[0].keys())
        cat = {k: np.concatenate([b[k] for b in pool]) for k in keys}
        order = np.argsort(np.asarray(cat["input_length"]), kind="stable")
        off = 0
        for b in pool:
            n = len(b["input_length"])
            idx = order[off:off + n]
            off += n
            yield {k: cat[k][idx] for k in keys}

    pool = []
    for batch in loader:
        pool.append(batch)
        if len(pool) == pool_batches:
            yield from resort(pool)
            pool = []
    if pool:
        yield from resort(pool)
