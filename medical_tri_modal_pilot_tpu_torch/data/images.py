"""CXR image decode + augmentation on the host (PIL + numpy).

The port's own copy of ``medical_tri_modal_pilot_tpu/data/images.py``. PIL
is imported only inside the functions that decode and transform an image
(``_pil``), so the loader imports, and a run without images runs, where
PIL is not installed; an image run there raises ImportError naming PIL at
its first decode.

Reimplements the torchvision transform stacks of the reference
(dataset_new.py:60-160): histogram equalization, resize / center-crop /
random-resized-crop / random-affine pipelines. Outputs float32 [1, H, W]
in [0, 1] with a static shape so batches stack directly for the device.
"""
from __future__ import annotations

import math
import os
import random
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np


def _pil():
    """PIL's ``Image`` and ``ImageOps``, imported at first use."""
    try:
        from PIL import Image, ImageOps
    except ImportError as e:
        raise ImportError(
            "decoding a CXR image needs PIL (the Pillow package), which is "
            "not installed: run without images (--input-types vslt or "
            "vslt_txt) or install Pillow") from e
    return Image, ImageOps


def equalize(img: Image.Image) -> Image.Image:
    """Histogram equalization (torchvision.functional.equalize analog)."""
    _, ImageOps = _pil()
    return ImageOps.equalize(img)


def _resize_shorter(img: Image.Image, size: int) -> Image.Image:
    Image, _ = _pil()
    # torchvision F.resize(int) semantics: shorter edge -> size, longer edge
    # int-truncated (not rounded); no-op when the shorter edge already
    # matches
    w, h = img.size
    if w <= h:
        if w == size:
            return img
        nw, nh = size, max(1, int(size * h / w))
    else:
        if h == size:
            return img
        nh, nw = size, max(1, int(size * w / h))
    return img.resize((nw, nh), Image.BILINEAR)


def _center_crop(img: Image.Image, size: int) -> Image.Image:
    Image, _ = _pil()
    w, h = img.size
    if w < size or h < size:
        # pad to size (torchvision pads with 0)
        canvas = Image.new(img.mode, (max(w, size), max(h, size)), 0)
        canvas.paste(img, ((canvas.size[0] - w) // 2, (canvas.size[1] - h) // 2))
        img, (w, h) = canvas, canvas.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def _random_resized_crop(img: Image.Image, size: int, rng: random.Random,
                         scale=(0.8, 1.1), ratio=(3 / 4, 4 / 3)) -> Image.Image:
    Image, _ = _pil()
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return img.crop((left, top, left + cw, top + ch)).resize(
                (size, size), Image.BILINEAR)
    # fallback: center crop at clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return img.crop((left, top, left + cw, top + ch)).resize((size, size), Image.BILINEAR)


def _random_affine(img: Image.Image, rng: random.Random, degrees=5.0,
                   scale=(0.85, 1.15), translate=(0.15, 0.15)) -> Image.Image:
    """torchvision RandomAffine analog: rotation+scale+translation about the
    image center, bilinear, zero fill."""
    Image, _ = _pil()
    angle = math.radians(rng.uniform(-degrees, degrees))
    s = rng.uniform(*scale)
    w, h = img.size
    tx = rng.uniform(-translate[0], translate[0]) * w
    ty = rng.uniform(-translate[1], translate[1]) * h
    cx, cy = w * 0.5, h * 0.5
    # inverse mapping (output -> input) for PIL transform
    cos_a, sin_a = math.cos(angle) / s, math.sin(angle) / s
    a, b = cos_a, sin_a
    c = cx - a * (cx + tx) - b * (cy + ty)
    d, e = -sin_a, cos_a
    f = cy - d * (cx + tx) - e * (cy + ty)
    return img.transform((w, h), Image.AFFINE, (a, b, c, d, e, f), Image.BILINEAR)


def _rand_augment(img: Image.Image, rng: random.Random) -> Image.Image:
    """Light RandAugment analog over PIL ops (2 ops, magnitude 9/30)."""
    Image, ImageOps = _pil()
    ops = [
        lambda im: ImageOps.autocontrast(im),
        lambda im: ImageOps.equalize(im),
        lambda im: im.rotate(rng.uniform(-9, 9), resample=Image.BILINEAR),
        lambda im: ImageOps.solarize(im, 256 - int(256 * 0.3)),
        lambda im: ImageOps.posterize(im, 6),
        lambda im: im.transform(im.size, Image.AFFINE,
                                (1, rng.uniform(-0.3, 0.3) * 0.3, 0, 0, 1, 0),
                                Image.BILINEAR),
    ]
    for op in rng.sample(ops, 2):
        img = op(img)
    return img


def to_tensor(img: Image.Image) -> np.ndarray:
    """PIL -> float32 [C, H, W] in [0,1] (torchvision ToTensor analog)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def transform_image(img: Image.Image, kind: str, size: int,
                    rng: Optional[random.Random] = None) -> np.ndarray:
    """Apply one of the reference transform stacks.

    Train kinds: random | resize | resize_crop | resize_affine_crop | randaug
    Eval kinds:  center | resize_eval | resize_crop | resize_larger
    """
    return to_tensor(_transform_pil(img, kind, size, rng))


def _transform_pil(img: Image.Image, kind: str, size: int,
                   rng: Optional[random.Random] = None,
                   after_prefix: bool = False) -> Image.Image:
    """``after_prefix``: the deterministic cacheable prefix (see _PREFIX —
    the fixed resize for resize_affine_crop) was already applied by the
    caller (the decoded-image LRU); keeping the one transform-order source
    of truth here prevents cold/warm path drift."""
    Image, _ = _pil()
    rng = rng or random
    if kind == "random":
        img = _random_resized_crop(img, size, rng)
    elif kind == "randaug":
        img = _rand_augment(img, rng)
        img = _random_resized_crop(img, size, rng)
    elif kind == "resize":
        img = _resize_shorter(img, size)
        img = _center_crop(img, size)
    elif kind in ("resize_crop", "resize_larger"):
        img = _resize_shorter(img, round(size * 1.142))
        img = _center_crop(img, size)
    elif kind == "resize_affine_crop":
        if not after_prefix:
            img = _resize_shorter(img, round(size * 1.142))
        img = _random_affine(img, rng)
        img = _center_crop(img, size)
    elif kind == "center":
        img = _resize_shorter(img, size)
        img = _center_crop(img, size)
    elif kind == "resize_eval":
        img = img.resize((size, size), Image.BILINEAR)
    else:
        raise ValueError(f"unknown image transform kind: {kind}")
    return img


# ---------------------------------------------------------------------------
# decoded-image cache: every transform stack starts with a deterministic
# prefix (jpeg decode + equalize, plus the fixed resize for the *_crop
# kinds; the fully deterministic eval kinds cache their final pixels).
# Caching that prefix as uint8 makes warm epochs pay only the random
# augment + crop + float scale instead of a full re-decode. Bounded LRU by
# byte budget; identical outputs (the cached stage is bit-exact).
# ---------------------------------------------------------------------------

# kind -> (prefix_tag, deterministic_resize, fully_deterministic)
_PREFIX = {
    "random": ("eq", False, False),
    "randaug": ("eq", False, False),
    "resize": ("full", False, True),
    "resize_crop": ("full", False, True),
    "resize_larger": ("full", False, True),
    "resize_affine_crop": ("rs", True, False),
    "center": ("full", False, True),
    "resize_eval": ("full", False, True),
}


class _LRUBytes:
    def __init__(self, budget_bytes: int):
        self.budget = budget_bytes
        self._d: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            arr = self._d.get(key)
            if arr is not None:
                self._d.move_to_end(key)
            return arr

    def put(self, key, arr: np.ndarray):
        with self._lock:
            if key in self._d:
                return
            self._d[key] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.budget and self._d:
                _, old = self._d.popitem(last=False)
                self._bytes -= old.nbytes


_CACHE: Optional[_LRUBytes] = _LRUBytes(256 * 2 ** 20)

# optional second level under the LRU (--image-cache-dir): the same
# deterministic uint8 prefix arrays persisted as .npy files, shared
# across worker PROCESSES and across runs — the cold first epoch of a
# fresh process only pays the jpeg decode once per image EVER instead of
# once per worker per run. Bit-exact (the cached stage is deterministic);
# writes are atomic (tmp + rename), concurrent writers race benignly.
_DISK_DIR: Optional[str] = None


def set_image_cache_dir(d: Optional[str]) -> None:
    global _DISK_DIR
    _DISK_DIR = d or None
    if _DISK_DIR:
        os.makedirs(_DISK_DIR, exist_ok=True)


def _disk_path(key) -> Optional[str]:
    if _DISK_DIR is None:
        return None
    import hashlib
    return os.path.join(
        _DISK_DIR, hashlib.sha1(repr(key).encode()).hexdigest() + ".npy")


def _disk_get(key) -> Optional[np.ndarray]:
    fn = _disk_path(key)
    if fn is None:
        return None
    try:
        return np.load(fn)
    except Exception:
        return None


def _disk_put(key, arr: np.ndarray) -> None:
    fn = _disk_path(key)
    if fn is None or os.path.exists(fn):
        return
    tmp = f"{fn}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.save(f, arr)
        os.replace(tmp, fn)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def set_image_cache_mb(mb: int) -> None:
    """Resize (or with 0, disable) the decoded-image LRU
    (--image-cache-mb). No-op when the budget is unchanged — dataset
    construction calls this per split/seed/checkpoint, and discarding a
    warm cache would re-decode every jpeg (3_test.py walks checkpoints,
    rebuilding the loader each time)."""
    global _CACHE
    budget = mb * 2 ** 20
    if _CACHE is not None and _CACHE.budget == budget:
        return
    if _CACHE is None and mb <= 0:
        return
    _CACHE = _LRUBytes(budget) if mb > 0 else None


def _decode_eq(path: str) -> Image.Image:
    Image, _ = _pil()
    with Image.open(path) as im:
        im.load()
        return equalize(im)


def load_cxr(path: str, kind: str, size: int,
             rng: Optional[random.Random] = None) -> np.ndarray:
    """Open + equalize + transform one CXR jpeg (dataset_new.py:700-702)."""
    Image, _ = _pil()
    if _CACHE is None:
        return transform_image(_decode_eq(path), kind, size, rng)
    tag, det_resize, fully_det = _PREFIX.get(kind, ("eq", False, False))
    key = (path, tag if tag != "full" else kind, size)
    cached = _CACHE.get(key)
    if cached is None:
        cached = _disk_get(key)
        if cached is not None:
            _CACHE.put(key, cached)
    if cached is not None:
        if fully_det:
            return to_tensor(Image.fromarray(cached))
        img = Image.fromarray(cached)   # post-prefix pixels (resize included)
    else:
        img = _decode_eq(path)
        if fully_det:
            img = _transform_pil(img, kind, size, rng)
            arr = np.asarray(img, dtype=np.uint8)
            _CACHE.put(key, arr)
            _disk_put(key, arr)
            return to_tensor(img)
        if det_resize:
            img = _resize_shorter(img, round(size * 1.142))
        arr = np.asarray(img, dtype=np.uint8)
        _CACHE.put(key, arr)
        _disk_put(key, arr)
    return to_tensor(_transform_pil(img, kind, size, rng,
                                    after_prefix=True))
