"""Weight-gradient reduction shared by the fusion layers' backward kernels
(``csrc/wgrad.cu``): dW = A^T B over all rows with fp32 accumulation and
db = the column sums of B, in split-K slices summed in a fixed order; and
the fixed-order sum of per-tile partials. bf16 operands take the
tensor-core form; fp32 (the checking dtype) the FMA form, whose products
stay in full fp32. CUDA tensors only:
on the CPU the backward is autograd of the plain versions."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._util import dtype_code, stream

# blocks to aim for: four per SM of an H100's 132
TARGET_BLOCKS = 4 * 132
# rows per staged chunk of the tensor-core form (kWgRows of csrc/wgrad.cu):
# slices start, and row flags cover, whole chunks
CHUNK_ROWS = 64
def slicing(R: int, Ka: int, Nb: int) -> Tuple[int, int]:
    """(rows per slice, slices): enough slices that the grid has about
    TARGET_BLOCKS blocks, each slice a whole number of CHUNK_ROWS rows."""
    tiles = -(-Ka // 64) * -(-Nb // 64)
    slices = max(1, min(-(-TARGET_BLOCKS // tiles), -(-R // 256)))
    rows = -(-R // slices)
    rows = -(-rows // CHUNK_ROWS) * CHUNK_ROWS
    return rows, max(1, -(-R // rows))


def col_sum(part: torch.Tensor) -> torch.Tensor:
    """fp32 [S, N] -> [N], summed over S in order."""
    S, N = part.shape
    out = torch.empty(N, dtype=torch.float32, device=part.device)
    rc = _build.library().col_sum(part.data_ptr(), S, N, out.data_ptr(),
                                  stream(part))
    _build.check(rc, "col_sum")
    return out


def wgrad(a: torch.Tensor, b, valid: Optional[torch.Tensor] = None,
          flag_rows: Optional[int] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [R, Ka], b [R, Nb], contiguous, one dtype, Ka and Nb multiples
    of 32 -> (a^T b fp32 [Ka, Nb], b.sum(0) fp32 [Nb]). ``b`` may also be
    a sequence of up to three
    [R, Cs] arrays (Cs % 64 == 0) whose columns are b's, in order: one
    launch for the q, k and v cotangents. ``valid``: optional int8 flags on
    a's device, one per ``flag_rows`` consecutive rows (a multiple of
    CHUNK_ROWS: the FFN's 64-row tiles, rowmm's 256-row blocks); rows under
    a 0 flag are left out of both sums and not read, so they may hold
    anything."""
    bs = list(b) if isinstance(b, (list, tuple)) else [b]
    R, Ka = a.shape
    Bcs = bs[0].shape[1]
    Nb = Bcs * len(bs)
    if len(bs) > 3 or any(t.shape != (R, Bcs) or t.dtype != a.dtype
                          for t in bs):
        raise ValueError(f"wgrad operands {tuple(a.shape)} {a.dtype} and "
                         f"{[(tuple(t.shape), t.dtype) for t in bs]} do not "
                         f"match")
    if len(bs) > 1 and Bcs % 64:
        raise ValueError(f"wgrad takes parts of b whose widths are multiples "
                         f"of 64, got {Bcs}")
    if Ka % 32 or Bcs % 32 or not Ka or not Bcs:
        raise ValueError(f"wgrad takes widths that are multiples of 32, got "
                         f"{Ka} and {Bcs}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wgrad takes fp32 or bf16, got {a.dtype}")
    if valid is not None:
        if flag_rows is None or flag_rows % CHUNK_ROWS:
            raise ValueError(f"wgrad row flags must cover a multiple of "
                             f"{CHUNK_ROWS} rows each, got {flag_rows}")
        if valid.numel() != -(-R // flag_rows):
            raise ValueError(f"wgrad has {valid.numel()} flags for {R} rows "
                             f"in blocks of {flag_rows}")
    rows, slices = slicing(R, Ka, Nb)
    part = torch.empty(slices, Ka * Nb, dtype=torch.float32, device=a.device)
    colpart = torch.empty(slices, Nb, dtype=torch.float32, device=a.device)
    ptrs = [t.data_ptr() for t in bs] + [None] * (3 - len(bs))
    rc = _build.library().wgrad_partials(
        a.data_ptr(), *ptrs, R, Ka, Nb, Bcs, rows, slices,
        part.data_ptr(), colpart.data_ptr(),
        None if valid is None else valid.data_ptr(),
        flag_rows or CHUNK_ROWS, dtype_code(a.dtype), stream(a))
    _build.check(rc, "wgrad")
    return col_sum(part).reshape(Ka, Nb), col_sum(colpart)
