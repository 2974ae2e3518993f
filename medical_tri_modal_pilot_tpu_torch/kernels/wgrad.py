"""Weight-gradient reduction shared by the fusion layers' backward kernels
(``csrc/wgrad.cu``): dW = A^T B over all rows with fp32 accumulation and
db = the column sums of B, in split-K slices summed in a fixed order; and
the fixed-order sum of per-tile partials. CUDA tensors only: on the CPU
the backward is autograd of the plain versions."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from ._util import dtype_code, stream

# blocks to aim for: four per SM of an H100's 132
TARGET_BLOCKS = 4 * 132


def col_sum(part: torch.Tensor) -> torch.Tensor:
    """fp32 [S, N] -> [N], summed over S in order."""
    S, N = part.shape
    out = torch.empty(N, dtype=torch.float32, device=part.device)
    rc = _build.library().col_sum(part.data_ptr(), S, N, out.data_ptr(),
                                  stream(part))
    _build.check(rc, "col_sum")
    return out


def wgrad(a: torch.Tensor, b: torch.Tensor,
          valid: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a [R, Ka], b [R, Nb], contiguous, one dtype -> (a^T b fp32 [Ka, Nb],
    b.sum(0) fp32 [Nb]). ``valid``: optional int8 flags on a's device, one
    per 256 consecutive rows (``kBlockR`` of csrc/common.cuh, rowmm's
    BLOCK_R); rows under a 0 flag are left out of both sums (and not
    read)."""
    R, Ka = a.shape
    Nb = b.shape[1]
    if b.shape[0] != R or a.dtype != b.dtype:
        raise ValueError(f"wgrad operands {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype} do not match")
    if Ka % 64 or Nb % 64:
        raise ValueError(f"wgrad takes widths that are multiples of 64, got "
                         f"{Ka} and {Nb}")
    tiles = (Ka // 64) * (Nb // 64)
    slices = max(1, min(-(-TARGET_BLOCKS // tiles), -(-R // 256)))
    rows = -(-R // slices)
    rows = -(-rows // 32) * 32
    slices = max(1, -(-R // rows))
    part = torch.empty(slices, Ka * Nb, dtype=torch.float32, device=a.device)
    colpart = torch.empty(slices, Nb, dtype=torch.float32, device=a.device)
    rc = _build.library().wgrad_partials(
        a.data_ptr(), b.data_ptr(), R, Ka, Nb, rows, slices,
        part.data_ptr(), colpart.data_ptr(),
        None if valid is None else valid.data_ptr(), dtype_code(a.dtype),
        stream(a))
    _build.check(rc, "wgrad")
    return col_sum(part).reshape(Ka, Nb), col_sum(colpart)
