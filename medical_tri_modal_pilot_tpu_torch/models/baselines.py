"""The carryforward helpers the legacy and baseline families share
(counterpart of medical_tri_modal_pilot_tpu/models/baselines.py:31-43).
The baseline models themselves (GRU-D, LSTM, MedFuse, MMTM, DAFT) are not
ported yet (ROADMAP Queue 1 item 7)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _unpack_carryforward(batch: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """batch['vslt'] is [B, 3, T, F] (data, mask, delta)."""
    v = batch["vslt"]
    return v[:, 0], v[:, 1], v[:, 2]


def _with_demo(x: torch.Tensor, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """Append age and gender as constant channels (fusiontrainer.py:86-88):
    [B, T, F] -> [B, T, F + 2]."""
    B, T, _ = x.shape
    static = batch["static"].to(x.dtype)
    age = static[:, 1][:, None, None].expand(B, T, 1)
    gen = static[:, 0][:, None, None].expand(B, T, 1)
    return torch.cat([x, age, gen], dim=-1)
