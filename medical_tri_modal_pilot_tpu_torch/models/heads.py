"""Classifier heads (counterpart of medical_tri_modal_pilot_tpu/models/
heads.py ``ClsHead`` and ``ClsHeadLN``; reference tri_mbt_vsltcls.py:147-158,
tri_mbt_v1.py:153-157)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import data_parallel, data_sum
from .modules import LayerNorm


def batch_moments(bn: nn.Module, h: torch.Tensor, axes: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(E[h], E[h^2]) of fp32 h over ``axes``, the channels left. Under
    data parallelism (the mesh in ``bn.dp``, ``parallel.mesh.
    mark_data_parallel``) over the global batch: [sum h, sum h^2] summed
    over the data group and divided by the global count, the sums'
    gradients summed back (SyncBatchNorm's statistics, in flax's form)."""
    mesh = getattr(bn, "dp", None)
    if not data_parallel(mesh):
        return h.mean(dim=axes), (h * h).mean(dim=axes)
    sums = data_sum(mesh, torch.stack([h.sum(dim=axes),
                                       (h * h).sum(dim=axes)]))
    n = h.numel() // sums.shape[1] * mesh.dp      # equal shards
    return sums[0] / n, sums[1] / n


def flax_batch_norm(h: torch.Tensor, bn: nn.BatchNorm1d, training: bool,
                    momentum: float) -> torch.Tensor:
    """flax ``nn.BatchNorm`` over the last axis of h [..., D] (statistics
    over every leading axis), in fp32, with ``bn``'s parameters and running
    statistics. Eval: the running statistics. Training: the batch's, as
    flax computes them (normalization.py _compute_stats / _normalize: var
    = E[h^2] - E[h]^2, floored at 0), and the running statistics updated
    with ``momentum`` and the biased batch variance (torch's BatchNorm1d
    would use 1 - momentum and the unbiased one; the JAX package is the
    contract). Under data parallelism the batch is the global one
    (``batch_moments``), as the JAX package's global arrays make it, and
    every rank moves its running statistics alike."""
    h = h.float()
    if not training:
        D = h.shape[-1]
        return F.batch_norm(h.reshape(-1, D), bn.running_mean,
                            bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps).reshape(h.shape)
    mean, msq = batch_moments(bn, h, tuple(range(h.dim() - 1)))
    var = (msq - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_((1.0 - momentum) * mean)
        bn.running_var.mul_(momentum).add_((1.0 - momentum) * var)
        bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (h - mean) * mul + bn.bias


class ClsHead(nn.Sequential):
    """``fc_list``: Linear -> BatchNorm1d -> act -> Linear over [..., d_in]
    (``tri_mbt_v2`` runs it over the stacked [M, B, d_in] cls vectors).
    Computes in ``dtype`` with the statistics in fp32, as flax's BatchNorm
    does (``flax_batch_norm`` at the head's momentum 0.9, eps 1e-5)."""

    MOMENTUM = 0.9

    def __init__(self, d_in: int, d_model: int, output_dim: int = 1,
                 activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        act = nn.ReLU() if activation == "relu" else nn.SELU()
        super().__init__(nn.Linear(d_in, d_model),
                         nn.BatchNorm1d(d_model, eps=1e-5), act,
                         nn.Linear(d_model, output_dim))
        self.compute_dtype = dtype

    def forward(self, x):
        fc1, bn, act, fc2 = self
        dt = self.compute_dtype
        h = F.linear(x.to(dt), fc1.weight.to(dt), fc1.bias.to(dt))
        h = flax_batch_norm(h, bn, self.training, self.MOMENTUM).to(dt)
        return F.linear(act(h), fc2.weight.to(dt), fc2.bias.to(dt))


class ClsHeadLN(nn.Sequential):
    """``fc_list`` with a LayerNorm in place of the BatchNorm: Linear ->
    LayerNorm -> act -> Linear (JAX heads.py:40-53), computed in
    ``dtype``. Applies to [..., d_in] (tri_mbt_v1 runs it over the
    stacked [M, B, d_in] cls vectors)."""

    def __init__(self, d_in: int, d_model: int, output_dim: int = 1,
                 activation: str = "relu",
                 dtype: torch.dtype = torch.float32):
        act = nn.ReLU() if activation == "relu" else nn.SELU()
        super().__init__(nn.Linear(d_in, d_model), LayerNorm(d_model, dtype),
                         act, nn.Linear(d_model, output_dim))
        self.compute_dtype = dtype

    def forward(self, x):
        fc1, ln, act, fc2 = self
        dt = self.compute_dtype
        h = F.linear(x.to(dt), fc1.weight.to(dt), fc1.bias.to(dt))
        return F.linear(act(ln(h)), fc2.weight.to(dt), fc2.bias.to(dt))
