"""Classifier heads (counterpart of medical_tri_modal_pilot_tpu/models/
heads.py ``ClsHead`` and ``ClsHeadLN``; reference tri_mbt_vsltcls.py:147-158,
tri_mbt_v1.py:153-157)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .modules import LayerNorm


class ClsHead(nn.Sequential):
    """``fc_list``: Linear -> BatchNorm1d -> act -> Linear. Computes in
    ``dtype`` with the statistics in fp32, as flax's BatchNorm does. In eval
    mode the BatchNorm uses its running statistics (eps 1e-5); in training
    mode the batch's, as flax computes them (var = E[h^2] - E[h]^2, floored
    at 0), and it updates the running statistics as flax does: momentum
    0.9 and the biased batch variance (torch's BatchNorm1d would use 0.1
    and the unbiased one; the JAX package is the contract)."""

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
        if self.training:
            h = self._batch_norm_train(h.float(), bn).to(dt)
        else:
            h = F.batch_norm(h.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, training=False,
                             eps=bn.eps).to(dt)
        return F.linear(act(h), fc2.weight.to(dt), fc2.bias.to(dt))

    def _batch_norm_train(self, h, bn):
        """flax nn.BatchNorm(use_running_average=False) over the leading
        axes (normalization.py _compute_stats / _normalize)."""
        axes = tuple(range(h.dim() - 1))
        mean = h.mean(dim=axes)
        var = ((h * h).mean(dim=axes) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            bn.running_mean.mul_(m).add_((1.0 - m) * mean)
            bn.running_var.mul_(m).add_((1.0 - m) * var)
            bn.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (h - mean) * mul + bn.bias


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
