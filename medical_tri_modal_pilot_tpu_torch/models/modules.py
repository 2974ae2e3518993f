"""Transformer primitives in PyTorch, numerically faithful to the JAX
package's ``models/modules.py`` and so to the reference's nonstandard
details:

* ``StdLayerNorm`` divides by the Bessel-corrected standard deviation plus
  eps (not the variance plus eps);
* attention scores of masked keys are -65504, so a fully masked row
  softmaxes to uniform;
* ``MultiHeadAttention`` has no output projection;
* the FFN is the conv1x1 variant, stored as ``Conv1d`` weights [out, in, 1].

Parameters keep the reference's torch ``state_dict`` names, so
``medical_tri_modal_pilot_tpu/models/convert_ref.py`` maps them onto the
flax tree. Parameters are fp32; each module computes in its ``dtype``
(bf16 under ``--precision bf16``), casting weights at use as the JAX
modules do.

Dropout (training mode, p > 0) draws one seed per call from the
``DropoutSeeds`` of the running step, which the trainer passes down the
forward: the n-th dropout call of step k draws a seed mixed from (run
seed, k, n), so a resumed run draws the masks it would have drawn.
Every mask is Philox keyed by that seed (kernels/ffn.py), so the CPU and
the card draw the same ones.

Tensor parallelism (``--mp-size``): ``parallel.mesh.shard_model`` cuts the
q|k|v and FFN weights to a rank's columns and sets ``tp`` on the
attention and FFN modules, which then compute their share between the
mesh's collectives (the JAX package's layout under ``--mp-size > 1``,
where its fused attention block and FFN kernels are off).
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..constants import MASK_FILL_VALUE

from .. import ops
from ..kernels.ffn import BLOCK_R as FFN_BLOCK_R
from ..kernels.rowmm import BLOCK_R as ROWMM_BLOCK_R
from ..parallel.mesh import (copy_to_model, gather_from_model,
                             reduce_from_model)


_MASK64 = 2 ** 64 - 1


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class DropoutSeeds:
    """The dropout seeds of one step: call n draws a 63-bit seed mixed
    from (run seed, step, n)."""

    def __init__(self, run_seed: int, step: int):
        self.run_seed = int(run_seed)
        self.step = int(step)
        self.calls = 0

    def next(self) -> int:
        h = 0
        for word in (self.run_seed, self.step, self.calls):
            h = _splitmix64(h ^ (word & _MASK64))
        self.calls += 1
        return h >> 1


def draw_seed(seeds: Optional[DropoutSeeds]) -> int:
    """The next dropout seed of a training forward."""
    if seeds is None:
        raise RuntimeError(
            "dropout in training mode needs the step's DropoutSeeds: pass "
            "seeds to the forward (Trainer.train_step does)")
    return seeds.next()


def dropout(x: torch.Tensor, p: float, training: bool,
            seeds: Optional[DropoutSeeds]) -> torch.Tensor:
    """nn.Dropout's semantics as the JAX package writes them: keep with
    q = 1 - p, kept values divided by q in x's dtype. The mask is the FFN
    kernels' Philox output mask for the next seed over x's rows
    (``ops.dropout_masks``: the kernel on the card, its plain version on
    the CPU, the same bits on both)."""
    if not training or p == 0.0:
        return x
    C = x.shape[-1]
    _, keep = ops.dropout_masks(x.numel() // C, 0, C, draw_seed(seeds), p,
                                x.device)
    q = torch.tensor(1.0 - p, dtype=x.dtype, device=x.device)
    return torch.where(keep.reshape(x.shape), x / q, 0.0)


class LayerNorm(nn.LayerNorm):
    """torch's LayerNorm (eps 1e-5; flax's own default, 1e-6, where a
    module uses ``nn.LayerNorm`` itself), statistics in fp32, output in
    ``dtype`` (flax ``nn.LayerNorm(dtype=...)`` numerics)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__(dim, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def dense(lin: nn.Linear, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dt)``: x, the weight and the bias in dt."""
    bias = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


class StdLayerNorm(nn.Module):
    """(x - mean) / (std + eps) * gamma + beta, std with Bessel's
    correction (reference module.py:130-144)."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.compute_dtype = dtype

    def scales(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.gamma, self.beta

    def forward(self, x):
        return stdln_apply(x, self.gamma, self.beta, self.compute_dtype,
                           self.eps)


def stdln_apply(x, gamma, beta, dtype, eps: float = 1e-6):
    """StdLayerNorm math as a function; statistics in fp32, the variance
    floored at 1e-24 as in the JAX package."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    n = xf.shape[-1]
    var = ((xf - mean) ** 2).sum(dim=-1, keepdim=True) / (n - 1)
    std = torch.sqrt(var.clamp_min(1e-24))
    out = (xf - mean) / (std + eps) * gamma.float() + beta.float()
    return out.to(dtype)


@functools.lru_cache(maxsize=32)
def _pe_table(length: int, d_model: int) -> np.ndarray:
    # host-side numpy table, as in the JAX package
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(math.log(10000.0) / d_model)).astype(np.float32)
    angles = position * div_term
    pe = np.zeros((length, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(angles)
    pe[:, 1::2] = np.cos(angles)
    return pe[None]


def positional_encoding(length: int, d_model: int) -> torch.Tensor:
    """Sinusoidal table [1, length, d_model] fp32 (reference
    module.py:11-32)."""
    return torch.from_numpy(_pe_table(length, d_model).copy())


def length_key_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """bool [B, L]; True = key position masked (>= the sample's length)."""
    iota = torch.arange(max_len, device=lengths.device)[None, :]
    return iota >= lengths[:, None]


class ProjLinear(nn.Module):
    """The reference's ``Linear`` wrapper (state_dict key ``.linear``)."""

    def __init__(self, fin: int, fout: int):
        super().__init__()
        self.linear = nn.Linear(fin, fout)

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kernel [in, out], bias) in the JAX layout."""
        return self.linear.weight.t(), self.linear.bias


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.compute_dtype = dtype
        self.query_proj = ProjLinear(dim, dim)
        self.key_proj = ProjLinear(dim, dim)
        self.value_proj = ProjLinear(dim, dim)
        # the mesh, when shard_model cut q|k|v to this rank's heads
        self.tp = None

    def forward(self, query, key, value,
                key_mask: Optional[torch.Tensor] = None,
                prenorm: Optional[tuple] = None,
                residual: Optional[torch.Tensor] = None):
        """``prenorm``: optional (gamma, beta) StdLayerNorm scales applied
        here to the raw stream (query, key and value must then be one
        tensor). With ``residual is query`` as well, the whole block goes
        to the fused ``attn_block`` (kernel on CUDA). Otherwise the
        projections are plain products and the attention goes to
        ``ops.attention`` (kernel on CUDA), ``is_self`` when query is key.
        Under tensor parallelism (``tp`` set) a pre-norm call takes this
        rank's heads instead (``_tp_self_attention``): the JAX package's
        path on a mesh with --mp-size > 1, through the row-skipping
        LN-fused projection (kernels/rowmm.py) where the stream has row
        blocks. The pre-norm call without a residual has no caller on one
        device; there it keeps plain projections."""
        H = self.num_heads
        d_head = self.dim // H
        B, Lq, _ = query.shape
        Lk = key.shape[1]
        dt = self.compute_dtype
        (wq, bq), (wk, bk), (wv, bv) = (self.query_proj.weights(),
                                        self.key_proj.weights(),
                                        self.value_proj.weights())
        if prenorm is not None:
            if not (query is key and key is value):
                raise ValueError("prenorm requires query is key is value")
            gamma, beta = prenorm
            if self.tp is not None:
                return self._tp_self_attention(query, key_mask, gamma, beta,
                                               residual)
            if residual is query:
                wcat = torch.cat([wq, wk, wv], dim=1).to(dt)
                bcat = torch.cat([bq, bk, bv]).to(dt)
                return ops.attn_block(query.to(dt), gamma, beta, wcat, bcat,
                                      key_mask, math.sqrt(d_head), H)
            query = key = value = stdln_apply(query, gamma, beta, dt)
        q = query.to(dt) @ wq.to(dt) + bq.to(dt)
        k = key.to(dt) @ wk.to(dt) + bk.to(dt)
        v = value.to(dt) @ wv.to(dt) + bv.to(dt)
        ctx = ops.attention(
            q.reshape(B, Lq, H, d_head), k.reshape(B, Lk, H, d_head),
            v.reshape(B, Lk, H, d_head), key_mask, math.sqrt(d_head),
            is_self=query is key)
        out = ctx.reshape(B, Lq, self.dim)
        return out if residual is None else out + residual

    def _tp_self_attention(self, x, key_mask, gamma, beta, residual):
        """x + MHA(StdLN(x)) over this rank's heads (JAX modules.py:
        263-274 with the heads split over 'model'): the q|k|v of its
        columns, through ``ops.rowskip_ln_affine`` on a stream with
        256-row blocks (StdLN fused, dead blocks skipped) or StdLN and
        plain products otherwise; ``ops.attention`` on its heads; the
        heads gathered from the model group."""
        mesh = self.tp
        H = self.num_heads // mesh.mp
        d_head = self.dim // self.num_heads
        B, L, _ = x.shape
        dt = self.compute_dtype
        (wq, bq), (wk, bk), (wv, bv) = (self.query_proj.weights(),
                                        self.key_proj.weights(),
                                        self.value_proj.weights())
        blocks = ffn_row_blocks(x, key_mask, ROWMM_BLOCK_R)
        if blocks is not None:
            # StdLN runs inside the rank's projection, so its scales
            # enter the model group with x
            xr, gamma, beta = copy_to_model(mesh, x.to(dt), gamma, beta)
            wcat = torch.cat([wq, wk, wv], dim=1).to(dt)
            bcat = torch.cat([bq, bk, bv]).to(dt)
            q, k, v = ops.rowskip_ln_affine(xr, gamma, beta, wcat, bcat,
                                            blocks)
        else:
            ln, = copy_to_model(mesh, stdln_apply(x, gamma, beta, dt))
            q = ln @ wq.to(dt) + bq.to(dt)
            k = ln @ wk.to(dt) + bk.to(dt)
            v = ln @ wv.to(dt) + bv.to(dt)
        ctx = ops.attention(
            q.reshape(B, L, H, d_head), k.reshape(B, L, H, d_head),
            v.reshape(B, L, H, d_head), key_mask, math.sqrt(d_head),
            is_self=True)
        out = gather_from_model(mesh, ctx.reshape(B, L, H * d_head))
        return out if residual is None else out + residual


class FeedForward(nn.Module):
    """relu(W1 x) -> drop -> W2 -> drop, the reference's conv1x1 FFN
    (module.py:74-80), kept as ``Conv1d`` parameters [out, in, 1]."""

    def __init__(self, d_model: int, d_ff: int, dropout_p: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_1 = nn.Conv1d(d_model, d_ff, 1)
        self.w_2 = nn.Conv1d(d_ff, d_model, 1)
        self.dropout_p = dropout_p
        self.compute_dtype = dtype
        # the mesh, when shard_model cut d_ff to this rank's columns
        self.tp = None

    def weights(self):
        """(w1 [C, F], b1, w2 [F, C], b2) in the JAX layout."""
        return (self.w_1.weight[:, :, 0].t(), self.w_1.bias,
                self.w_2.weight[:, :, 0].t(), self.w_2.bias)

    def forward(self, x, seeds: Optional[DropoutSeeds] = None):
        """The unfused composition (the encoder layer runs the fused op
        instead); dropout when given ``seeds``, as the flax module's call
        with ``deterministic=False``."""
        w1, b1, w2, b2 = self.weights()
        dt = self.compute_dtype
        drop = seeds is not None
        h = torch.relu(x.to(dt) @ w1.to(dt) + b1.to(dt))
        h = dropout(h, self.dropout_p, drop, seeds)
        return dropout(h @ w2.to(dt) + b2.to(dt), self.dropout_p, drop,
                       seeds)


def ffn_row_blocks(x, key_mask, block: int = FFN_BLOCK_R
                   ) -> Optional[torch.Tensor]:
    """Per-tile validity flags for the fused FFN (and, with ``block`` =
    256, for the row-skipping projection): a tile of ``block`` consecutive
    rows (sample-major) is skippable when every row in it is a masked key.
    A sample whose keys are all masked attends uniformly over every real
    key, so its rows are read downstream and all its tiles stay live. None
    when the layout does not align to whole tiles or the mask is a block
    mask."""
    if key_mask is None or key_mask.dim() != 2 or x.dim() != 3:
        return None
    B, L, _ = x.shape
    if L % block != 0 or tuple(key_mask.shape) != (B, L):
        return None
    alive = torch.logical_not(key_mask).reshape(B, L // block, block)
    flags = alive.any(dim=-1)
    return flags | torch.logical_not(flags.any(dim=-1, keepdim=True))


class _DrawnSeeds:
    """Seeds drawn in advance, handed out in order: a checkpointed layer's
    forward and its recompute each get a fresh one over the same list, so
    both draw the same dropout masks."""

    def __init__(self, seeds: List[int]):
        self.seeds = seeds
        self.calls = 0

    def next(self) -> int:
        seed = self.seeds[self.calls]
        self.calls += 1
        return seed


class TransformerEncoderLayer(nn.Module):
    """Pre-norm block: StdLN -> MHA -> +res; StdLN -> FFN -> +res
    (encoder.py:8-34). Both halves go through the fused ops; dropout only
    in the FFN half, as in the JAX package.

    ``remat`` (``--remat 1``): a training forward that records gradients
    runs under ``torch.utils.checkpoint`` (non-reentrant), so the
    backward recomputes the layer instead of keeping its activations
    (JAX modules.py:437-459, ``nn.remat``). The layer's dropout seed (one,
    the FFN's) is drawn before the checkpointed call, at the place the
    layer draws it without remat, and given to both runs: the masks, and
    so the gradients, are those of ``remat`` off. The parameters and the
    state_dict do not change."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout_p: float = 0.1, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.attention_prenorm = StdLayerNorm(d_model, dtype=dtype)
        self.self_attention = MultiHeadAttention(d_model, num_heads, dtype)
        self.feed_forward_prenorm = StdLayerNorm(d_model, dtype=dtype)
        self.feed_forward = FeedForward(d_model, d_ff, dropout_p, dtype)
        self.remat = remat

    def forward(self, x, key_mask: Optional[torch.Tensor] = None,
                seeds: Optional[DropoutSeeds] = None):
        """``seeds``: the step's dropout seeds (training mode)."""
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return self._forward(x, key_mask, seeds)
        drawn = ([draw_seed(seeds)] if self.feed_forward.dropout_p > 0.0
                 else [])
        return torch.utils.checkpoint.checkpoint(
            lambda h: self._forward(h, key_mask, _DrawnSeeds(drawn)), x,
            use_reentrant=False)

    def _forward(self, x, key_mask, seeds):
        x = self.self_attention(x, x, x, key_mask,
                                prenorm=self.attention_prenorm.scales(),
                                residual=x)
        return ffn_block(self, x, key_mask, seeds)


def ffn_block(layer: nn.Module, x, key_mask=None,
              seeds: Optional[DropoutSeeds] = None):
    """x + FFN(StdLN(x)) through the fused op, with row-tile skipping and,
    in training mode, in-kernel dropout on a seed of its own (JAX
    modules.py:408-434). The fp32 weights reach the op as they are, so
    their gradients come back in fp32."""
    gamma, beta = layer.feed_forward_prenorm.scales()
    ff = layer.feed_forward
    w1, b1, w2, b2 = ff.weights()
    training = layer.training and ff.dropout_p > 0.0
    if ff.tp is not None:
        return _tp_ffn(ff, x, gamma, beta, training, seeds)
    return ops.ffn(x, gamma, beta, w1, b1, w2, b2,
                   block_valid=ffn_row_blocks(x, key_mask), p=ff.dropout_p,
                   training=training,
                   seed=draw_seed(seeds) if training else None)


def _tp_ffn(ff: FeedForward, x, gamma, beta, training: bool,
            seeds: Optional[DropoutSeeds]):
    """x + drop(W2 drop(relu(W1 StdLN(x) + b1)) + b2) over this rank's
    d_ff columns: StdLN on the whole stream, then a column-parallel W1 and
    a row-parallel W2 between copy_to_model and reduce_from_model (the JAX
    package's plain FFN under SPMD, --mp-size > 1). The partial W2 product
    stays fp32 through the sum and b2 is added once after it, so the
    rounding is the single device's. Dropout draws the step's next seed on
    every rank alike: the hidden mask is this rank's columns of the whole
    one (``col0``), the output mask the whole one, so the masks are the
    single-device FFN's."""
    mesh = ff.tp
    w1, b1, w2, b2 = ff.weights()
    dt = ff.compute_dtype
    ln, = copy_to_model(mesh, stdln_apply(x, gamma, beta, dt))
    h = torch.relu(ln @ w1.to(dt) + b1.to(dt))
    if training:
        p = ff.dropout_p
        F_loc, C = h.shape[-1], x.shape[-1]
        keep_h, keep_z = ops.dropout_masks(
            h.numel() // F_loc, F_loc, C, draw_seed(seeds), p, x.device,
            col0=mesh.model_index * F_loc)
        q = torch.tensor(1.0 - p, dtype=dt, device=x.device)
        h = torch.where(keep_h.reshape(h.shape), h / q, 0.0)
    z = reduce_from_model(mesh, h.float() @ w2.to(dt).float())
    z = z.to(dt) + b2.to(dt)
    if training:
        z = torch.where(keep_z.reshape(z.shape), z / q, 0.0)
    return x + z


class CrossmodalTransformerEncoderLayer(nn.Module):
    """q/kv pre-norm cross-attention block (JAX modules.py:462-478,
    reference encoder.py:251-278): x = q_in + MHA(StdLN_q(q_in),
    StdLN_kv(kv_in)) with the key mask of the kv stream, then the FFN half
    over every row (no row skipping)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout_p: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention_prenorm_q = StdLayerNorm(d_model, dtype=dtype)
        self.attention_prenorm_kv = StdLayerNorm(d_model, dtype=dtype)
        self.self_attention = MultiHeadAttention(d_model, num_heads, dtype)
        self.feed_forward_prenorm = StdLayerNorm(d_model, dtype=dtype)
        self.feed_forward = FeedForward(d_model, d_ff, dropout_p, dtype)

    def forward(self, q_in, kv_in, key_mask: Optional[torch.Tensor] = None,
                seeds: Optional[DropoutSeeds] = None):
        """``seeds``: the step's dropout seeds (training mode)."""
        q = self.attention_prenorm_q(q_in)
        kv = self.attention_prenorm_kv(kv_in)
        x = q_in + self.self_attention(q, kv, kv, key_mask)
        return ffn_block(self, x, None, seeds)


class MLPStem(nn.Sequential):
    """Linear -> LayerNorm -> ReLU, the UMSE stem (tri_mbt_vsltcls.py:61-76),
    computed in ``dtype``."""

    def __init__(self, fin: int, d_model: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Linear(fin, d_model), LayerNorm(d_model, dtype),
                         nn.ReLU())
        self.compute_dtype = dtype

    def forward(self, x):
        lin = self[0]
        dt = self.compute_dtype
        h = F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
        return torch.relu(self[1](h))
