"""Modality-aware bottleneck fusion (counterpart of
medical_tri_modal_pilot_tpu/models/mbt.py:42-187, ``MBTFusion``).

Missing-modality handling is the JAX package's formulation: per-sample
mixing weights over modalities come from a one-hot of ``missing_num``
times a constant candidate matrix, and the new bottlenecks are that mix of
each stream's bottleneck outputs. Quirks kept: a text length of 3
(BOS/EOS-only note) becomes 0, so the whole text stream is masked;
bottleneck key masks run over ``vlen + n`` of the concatenated sequence;
``vsltonly`` skips the other streams and the mix in the last layer;
``resbottle`` averages the new bottlenecks with the previous ones.
``remat`` checkpoints every encoder layer (``--remat 1``).

Long masked streams are padded so [bottlenecks | cls | tokens] is a
multiple of 256 rows, as in the JAX package; the padded rows are masked
keys, so the logits do not depend on it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .modules import (DropoutSeeds, LayerNorm, TransformerEncoderLayer,
                      length_key_mask, positional_encoding)
from .modules import dropout as apply_dropout


def missing_candidate_weights(n_modality: int) -> np.ndarray:
    if n_modality == 3:
        return np.array([
            [1 / 3, 1 / 3, 1 / 3],   # 0: tri mean
            [1 / 2, 1 / 2, 0.0],     # 1: vslt + img
            [1 / 2, 0.0, 1 / 2],     # 2: vslt + txt
            [1.0, 0.0, 0.0],         # 3: vslt only
        ], dtype=np.float32)
    if n_modality == 2:
        return np.array([
            [1 / 2, 1 / 2],          # 0: both
            [1.0, 0.0],              # 1: vslt only
        ], dtype=np.float32)
    raise ValueError(f"n_modality must be 2 or 3, got {n_modality}")


class MBTFusion(nn.Module):
    """Bi/tri-modal bottleneck fusion (TrimodalTransformerEncoder_MBT /
    BimodalTransformerEncoder_MBT, mbt_encoder.py:519-784)."""

    def __init__(self, n_modality: int, bottlenecks_n: int = 4,
                 fusion_startidx: int = 0, n_layers: int = 6,
                 n_head: int = 4, d_model: int = 256, d_ff: int = 1024,
                 dropout: float = 0.1, pe_maxlen: int = 2500,
                 txt_idx: int = 2, vsltonly: int = 0,
                 resbottle: bool = False,
                 use_pe: Tuple[bool, ...] = (False, False, True),
                 mask: Tuple[bool, ...] = (True, False, True),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        M = n_modality
        self.n_modality = M
        self.bottlenecks_n = bottlenecks_n
        self.fusion_startidx = fusion_startidx
        self.n_layers = n_layers
        self.d_model = d_model
        self.dropout = dropout
        self.txt_idx = txt_idx
        self.vsltonly = vsltonly
        self.resbottle = resbottle
        self.use_pe = tuple(use_pe)
        self.mask = tuple(mask)
        self.compute_dtype = dtype
        self.bottlenecks = nn.Parameter(torch.zeros(1, bottlenecks_n,
                                                    d_model))
        self.cls_token_per_modality = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, 1, d_model)) for _ in range(M)])
        self.layer_norms_in = nn.ModuleList(
            [LayerNorm(d_model, dtype) for _ in range(M)])
        self.layer_stacks = nn.ModuleList()
        for layer in range(n_layers):
            mods = 1 if (vsltonly == 1 and layer == n_layers - 1) else M
            self.layer_stacks.append(nn.ModuleList(
                [TransformerEncoderLayer(d_model, n_head, d_ff, dropout,
                                         dtype, remat)
                 for _ in range(mods)]))
        self.register_buffer("pe", positional_encoding(pe_maxlen, d_model),
                             persistent=False)
        self.register_buffer(
            "candidates", torch.from_numpy(missing_candidate_weights(M)),
            persistent=False)

    def forward(self, enc_inputs: Sequence[torch.Tensor],
                varying_lengths: Sequence[torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> List[torch.Tensor]:
        """enc_inputs[m]: [B, L_m, D] (no cls yet); varying_lengths[m]: [B]
        int; missing_num: [B] int in [0, n_candidates); seeds: the step's
        dropout seeds (training mode). Returns per-modality
        [B, 1+L_m(+pad), D] with cls at position 0."""
        M = self.n_modality
        n = self.bottlenecks_n
        D = self.d_model
        dt = self.compute_dtype
        B = enc_inputs[0].shape[0]

        xs, key_masks, b_key_masks = [], [], []
        for m in range(M):
            cls = self.cls_token_per_modality[m].expand(B, 1, D).to(dt)
            x = torch.cat([cls, enc_inputs[m].to(dt)], dim=1)
            if self.mask[m] and x.shape[1] + n > 512:
                tgt = -(-(x.shape[1] + n) // 256) * 256
                x = F.pad(x, (0, 0, 0, tgt - n - x.shape[1]))
            L = x.shape[1]
            vlen = varying_lengths[m].long() + 1
            if m == self.txt_idx:
                vlen = torch.where(vlen == 3, 0, vlen)
            if self.mask[m]:
                key_masks.append(length_key_mask(vlen, L))
                b_key_masks.append(length_key_mask(vlen + n, L + n))
            else:
                key_masks.append(None)
                b_key_masks.append(None)
            h = self.layer_norms_in[m](x)
            if self.use_pe[m]:
                h = h + self.pe[:, :L].to(dt)
            xs.append(apply_dropout(h, self.dropout, self.training, seeds))

        onehot = F.one_hot(missing_num.long(), self.candidates.shape[0])
        mix = onehot.float() @ self.candidates                   # [B, M]
        bottlenecks = self.bottlenecks.expand(B, n, D).to(dt)

        # from the first fusion layer on, each stream carries the
        # bottleneck rows in front; later layers replace them out of place
        # (the stream is a saved input of the previous layer's backward)
        in_fusion = False
        for layer in range(self.n_layers):
            stack = self.layer_stacks[layer]
            if layer < self.fusion_startidx:
                xs = [stack[m](xs[m], key_masks[m], seeds) for m in range(M)]
                continue
            if not in_fusion:
                xs = [torch.cat([bottlenecks, x], dim=1) for x in xs]
                in_fusion = True
            else:
                xs = [torch.cat([bottlenecks.to(x.dtype), x[:, n:]], dim=1)
                      for x in xs]
            last_layer = layer == self.n_layers - 1
            new_xs, bn_outs = [], []
            for m in range(M):
                if self.vsltonly == 1 and last_layer and m > 0:
                    new_xs.append(xs[m])
                    continue
                out = stack[m](xs[m], b_key_masks[m], seeds)
                bn_outs.append(out[:, :n])
                new_xs.append(out)
            xs = new_xs
            if self.vsltonly == 1 and last_layer:
                break
            outs = torch.stack(bn_outs)                          # [M, B, n, D]
            mixed = torch.einsum("bm,mbnd->bnd", mix.to(outs.dtype), outs)
            if self.resbottle:
                mixed = (mixed + bottlenecks) / 2.0
            bottlenecks = mixed
        return [x[:, n:] for x in xs] if in_fusion else xs


# ---------------------------------------------------------------------------
# The multitoken MBT family (JAX models/mbt.py:383-676)
# ---------------------------------------------------------------------------

# bottleneck groups: 0 = vit, 1 = vi, 2 = vt, 3 = it; each stream carries
# three of them, in this order (mbt_encoder.py:380)
GROUPS_PER_MODALITY = ((0, 1, 2), (0, 1, 3), (0, 2, 3))

# the streams that contribute to each group, in stream order
_GROUP_CONTRIBUTORS = ((0, 1, 2), (0, 1), (0, 2), (1, 2))

# per group and missing case, the contributors (indices into the group's
# list) whose outputs are averaged (mbt_encoder.py:427-430)
_GROUP_CASE_SUBSETS = (
    ((0, 1, 2), (0, 1), (0, 2), (0,)),   # group vit
    ((0, 1), (0, 1), (0,), (0,)),        # group vi
    ((0, 1), (0,), (0, 1), (0,)),        # group vt (case 3: the vslt one)
    ((0, 1), (0,), (1,), (0,)),          # group it (case 3 unused)
)


def _group_case_weights() -> np.ndarray:
    """[G, 4 cases, max_contrib] mean weights over each group's
    contributors."""
    W = np.zeros((4, 4, 3), dtype=np.float32)
    for g, cases in enumerate(_GROUP_CASE_SUBSETS):
        for c, subset in enumerate(cases):
            for i in subset:
                W[g, c, i] = 1.0 / len(subset)
    return W


def _block_mask_vslt(n: int) -> np.ndarray:
    """The 16 x 16 block over [3 bottleneck groups | 4 cls] of the vslt
    stream (mbt_encoder.py:381-396). True = masked."""
    assert n == 4, "reference block masks are hand-built for bottlenecks_n=4"
    m = np.zeros((16, 16))
    m[:16, :16] = 1
    for s in range(3):
        m[4 * s:4 * (s + 1), 4 * s:4 * (s + 1)] = 0
    for c in range(4):
        m[12 + c, 12 + c] = 0
    for c, s in ((12, 0), (13, 1), (14, 2)):
        m[c, 4 * s:4 * (s + 1)] = 0
        m[4 * s:4 * (s + 1), c] = 0
    return m >= 0.5


def _block_mask_imgtxt(L_total: int, n: int) -> np.ndarray:
    """The whole-sequence mask of the img and txt streams
    (mbt_encoder.py:398-422). The hand pattern covers the first 16
    positions though those streams hold 12 bottlenecks and 2 cls tokens, so
    the first two content tokens are masked against all of them (the
    reference's quirk, kept)."""
    assert n == 4
    m = np.zeros((L_total, L_total))
    m[:16, :16] = 1
    for s in range(3):
        m[4 * s:4 * (s + 1), 4 * s:4 * (s + 1)] = 0
    m[12, 12] = 0
    m[13, 13] = 0
    m[12, :4] = 0
    m[:4, 12] = 0
    m[13, 4:8] = 0
    m[4:8, 13] = 0
    return m >= 0.5


def _block_mask_groups12(n: int) -> np.ndarray:
    """The 12 x 12 group-diagonal block of the img and txt streams in the
    VSLTMAIN variant (mbt_encoder.py:81-93)."""
    m = np.ones((3 * n, 3 * n))
    for s in range(3):
        m[n * s:n * (s + 1), n * s:n * (s + 1)] = 0
    return m >= 0.5


def block_key_mask(vlen: torch.Tensor, L: int, n: int, stream: int,
                   vslt_main: bool = False) -> torch.Tensor:
    """The block mask of a multitoken stream behind its 3 n bottleneck rows:
    bool [B, L + 3n, L + 3n], True = masked. Every query masks the keys at
    or past ``vlen + 3n``; then the hand pattern over the first rows and
    keys: the vslt stream's 16 x 16 block set in (stream 0); the img and
    txt streams' 16 x 16 pattern or-ed in, or under ``vslt_main`` their
    12 x 12 group-diagonal block set in (JAX models/mbt.py:496-509,
    :607-621). ``vlen``: [B] valid rows of the stream (cls included)."""
    B, Lb = vlen.shape[0], L + 3 * n
    full = length_key_mask(vlen + 3 * n, Lb)[:, None, :].expand(
        B, Lb, Lb).clone()
    if stream == 0:
        pattern, merge = _block_mask_vslt(n), False
    elif vslt_main:
        pattern, merge = _block_mask_groups12(n), False
    else:
        pattern, merge = _block_mask_imgtxt(16, n), True
    k = min(Lb, pattern.shape[0])
    block = torch.from_numpy(pattern[:k, :k]).to(full.device)
    if merge:
        full[:, :k, :k] |= block
    else:
        full[:, :k, :k] = block
    return full


class _MultitokenFusion(nn.Module):
    """What the two multitoken fusions share: per stream an input
    LayerNorm (torch's, not StdLN: mbt_encoder.py:683), the positional
    encoding where ``use_pe`` says, the input dropout, and per layer and
    stream an encoder layer over [3 bottleneck groups | stream]; between
    fusion layers each group becomes the missing-aware mean of its
    contributors' outputs (a one-hot of ``missing_num`` times the constant
    ``case_w``, in fp32). Each stream's block mask [B, L + 12, L + 12]
    (``block_key_mask``) is built once per forward on the device and read
    by every layer as it is."""

    # the img and txt streams' hand pattern: the 12 x 12 group-diagonal
    # block (VSLTMAIN) or the 16 x 16 pattern
    VSLT_MAIN = False

    def __init__(self, n_modality: int = 3, bottlenecks_n: int = 4,
                 fusion_startidx: int = 0, n_layers: int = 6,
                 n_head: int = 4, d_model: int = 256, d_ff: int = 1024,
                 dropout: float = 0.1, pe_maxlen: int = 2500,
                 txt_idx: int = 2,
                 use_pe: Tuple[bool, ...] = (False, False, True),
                 mask: Tuple[bool, ...] = (True, True, True),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if n_modality != 3:
            raise ValueError(f"the multitoken fusion takes 3 streams, got "
                             f"{n_modality}")
        self.n_modality = n_modality
        self.bottlenecks_n = bottlenecks_n
        self.fusion_startidx = fusion_startidx
        self.n_layers = n_layers
        self.d_model = d_model
        self.dropout = dropout
        self.txt_idx = txt_idx
        self.use_pe = tuple(use_pe)
        self.mask = tuple(mask)
        self.compute_dtype = dtype
        self.layer_norms_in = nn.ModuleList(
            [LayerNorm(d_model, dtype) for _ in range(n_modality)])
        self.layer_stacks = nn.ModuleList(
            nn.ModuleList(TransformerEncoderLayer(d_model, n_head, d_ff,
                                                  dropout, dtype, remat)
                          for _ in range(n_modality))
            for _ in range(n_layers))
        self.register_buffer("pe", positional_encoding(pe_maxlen, d_model),
                             persistent=False)
        self.register_buffer("case_w",
                             torch.from_numpy(_group_case_weights()),
                             persistent=False)
        # the hand-built blocks assert bottlenecks_n == 4
        _block_mask_vslt(bottlenecks_n)

    def _stream(self, m: int, x: torch.Tensor, vlen: torch.Tensor,
                seeds: Optional[DropoutSeeds]):
        """(the stream after its input LayerNorm, PE and dropout; its key
        mask [B, L] for layers before fusion; its block mask for the
        fusion layers)."""
        L = x.shape[1]
        n = self.bottlenecks_n
        dt = self.compute_dtype
        if m == self.txt_idx:
            vlen = torch.where(vlen == 3, 0, vlen)
        plain = block = None
        if self.mask[m]:
            plain = length_key_mask(vlen, L)
            block = block_key_mask(vlen, L, n, m, self.VSLT_MAIN)
        h = self.layer_norms_in[m](x)
        if self.use_pe[m]:
            h = h + self.pe[:, :L].to(dt)
        return apply_dropout(h, self.dropout, self.training, seeds), plain, \
            block

    def _cls_tokens(self, m: int) -> Optional[torch.Tensor]:
        """Stream m's cls tokens [1, c, D], or None."""
        raise NotImplementedError

    def _first_bottlenecks(self, m: int, B: int) -> List[torch.Tensor]:
        """The three [B, n, D] bottleneck slots of stream m at the first
        fusion layer, in the compute dtype."""
        raise NotImplementedError

    def forward(self, enc_inputs: Sequence[torch.Tensor],
                varying_lengths: Sequence[torch.Tensor],
                missing_num: torch.Tensor,
                seeds: Optional[DropoutSeeds] = None) -> List[torch.Tensor]:
        """enc_inputs[m]: [B, L_m, D] (no cls yet); varying_lengths[m]: [B]
        int; missing_num: [B] in [0, 4); seeds: the step's dropout seeds
        (training mode). Returns per stream [B, cls + L_m, D], its cls
        tokens, where it has them, first. The layers: before
        ``fusion_startidx`` each stream alone under its key mask; then each
        stream behind its three bottleneck slots under its block mask, the
        four groups mixed after each layer."""
        M, n = self.n_modality, self.bottlenecks_n
        dt = self.compute_dtype
        B = enc_inputs[0].shape[0]
        xs, plain_masks, block_masks = [], [], []
        for m in range(M):
            x = enc_inputs[m].to(dt)
            vlen = varying_lengths[m].long()
            cls = self._cls_tokens(m)
            if cls is not None:
                x = torch.cat([cls.expand(B, -1, -1).to(dt), x], dim=1)
                vlen = vlen + cls.shape[1]
            h, pm, bm = self._stream(m, x, vlen, seeds)
            xs.append(h)
            plain_masks.append(pm)
            block_masks.append(bm)
        onehot = F.one_hot(missing_num.long(), 4).float()
        groups = None
        for layer in range(self.n_layers):
            stack = self.layer_stacks[layer]
            if layer < self.fusion_startidx:
                xs = [stack[m](xs[m], plain_masks[m], seeds)
                      for m in range(M)]
                continue
            contribs = [[] for _ in range(4)]
            new_xs = []
            for m in range(M):
                slots = (self._first_bottlenecks(m, B) if groups is None
                         else [groups[g] for g in GROUPS_PER_MODALITY[m]])
                out = stack[m](torch.cat(slots + [xs[m]], dim=1),
                               block_masks[m], seeds)
                for slot, g in enumerate(GROUPS_PER_MODALITY[m]):
                    contribs[g].append(out[:, n * slot:n * (slot + 1)])
                new_xs.append(out[:, 3 * n:])
            xs = new_xs
            groups = []
            for g in range(4):
                outs = torch.stack(contribs[g])              # [C, B, n, D]
                mix = onehot @ self.case_w[g, :, :outs.shape[0]]   # [B, C]
                groups.append(torch.einsum("bc,cbnd->bnd",
                                           mix.to(outs.dtype), outs))
        return xs


class MultitokenMBTFusion(_MultitokenFusion):
    """TrimodalTransformerEncoder_Multitokens_MBT (JAX models/mbt.py:
    463-569; mbt_encoder.py:329-517): cls tokens 4, 2 and 2 per stream,
    four bottleneck groups (vit, vi, vt, it) of n tokens each, each stream
    running behind its three groups; the vslt stream's 16 x 16 hand
    block set into its mask, the img and txt streams' or-ed into theirs."""

    CLS_NUM = (4, 2, 2)

    def __init__(self, **kw):
        super().__init__(**kw)
        n, D = self.bottlenecks_n, self.d_model
        self.cls_token_per_modality = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, c, D)) for c in self.CLS_NUM])
        self.bottlenecks = nn.ParameterList(
            [nn.Parameter(torch.zeros(1, n, D)) for _ in range(4)])

    def _cls_tokens(self, m):
        return self.cls_token_per_modality[m]

    def _first_bottlenecks(self, m, B):
        return [self.bottlenecks[g].expand(B, -1, -1).to(self.compute_dtype)
                for g in GROUPS_PER_MODALITY[m]]


class MultitokenMBTVSLTMAINFusion(_MultitokenFusion):
    """TrimodalTransformerEncoder_Multitokens_MBTVSLTMAIN (JAX models/
    mbt.py:571-676; mbt_encoder.py:9-193): only the vslt stream carries
    the 4 cls tokens; one shared bottleneck parameter fills the three
    group slots at the first fusion layer; the img and txt streams' masks
    get the 12 x 12 group-diagonal block over the bottlenecks."""

    N_CLS = 4
    VSLT_MAIN = True

    def __init__(self, **kw):
        super().__init__(**kw)
        n, D = self.bottlenecks_n, self.d_model
        self.cls_token = nn.Parameter(torch.zeros(1, self.N_CLS, D))
        self.bottlenecks = nn.Parameter(torch.zeros(1, n, D))

    def _cls_tokens(self, m):
        return self.cls_token if m == 0 else None

    def _first_bottlenecks(self, m, B):
        return [self.bottlenecks.expand(B, -1, -1).to(self.compute_dtype)] * 3
