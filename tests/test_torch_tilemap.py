"""The tile map of the 3-D block-mask attention block on the CPU
(kernels/attn_block.py::block_tile_map, the plain version of the card's
block_tile_map_kernel): against a brute-force class of each 64 x 64 tile on
the multitoken streams' own masks (models/mbt.py::block_key_mask, all three
streams, with and without VSLTMAIN) and on random masks with fully masked
rows; and that the attention block with the dead tiles' keys left out, as
the bf16 kernels skip them, is JAX's xla_attn_block on the same inputs
(fp32, within 1e-5). A few seconds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu.kernels.attn_block import xla_attn_block
from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
    TILE_DEAD, TILE_FULL, TILE_MIXED, block_tile_map)
from medical_tri_modal_pilot_tpu_torch.models.mbt import block_key_mask
from medical_tri_modal_pilot_tpu_torch.models.modules import stdln_apply


def brute_tile_map(mask: torch.Tensor) -> torch.Tensor:
    """Each tile's class by loops over the tiles: its pairs inside the
    array all masked (dead), none (full), some (mixed); a query tile with a
    fully masked row keeps every tile."""
    m = mask.numpy().astype(bool)
    B, Lq, Lk = m.shape
    nq, nk = -(-Lq // 64), -(-Lk // 64)
    out = np.empty((B, nq, nk), np.int8)
    for b in range(B):
        for qt in range(nq):
            rows = m[b, 64 * qt:64 * qt + 64]
            dead_row = bool(rows.all(axis=1).any())
            for kt in range(nk):
                t = rows[:, 64 * kt:64 * kt + 64]
                if t.all():
                    out[b, qt, kt] = TILE_MIXED if dead_row else TILE_DEAD
                elif not t.any():
                    out[b, qt, kt] = TILE_FULL
                else:
                    out[b, qt, kt] = TILE_MIXED
    return torch.from_numpy(out)


# (stream, content rows, cls rows): vslt (TIE, 4 cls), img (2), txt (2);
# the vslt length is the flagship's
STREAMS = [(0, 1000, 4), (1, 49, 2), (2, 128, 2)]


@pytest.mark.parametrize("stream,n_rows,cls", STREAMS)
@pytest.mark.parametrize("vslt_main", [False, True])
def test_tile_map_of_the_multitoken_masks(stream, n_rows, cls, vslt_main):
    """The streams' masks at seeded lengths, with a sample whose keys end
    inside the first tile, one at full length and, in the txt stream, a
    sample without a note (its rows 14-15 have every key masked)."""
    rng = np.random.default_rng(stream)
    cls = 0 if vslt_main and stream else cls
    lengths = rng.integers(1, n_rows + 1, 6)
    lengths[0], lengths[1] = 1, n_rows
    if stream == 2:
        lengths[2] = 0
    L = n_rows + cls
    mask = block_key_mask(torch.from_numpy(lengths + cls), L, 4, stream,
                          vslt_main)
    tmap = block_tile_map(mask)
    assert tmap.dtype == torch.int8
    assert tmap.shape == (6, -(-(L + 12) // 64), -(-(L + 12) // 64))
    assert torch.equal(tmap, brute_tile_map(mask))
    if stream == 0:
        # the short sample's later key tiles are dead for every query tile
        assert bool((tmap[0, :, 1:] == TILE_DEAD).all())
        assert bool((tmap == TILE_FULL).any())


def test_tile_map_of_random_masks():
    """Ragged shapes, random masks with whole dead and full tiles, and
    fully masked rows, which turn their query tile's dead tiles mixed."""
    rng = np.random.default_rng(5)
    for Lq, Lk in ((1, 1), (70, 130), (130, 70), (200, 200), (64, 128)):
        m = rng.random((3, Lq, Lk)) < 0.5
        m[0] = True
        m[1, :, : Lk // 2] = False
        m[2, :, Lk // 3:] = True
        m[2, Lq // 2] = True
        mask = torch.from_numpy(m)
        assert torch.equal(block_tile_map(mask), brute_tile_map(mask))
        assert torch.equal(block_tile_map(mask.to(torch.int8)),
                           brute_tile_map(mask))
    assert bool((block_tile_map(torch.ones(1, 70, 70, dtype=torch.bool))
                 == TILE_MIXED).all())


def _skipping_attn_block(x, gamma, beta, w, b, mask, scale, H):
    """The attention block as the bf16 kernels run it under a block mask:
    each query tile's keys in its dead tiles left out of the softmax, the
    rest as the plain version (masked pairs at -65504)."""
    B, L, C = x.shape
    tmap = block_tile_map(mask)
    dead = (tmap == TILE_DEAD).repeat_interleave(64, 1).repeat_interleave(
        64, 2)[:, :L, :L]
    ln = stdln_apply(x, gamma, beta, x.dtype)
    q, k, v = (ln @ w + b).split(C, dim=-1)
    q, k, v = (t.reshape(B, L, H, C // H) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / scale
    s = s.masked_fill(mask[:, None], -65504.0)
    s = s.masked_fill(dead[:, None], float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return x + o.reshape(B, L, C)


@pytest.mark.parametrize("stream", [0, 2])
def test_skipping_dead_tiles_is_the_jax_attention_block(stream):
    """Leaving out the dead tiles' keys changes nothing: their pairs would
    add exp(-65504 - m) = 0, and a row with every key masked keeps all its
    keys (its tile has no dead tile), so it still attends uniformly."""
    rng = np.random.default_rng(11)
    B, C, H = 4, 32, 2
    n_rows, cls = (200, 4) if stream == 0 else (128, 2)
    lengths = np.array([1, n_rows, 0 if stream == 2 else 50, 70])
    L = n_rows + cls
    mask = block_key_mask(torch.from_numpy(lengths + cls), L, 4, stream)
    Lb = L + 12
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    args = [f(B, Lb, C), 1 + 0.1 * f(C), 0.1 * f(C), f(C, 3 * C) / C ** .5,
            0.1 * f(3 * C)]
    scale = (C // H) ** .5
    got = _skipping_attn_block(*map(torch.from_numpy, args), mask, scale, H)
    want = xla_attn_block(*map(jnp.asarray, args), jnp.asarray(mask.numpy()),
                          scale, H)
    if stream == 2:
        assert bool(mask[2, 14:16].all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)

