"""The port's CUDA kernels against their plain PyTorch versions
on the card, at the small widths of the CPU tests (d_head 32, C 64), at
the flagship's (d_head 64, C 256; Swin-T's C 96-768) and at the other
model widths (C 128 and 512, d_head 128; the FFN's split route at 512):
forwards, the
backward kernels against autograd of the plain versions (the umse
backward against its closed form, torch_umse_bwd), the dropout masks bit
for bit; the masked attention of the cross-modal layers at
every mask form; the attention block under the multitoken streams' 3-D
block masks; and the small eval and train steps (vslt+txt, and
vslt+img+txt with the full Swin-T; the cross transformer) on both paths;
the row-skipping projections of tensor parallelism (both routes, the
kernels each dtype launches) and the dropout masks' column offset.
Marked ``cuda``: skipped without a GPU. This file imports no jax, so it
also runs where the port runs:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.kernels.attention import \
    cuda_masked_attention
from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
    cuda_attn_block, key_ends)
from medical_tri_modal_pilot_tpu_torch.kernels.ffn import plain_dropout_masks
from medical_tri_modal_pilot_tpu_torch.kernels.wgrad import wgrad
from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import (
    cuda_swin_mlp, torch_swin_mlp)
from medical_tri_modal_pilot_tpu_torch.models.modules import (
    ffn_row_blocks, length_key_mask)
from medical_tri_modal_pilot_tpu_torch.models.swin import _shift_attn_mask

pytestmark = pytest.mark.cuda
PRECS = {"fp32": torch.float32, "bf16": torch.bfloat16}
# as in chip_smoke.py: fp32 sums in another order; bf16 rounds at the same
# points up to a rounding flip (the attention block's flash loop rounds p
# before it divides by l, as the TPU kernel does, the plain version after)
TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=6e-2, rtol=2e-2)}
# gradients, as chip_smoke.py's GRAD_TOL: |kernel - plain|_F / |plain|_F
# per tensor (fp32: summation order and the odd ReLU unit on the other
# side of 0; bf16: the plain autograd rounds every intermediate gradient
# to bf16)
GRAD_TOL = {"fp32": 5e-3, "bf16": 5e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(g, dev, *shape, std=1.0, mean=0.0):
    return (mean + std * torch.randn(*shape, generator=g)).to(dev)


def _both(fn):
    """The kernel's result, then the plain version's, on the same inputs."""
    with torch.inference_mode():
        out = fn()
        with ops.reference_path():
            ref = fn()
    return out.float(), ref.float()


@pytest.mark.parametrize("prec", list(PRECS))
def test_umse_kernel(dev, prec):
    g = torch.Generator().manual_seed(0)
    B, L, D = 3, 77, 64
    x = torch.stack([-24 * torch.rand(B, L, generator=g),
                     torch.rand(B, L, generator=g),
                     torch.randint(0, 20, (B, L), generator=g).float()],
                    dim=-1).to(dev)
    vecs = [_rand(g, dev, 1, D)] + [_rand(g, dev, D, std=.1) for _ in range(3)]
    vecs += [_rand(g, dev, 1, D)] + [_rand(g, dev, D, std=.1)
                                     for _ in range(3)]
    table = _rand(g, dev, 20, D)
    out, ref = _both(lambda: ops.umse(x, *vecs, table, PRECS[prec]))
    torch.testing.assert_close(out, ref, **TOL[prec])


def _umse_case(g, dev, B, L, D, prec):
    """Seeded umse inputs with ids 20 and 23 past the table's end, and a
    cotangent in the dtype."""
    x = torch.stack([-24 * torch.rand(B, L, generator=g),
                     torch.rand(B, L, generator=g),
                     torch.randint(0, 20, (B, L), generator=g).float()],
                    dim=-1)
    x[0, 1, 2], x[-1, -1, 2] = 20, 23
    vecs = [_rand(g, dev, 1, D)] + [_rand(g, dev, D, std=.1) for _ in range(3)]
    vecs += [_rand(g, dev, 1, D)] + [_rand(g, dev, D, std=.1)
                                     for _ in range(3)]
    vecs[2] = vecs[2] + 1.0
    vecs[6] = vecs[6] + 1.0
    dout = _rand(g, dev, B, L, D).to(PRECS[prec])
    return x.to(dev), vecs + [_rand(g, dev, 20, D)], dout


@pytest.mark.parametrize("B,L,D", [(3, 77, 64), (4, 300, 256), (2, 5, 32),
                                   (3, 200, 128), (4, 300, 512)])
@pytest.mark.parametrize("prec", list(PRECS))
def test_umse_backward_kernel(dev, B, L, D, prec):
    """The backward kernel's nine gradients against torch_umse_bwd, its
    closed form in plain torch with the same rounding points, on the card;
    both sum in fp32 in another order. Through the autograd Function too:
    the same gradients, one launch each way."""
    from medical_tri_modal_pilot_tpu_torch.kernels.umse import (
        cuda_umse_bwd, torch_umse_bwd)
    g = torch.Generator().manual_seed(31)
    dt = PRECS[prec]
    x, params, dout = _umse_case(g, dev, B, L, D, prec)
    ops.reset_launches()
    got = cuda_umse_bwd(x, *params, dout, dt)
    assert ops.launches["umse_bwd"] == 1
    want = torch_umse_bwd(x, *params, dout, dt)
    for a, e in zip(got, want):
        assert a.shape == e.shape
        torch.testing.assert_close(a, e, **TOL[prec])
    leaves = [p.clone().requires_grad_(True) for p in params]
    via = torch.autograd.grad(ops.umse(x, *leaves, dt), leaves, dout)
    assert ops.launches["umse"] == 1 and ops.launches["umse_bwd"] == 2
    assert all(torch.equal(a, e) for a, e in zip(via, got))


def test_umse_backward_is_bit_identical(dev):
    """Two runs of the bf16 backward at the main path's width give the same
    gradients bit for bit: fixed-order sums, no float atomics."""
    from medical_tri_modal_pilot_tpu_torch.kernels.umse import cuda_umse_bwd
    g = torch.Generator().manual_seed(32)
    x, params, dout = _umse_case(g, dev, 16, 1000, 256, "bf16")
    first = cuda_umse_bwd(x, *params, dout, torch.bfloat16)
    again = cuda_umse_bwd(x, *params, dout, torch.bfloat16)
    assert all(torch.equal(a, e) for a, e in zip(first, again))


def test_umse_and_dropout_masks_launch_their_kernels(dev):
    """A bf16 umse forward and backward launch umse_fwd_kernel, then
    umse_bwd_kernel and col_sum_kernel, and nothing else (no recompute of
    torch_umse); dropout_masks launches dropout_masks_kernel alone (no
    .bool() copy)."""
    g = torch.Generator().manual_seed(33)
    x, params, dout = _umse_case(g, dev, 4, 300, 256, "bf16")
    leaves = [p.clone().requires_grad_(True) for p in params]
    names = _launched(lambda: torch.autograd.grad(
        ops.umse(x, *leaves, torch.bfloat16), leaves, dout))
    want = ("umse_fwd_kernel", "umse_bwd_kernel", "col_sum_kernel")
    for kernel in want:
        assert any(kernel + "<" in n or kernel + "(" in n for n in names), \
            (kernel, names)
    assert all(any(k in n for k in want) for n in names), names
    for F in (0, 512):
        names = _launched(lambda: ops.dropout_masks(300, F, 256, 7, 0.1, dev,
                                                    col0=F))
        assert names and all("dropout_masks_kernel" in n for n in names), \
            names


# attn_block shapes: the small widths (d_head 32) and the main path's at
# C 256 / H 4 (d_head 64): the vslt stream (1024), the txt stream (133),
# the cross transformer's self layers (24), a ragged 300
ATTN_BLOCK_SHAPES = [(54, 64, 2), (130, 64, 2), (300, 256, 4),
                     (1024, 256, 4), (133, 256, 4), (24, 256, 4),
                     (300, 128, 4), (300, 512, 4), (300, 256, 2),
                     (130, 512, 8)]


@pytest.mark.parametrize("L,C,H", ATTN_BLOCK_SHAPES)
@pytest.mark.parametrize("prec", list(PRECS))
def test_attn_block_kernel(dev, L, C, H, prec):
    """Random lengths with one fully masked sample; live rows only (the
    kernel emits the residual in q tiles past the last valid key)."""
    g = torch.Generator().manual_seed(1)
    B = 4
    dt = PRECS[prec]
    x = _rand(g, dev, B, L, C).to(dt)
    gamma, beta = _rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1)
    w = _rand(g, dev, C, 3 * C, std=C ** -.5).to(dt)
    b = _rand(g, dev, 3 * C, std=.1).to(dt)
    lengths = torch.tensor([0, 1, L // 2, L], device=dev)
    mask = length_key_mask(lengths, L)
    out, ref = _both(lambda: ops.attn_block(x, gamma, beta, w, b, mask,
                                            (C // H) ** .5, H))
    live = torch.arange(L, device=dev)[None] < key_ends(mask)[:, None].long()
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])


@pytest.mark.parametrize("L,C,H", [(130, 64, 2), (1024, 256, 4),
                                   (300, 512, 4)])
def test_attn_block_backward_is_bit_identical(dev, L, C, H):
    """The bf16 backward (delta pre-pass, dK/dV and dQ passes, projection
    backward, weight sums) repeats bit for bit: no float atomics."""
    g = torch.Generator().manual_seed(16)
    B, dt = 4, torch.bfloat16
    x = _rand(g, dev, B, L, C).to(dt)
    gamma, beta = _rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1)
    w = _rand(g, dev, C, 3 * C, std=C ** -.5).to(dt)
    b = _rand(g, dev, 3 * C, std=.1).to(dt)
    mask = length_key_mask(torch.tensor([0, 1, L // 2, L], device=dev), L)
    live = torch.arange(L, device=dev)[None] < key_ends(mask)[:, None].long()
    cot = _rand(g, dev, B, L, C).to(dt) * live[:, :, None]
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, gamma, beta, w, b)]
    out = ops.attn_block(*leaves, mask, (C // H) ** .5, H)
    first = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    again = torch.autograd.grad(out, leaves, cot)
    for name, a, e in zip(["dx", "dgamma", "dbeta", "dw", "db"], first,
                          again):
        assert torch.equal(a, e), name


def _sm_smem(dev) -> int:
    return torch.cuda.get_device_properties(
        dev).shared_memory_per_multiprocessor


def test_attn_block_smem_table_matches_the_kernels(dev):
    """The wrapper's shared-memory reckoning of each tensor-core kernel is
    the bytes its launcher asks for, within the card's 227 KB, and its
    blocks an SM those the kernel's launch bounds ask for, whose shared
    memory fits an SM."""
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.kernels.attn_block import (
        TC_KERNELS, tc_min_blocks, tc_smem_bytes)
    lib = _build.library()
    for C, dh in ((64, 32), (256, 64), (256, 32), (128, 32), (512, 128),
                  (256, 128)):
        table, blocks = tc_smem_bytes(C, dh), tc_min_blocks(C, dh)
        for i, name in enumerate(TC_KERNELS):
            assert lib.attn_block_tc_smem(i, C, dh) == table[name], name
            assert table[name] <= 232448, name
            assert lib.attn_block_tc_min_blocks(i, C, dh) == blocks[name], \
                name
            assert blocks[name] * (table[name] + 1024) <= _sm_smem(dev), name


@pytest.mark.parametrize("C", [64, 256, 128, 512])
@pytest.mark.parametrize("prec", list(PRECS))
def test_ffn_kernel(dev, C, prec):
    """Tile flags from lengths (one sample fully masked keeps all its
    tiles); skipped tiles are the residual, bit for bit."""
    g = torch.Generator().manual_seed(2)
    B, L, F = 4, 256, 4 * C
    dt = PRECS[prec]
    x = _rand(g, dev, B, L, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, F, std=C ** -.5), _rand(g, dev, F, std=.1),
          _rand(g, dev, F, C, std=F ** -.5), _rand(g, dev, C, std=.1))
    mask = length_key_mask(torch.tensor([0, 10, 100, 256], device=dev), L)
    flags = ffn_row_blocks(x, mask)
    out, ref = _both(lambda: ops.ffn(x, *ws, flags))
    live = flags.repeat_interleave(L // flags.shape[1], dim=1)
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    assert torch.equal(out[~live], x[~live].float())


def _grads(fn, inputs, cot):
    """fn's output and the gradients of sum(out * cot), on the kernel path
    and on the plain path."""
    res = []
    for plain in (False, True):
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        if plain:
            with ops.reference_path():
                out = fn(*leaves)
        else:
            out = fn(*leaves)
        grads = torch.autograd.grad(out, leaves, cot)
        res.append((out.detach().float(), [g.float() for g in grads]))
    return res


def _assert_grads_close(got, want, prec, names):
    for g, w, name in zip(got, want, names):
        err = float((g - w).norm())
        bound = GRAD_TOL[prec] * float(w.norm()) + 1e-6
        assert err <= bound, f"{name}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("L,C,H", ATTN_BLOCK_SHAPES)
@pytest.mark.parametrize("prec", list(PRECS))
def test_attn_block_training_kernels(dev, L, C, H, prec):
    """The training forward and the backward kernels against autograd of
    the plain version: random lengths with one fully masked sample, the
    cotangent zero on rows at or past each sample's last valid key."""
    g = torch.Generator().manual_seed(6)
    B, dt = 4, PRECS[prec]
    x = _rand(g, dev, B, L, C).to(dt)
    gamma, beta = _rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1)
    w = _rand(g, dev, C, 3 * C, std=C ** -.5).to(dt)
    b = _rand(g, dev, 3 * C, std=.1).to(dt)
    mask = length_key_mask(torch.tensor([0, 1, L // 2, L], device=dev), L)
    live = torch.arange(L, device=dev)[None] < key_ends(mask)[:, None].long()
    cot = _rand(g, dev, B, L, C).to(dt) * live[:, :, None]
    ops.reset_launches()
    (out, grads), (ref, ref_grads) = _grads(
        lambda *a: ops.attn_block(*a, mask, (C // H) ** .5, H),
        (x, gamma, beta, w, b), cot)
    assert ops.launches["attn_block"] == 1
    assert ops.launches["attn_block_bwd"] == 1
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    _assert_grads_close(grads, ref_grads, prec,
                        ["dx", "dgamma", "dbeta", "dw", "db"])


@pytest.mark.parametrize("C", [64, 256, 128, 512])
@pytest.mark.parametrize("p", [0.0, 0.25])
@pytest.mark.parametrize("prec", list(PRECS))
def test_ffn_training_kernels(dev, C, p, prec):
    """The forward with in-kernel dropout and the backward kernel against
    autograd of the plain version on the same Philox masks; skipped tiles
    carry a zero cotangent, as in the model."""
    g = torch.Generator().manual_seed(7)
    B, L, F, dt = 4, 256, 4 * C, PRECS[prec]
    x = _rand(g, dev, B, L, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, F, std=C ** -.5), _rand(g, dev, F, std=.1),
          _rand(g, dev, F, C, std=F ** -.5), _rand(g, dev, C, std=.1))
    mask = length_key_mask(torch.tensor([0, 10, 100, 256], device=dev), L)
    flags = ffn_row_blocks(x, mask)
    live = flags.repeat_interleave(L // flags.shape[1], dim=1)
    cot = _rand(g, dev, B, L, C).to(dt) * live[:, :, None]
    ops.reset_launches()
    (out, grads), (ref, ref_grads) = _grads(
        lambda *a: ops.ffn(*a, flags, p=p, training=True, seed=1234),
        (x, *ws), cot)
    assert ops.launches["ffn"] == ops.launches["ffn_bwd"] == 1
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    _assert_grads_close(grads, ref_grads, prec,
                        ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"])


# the tensor-core forward's cases: (R, C, flags of the 64-row tiles): a
# dead first half of the one 128-row tile with a single live row after it
# (R = 65); a half-dead 128-row tile, a live one and a dead ragged tail
# (R = 300)
FFN_TC_CASES = [(65, 64, [0, 1]), (65, 256, [0, 1]),
                (300, 64, [1, 0, 1, 1, 0]), (300, 256, [1, 0, 1, 1, 0]),
                (300, 128, [1, 0, 1, 1, 0]), (65, 512, [0, 1]),
                (300, 512, [1, 0, 1, 1, 0])]
# the kernels each FFN forward route launches
FFN_ROUTE_KERNELS = {"tc": ("ffn_fwd_tc_kernel",), "fma": ("ffn_kernel",),
                     "tc_split": ("ffn_ln_kernel", "gemm_bf16_kernel"),
                     "fma_split": ("ffn_ln_kernel", "gemm_kernel")}


@pytest.mark.parametrize("R,C,flags", FFN_TC_CASES)
@pytest.mark.parametrize("p", [0.0, 0.25])
def test_ffn_tc_forward(dev, R, C, flags, p):
    """The bf16 forward on the tensor cores (the split route at C = 512):
    dead 64-row tiles are x bit for bit, live rows match the plain version
    on the same Philox masks within TOL, and on live rows every element
    the output mask drops is x bit for bit (the kernel's output mask is
    plain_dropout_masks')."""
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import ffn_route
    g = torch.Generator().manual_seed(21)
    F, dt, seed = 4 * C, torch.bfloat16, 4321
    x = _rand(g, dev, R, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, F, std=C ** -.5).to(dt),
          _rand(g, dev, F, std=.1).to(dt),
          _rand(g, dev, F, C, std=F ** -.5).to(dt),
          _rand(g, dev, C, std=.1).to(dt))
    valid = torch.tensor(flags, dtype=torch.bool, device=dev)
    live = valid.repeat_interleave(64)[:R]
    ops.reset_launches()
    out, ref = _both(lambda: ops.ffn(x, *ws, valid, p=p, training=True,
                                     seed=seed))
    assert ops.launches["ffn"] == 1
    assert torch.equal(out[~live], x[~live].float())
    torch.testing.assert_close(out[live], ref[live], **TOL["bf16"])
    if p > 0:
        _, keep = plain_dropout_masks(R, F, C, seed, p, dev)
        dropped = ~keep & live[:, None]
        assert int(dropped.sum()) > 0
        assert torch.equal(out[dropped], x.float()[dropped])
    with torch.inference_mode():
        names = _launched(lambda: ops.ffn(x, *ws, valid, p=p, training=True,
                                          seed=seed))
    _route_kernels(names, FFN_ROUTE_KERNELS, ffn_route(dt, C))


def test_ffn_and_swin_mlp_smem_tables_match_the_kernels(dev):
    """The wrappers' shared-memory reckoning of the tensor-core forwards
    is the bytes their launchers ask for, within the card's opt-in
    limit; the ffn's blocks an SM are those its kernels' launch bounds ask
    for."""
    from medical_tri_modal_pilot_tpu_torch.kernels import _build, ffn, \
        swin_mlp
    lib = _build.library()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for C in ffn.WIDTHS:
        blocks = ffn.tc_min_blocks(C)
        if C != ffn.SPLIT_WIDTH:
            assert lib.ffn_tc_smem(C) == ffn.tc_smem_bytes(C) <= limit, C
            for i, name in enumerate(("ffn_fwd_tc_kernel",
                                      "ffn_bwd_tc_kernel")):
                assert lib.ffn_tc_min_blocks(i, C) == blocks[name], (C, name)
            assert blocks["ffn_fwd_tc_kernel"] * (
                ffn.tc_smem_bytes(C) + 1024) <= _sm_smem(dev), C
        else:
            for i, name in enumerate(("gemm_bf16_kernel",
                                      "ffn_ln_bwd_tc_kernel")):
                assert lib.ffn_split_min_blocks(i) == blocks[name], name
    assert lib.ffn_tc_smem(96) == lib.ffn_tc_smem(ffn.SPLIT_WIDTH) == 0
    assert lib.ffn_tc_min_blocks(0, 96) == 0
    for i, (name, smem) in enumerate(ffn.split_smem_bytes().items()):
        assert lib.ffn_split_smem(i) == smem <= limit, name
    for C in range(32, 1600, 32):
        assert lib.swin_mlp_tc_smem(C) == swin_mlp.tc_smem_bytes(C) <= \
            limit, C


@pytest.mark.parametrize("R,F,C", [(300, 256, 64), (1000, 0, 256),
                                   (65, 1024, 256), (997, 0, 256),
                                   (61, 0, 100), (33, 70, 18)])
def test_dropout_masks_kernel_is_bit_identical(dev, R, F, C):
    """Both masks bit for bit the plain version's, as bool: the main
    path's widths (16-byte stores), F = 0 at a ragged R (the input
    dropout) and widths that are not multiples of 16 or 4 (4-byte and byte
    stores at the row edges)."""
    for seed, p in ((5, 0.1), (2 ** 63 - 1, 0.5)):
        got = ops.dropout_masks(R, F, C, seed, p, dev)
        want = plain_dropout_masks(R, F, C, seed, p, dev)
        for a, e in zip(got, want):
            assert a.dtype == torch.bool and torch.equal(a, e)


@pytest.mark.parametrize("col0,F,C", [(0, 64, 64), (1, 7, 64), (5, 64, 64),
                                      (512, 512, 64), (512, 512, 256),
                                      (3, 61, 100)])
def test_dropout_masks_kernel_takes_the_column_offset(dev, col0, F, C):
    """A rank's hidden mask (F columns from col0; 512 from 512 at C 256 is
    rank 1's share under --mp-size 2) is bit for bit the plain version's
    and those columns of the kernel's whole mask; offset 0 is the kernels'
    own mask."""
    R, p, seed = 300, 0.1, 2 ** 40 + 5
    part = ops.dropout_masks(R, F, C, seed, p, dev, col0=col0)
    whole = ops.dropout_masks(R, col0 + F, C, seed, p, dev)
    want = plain_dropout_masks(R, F, C, seed, p, dev, col0=col0)
    assert torch.equal(part[0], want[0]) and torch.equal(part[1], want[1])
    assert torch.equal(part[0], whole[0][:, col0:])
    assert torch.equal(part[1], whole[1])


# rowmm: (B, L, Cin, Cout, lengths): small widths with a dead 256-row block
# and a ragged row count, the tensor-parallel rank's widths (Cin 256, one
# rank's q|k|v of 384) with an all-masked sample, and the single-device
# q|k|v width (768) ragged and with a dead block
ROWMM_CASES = [(2, 512, 64, 192, (200, 512)), (1, 130, 64, 192, None),
               (3, 512, 256, 384, (0, 100, 512)), (1, 130, 256, 768, None),
               (2, 512, 256, 768, (200, 512)),
               (2, 512, 128, 384, (200, 512)), (1, 130, 128, 192, None),
               (3, 512, 512, 768, (0, 100, 512)),
               (2, 512, 512, 1536, (200, 512))]


@pytest.mark.parametrize("case", ROWMM_CASES)
@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("prec", list(PRECS))
def test_rowmm_kernels(dev, case, ln, prec):
    """The row-skipping projection (LN-fused and plain) and its backward
    against autograd of the plain version: outputs on live rows, zeros in
    dead blocks, every gradient with the cotangent zero on dead rows; one
    launch of each kernel."""
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import BLOCK_R
    B, L, Cin, Cout, lengths = case
    g = torch.Generator().manual_seed(11)
    dt = PRECS[prec]
    x = _rand(g, dev, B, L, Cin).to(dt)
    w = _rand(g, dev, Cin, Cout, std=Cin ** -.5).to(dt)
    b = _rand(g, dev, Cout, std=.1).to(dt)
    live = torch.ones(B, L, dtype=torch.bool, device=dev)
    flags = None
    if lengths is not None:
        live = length_key_mask(torch.tensor(lengths, device=dev), L).logical_not()
        flags = ffn_row_blocks(x, ~live, BLOCK_R)
        live = flags.repeat_interleave(BLOCK_R, dim=1)
    cot = _rand(g, dev, B, L, Cout).to(dt) * live[:, :, None]
    if ln:
        inputs = (x, _rand(g, dev, Cin, std=.1, mean=1.),
                  _rand(g, dev, Cin, std=.1), w, b)
        fn = lambda *a: torch.cat(ops.rowskip_ln_affine(*a, flags), -1)
        names, name = ["dx", "dgamma", "dbeta", "dw", "db"], "rowmm_ln"
    else:
        inputs, names, name = (x, w, b), ["dx", "dw", "db"], "rowmm"
        fn = lambda *a: ops.rowskip_affine(*a, flags)
    ops.reset_launches()
    (out, grads), (ref, ref_grads) = _grads(fn, inputs, cot)
    assert ops.launches[name] == ops.launches[f"{name}_bwd"] == 1
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    assert torch.all(out[~live] == 0)
    _assert_grads_close(grads, ref_grads, prec, names)


@pytest.mark.parametrize("Cin,Cout", [(64, 64), (64, 128), (256, 64),
                                      (256, 128), (256, 320)])
@pytest.mark.parametrize("prec", list(PRECS))
def test_rowmm_plain_form_at_other_widths(dev, Cin, Cout, prec):
    """The plain form at output widths the LN form never takes (one
    64-column tile; a last 128-column chunk half past the end; backward
    rings of 2, 4 and 10 chunks), a dead block and a ragged tail."""
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import BLOCK_R
    g = torch.Generator().manual_seed(15)
    dt = PRECS[prec]
    B, L = 2, 512
    x = _rand(g, dev, B, L, Cin).to(dt)
    w = _rand(g, dev, Cin, Cout, std=Cin ** -.5).to(dt)
    b = _rand(g, dev, Cout, std=.1).to(dt)
    mask = length_key_mask(torch.tensor([100, 512], device=dev), L)
    flags = ffn_row_blocks(x, mask, BLOCK_R)
    live = flags.repeat_interleave(BLOCK_R, dim=1)
    cot = _rand(g, dev, B, L, Cout).to(dt) * live[:, :, None]
    (out, grads), (ref, ref_grads) = _grads(
        lambda *a: ops.rowskip_affine(*a, flags), (x, w, b), cot)
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    assert torch.all(out[~live] == 0)
    _assert_grads_close(grads, ref_grads, prec, ["dx", "dw", "db"])
    # a ragged row count: the last forward tile holds 2 of its rows
    x2, cot2 = x.reshape(-1, Cin)[:130], cot.reshape(-1, Cout)[:130]
    (out, grads), (ref, ref_grads) = _grads(
        lambda *a: ops.rowskip_affine(*a), (x2, w, b), cot2)
    torch.testing.assert_close(out, ref, **TOL[prec])
    _assert_grads_close(grads, ref_grads, prec, ["dx", "dw", "db"])


# the kernels of each rowmm route (kernels/rowmm.py rowmm_route)
ROWMM_ROUTE_KERNELS = {"tc": ("rowmm_tc_kernel", "rowmm_bwd_tc_kernel"),
                       "fma": ("rowmm_kernel", "rowmm_bwd_kernel")}


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("prec", list(PRECS))
def test_rowmm_takes_its_dtypes_route(dev, ln, prec):
    """bf16 launches the tensor-core kernels and fp32 the FMA kernels,
    forward and backward, and not the other route's (kernel names in a
    profiler trace)."""
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import rowmm_route
    g = torch.Generator().manual_seed(16)
    dt = PRECS[prec]
    route = rowmm_route(dt, 256)
    assert route == {"bf16": "tc", "fp32": "fma"}[prec]
    x = _rand(g, dev, 2, 256, 256).to(dt)
    w = _rand(g, dev, 256, 384, std=1 / 16).to(dt)
    b = _rand(g, dev, 384, std=.1).to(dt)
    vec = _rand(g, dev, 256, std=.1, mean=1.)
    leaves = [t.clone().requires_grad_(True) for t in (x, vec, vec, w, b)]
    if not ln:
        leaves = [leaves[0], leaves[3], leaves[4]]

    def step():
        out = (torch.cat(ops.rowskip_ln_affine(*leaves), -1) if ln
               else ops.rowskip_affine(*leaves))
        torch.autograd.grad(out, leaves, torch.ones_like(out))
    _route_kernels(_launched(step), ROWMM_ROUTE_KERNELS, route)


@pytest.mark.parametrize("ln", [True, False])
def test_rowmm_backward_is_bit_identical(dev, ln):
    """The bf16 backward (tile pass and weight sums) repeats bit for bit: no
    float atomics."""
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import BLOCK_R
    g = torch.Generator().manual_seed(17)
    dt = torch.bfloat16
    B, L, Cin, Cout = 3, 512, 256, 384
    x = _rand(g, dev, B, L, Cin).to(dt)
    w = _rand(g, dev, Cin, Cout, std=Cin ** -.5).to(dt)
    b = _rand(g, dev, Cout, std=.1).to(dt)
    mask = length_key_mask(torch.tensor([0, 100, 512], device=dev), L)
    flags = ffn_row_blocks(x, mask, BLOCK_R)
    live = flags.repeat_interleave(BLOCK_R, dim=1)
    cot = _rand(g, dev, B, L, Cout).to(dt) * live[:, :, None]
    inputs = ((x, _rand(g, dev, Cin, std=.1, mean=1.),
               _rand(g, dev, Cin, std=.1), w, b) if ln else (x, w, b))
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = (torch.cat(ops.rowskip_ln_affine(*leaves, flags), -1) if ln
           else ops.rowskip_affine(*leaves, flags))
    first = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    again = torch.autograd.grad(out, leaves, cot)
    for i, (a, e) in enumerate(zip(first, again)):
        assert torch.equal(a, e), i


def test_rowmm_smem_table_matches_the_kernels(dev):
    """The wrapper's shared-memory reckoning of each tensor-core kernel is
    the bytes its launcher asks for, within the card's opt-in limit, and
    its blocks an SM those the kernel's launch bounds ask for, whose shared
    memory fits an SM."""
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import (
        TC_KERNELS, WIDTHS, rowmm_tc_smem, tc_min_blocks)
    lib = _build.library()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for Cin in WIDTHS:
        table, blocks = rowmm_tc_smem(Cin), tc_min_blocks(Cin)
        for i, name in enumerate(TC_KERNELS):
            assert lib.rowmm_tc_smem(i, Cin) == table[name] <= limit, name
            assert lib.rowmm_tc_min_blocks(i, Cin) == blocks[name], name
            assert blocks[name] * (table[name] + 1024) <= _sm_smem(dev), name


def test_rowmm_refuses_what_it_does_not_take(dev):
    from medical_tri_modal_pilot_tpu_torch.kernels.rowmm import (
        cuda_rowskip_affine, cuda_rowskip_ln_affine)
    x = torch.zeros(2, 8, 64, device=dev)
    vec = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="multiples of 64"):
        cuda_rowskip_ln_affine(x, vec, vec, torch.zeros(64, 96, device=dev),
                               torch.zeros(96, device=dev))
    with pytest.raises(ValueError, match="Cin"):
        cuda_rowskip_affine(torch.zeros(2, 8, 96, device=dev),
                            torch.zeros(96, 64, device=dev),
                            torch.zeros(64, device=dev))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        cuda_rowskip_affine(x.half(), torch.zeros(64, 64, device=dev),
                            torch.zeros(64, device=dev))


@pytest.mark.parametrize("prec", list(PRECS))
def test_wgrad_takes_the_cotangents_apart(dev, prec):
    """B given as three [R, Cs] arrays (rowmm's q, k and v cotangents) sums
    bit for bit as their concatenation, flags and all."""
    from medical_tri_modal_pilot_tpu_torch.kernels.wgrad import CHUNK_ROWS
    g = torch.Generator().manual_seed(18)
    dt = PRECS[prec]
    a = _rand(g, dev, 1000, 256).to(dt)
    parts = [_rand(g, dev, 1000, 128).to(dt) for _ in range(3)]
    valid = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1],
                         dtype=torch.int8, device=dev)
    whole = wgrad(a, torch.cat(parts, 1), valid, CHUNK_ROWS)
    apart = wgrad(a, parts, valid, CHUNK_ROWS)
    assert torch.equal(whole[0], apart[0]) and torch.equal(whole[1], apart[1])


@pytest.mark.parametrize("prec", list(PRECS))
def test_wgrad_matches_a_product(dev, prec):
    """A^T B and the column sums of B over ragged slices of rows."""
    g = torch.Generator().manual_seed(8)
    a = _rand(g, dev, 1000, 64).to(PRECS[prec])
    b = _rand(g, dev, 1000, 192).to(PRECS[prec])
    dw, db = wgrad(a, b)
    torch.testing.assert_close(dw, a.double().t() @ b.double(),
                               atol=1e-3, rtol=1e-4, check_dtype=False)
    torch.testing.assert_close(db, b.double().sum(0), atol=1e-3, rtol=1e-4,
                               check_dtype=False)


def test_kernels_refuse_block_masks_and_grads(dev):
    """The 3-D block mask runs on the card (test_attn_block_block_mask);
    a block mask of the wrong shape is refused there."""
    x = torch.zeros(2, 8, 64, device=dev)
    args = (torch.ones(64, device=dev), torch.zeros(64, device=dev),
            torch.zeros(64, 192, device=dev), torch.zeros(192, device=dev))
    with pytest.raises(ValueError, match="key mask"):
        cuda_attn_block(x, *args, torch.zeros(2, 8, 7, dtype=torch.bool,
                                              device=dev), 4.0, 2)
    out = cuda_attn_block(x, *args, torch.zeros(2, 8, 8, dtype=torch.bool,
                                                device=dev), 4.0, 2)
    assert torch.equal(out, x)


# the multitoken streams' block masks at small widths: (stream, content
# rows, C, heads); stream 0 is vslt (4 cls), 1 img (2 cls), 2 txt (2 cls)
BLOCK_MASK_CASES = [(0, 60, 64, 2), (1, 49, 64, 2), (2, 40, 256, 4),
                    (2, 128, 256, 4), (2, 128, 512, 4), (0, 60, 128, 4),
                    (2, 40, 256, 2)]


@pytest.mark.parametrize("stream,n_rows,C,H", BLOCK_MASK_CASES)
@pytest.mark.parametrize("vslt_main", [False, True])
@pytest.mark.parametrize("prec", list(PRECS))
def test_attn_block_block_mask(dev, stream, n_rows, C, H, vslt_main, prec):
    """The 3-D block-mask form (lean, training forward and backward)
    against the plain version under the multitoken fusion's own masks
    (models/mbt.py::block_key_mask) with seeded lengths and a sample
    without a note (in the txt stream its rows 14-15 have every key
    masked): every row on the output and the gradients, one launch each
    of attn_block_3d and attn_block_3d_bwd, none of the key-mask form."""
    from medical_tri_modal_pilot_tpu_torch.models.mbt import block_key_mask
    g = torch.Generator().manual_seed(9)
    B, dt = 4, PRECS[prec]
    cls = 4 if stream == 0 else (0 if vslt_main else 2)
    L = cls + n_rows
    lengths = torch.randint(1, n_rows + 1, (B,), generator=g)
    lengths[1] = 0 if stream == 2 else lengths[1]
    vlen = (lengths + cls).to(dev)
    mask = block_key_mask(vlen, L, 4, stream, vslt_main)
    if stream == 2 and not vslt_main:
        assert mask[1, 14:16].all()
    Lb = L + 12
    x = _rand(g, dev, B, Lb, C).to(dt)
    gamma, beta = _rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1)
    w = _rand(g, dev, C, 3 * C, std=C ** -.5).to(dt)
    b = _rand(g, dev, 3 * C, std=.1).to(dt)
    cot = _rand(g, dev, B, Lb, C).to(dt)
    fwd = lambda *a: ops.attn_block(*a, mask, (C // H) ** .5, H)
    out, ref = _both(lambda: fwd(x, gamma, beta, w, b))
    torch.testing.assert_close(out, ref, **TOL[prec])
    ops.reset_launches()
    (out, grads), (ref, ref_grads) = _grads(fwd, (x, gamma, beta, w, b), cot)
    assert ops.launches["attn_block_3d"] == 1
    assert ops.launches["attn_block_3d_bwd"] == 1
    assert ops.launches["attn_block"] == ops.launches["attn_block_bwd"] == 0
    torch.testing.assert_close(out, ref, **TOL[prec])
    _assert_grads_close(grads, ref_grads, prec,
                        ["dx", "dgamma", "dbeta", "dw", "db"])


# masked attention: (B, H, Lq, Lk, d_head, mask): the cross-modal layers'
# [24] x [128] keys and back, no mask, a key mask with padding mid-sequence,
# a sample whose keys are all masked, a block mask, a self-attention whose
# later q tiles are dead, the tile loop's edges (Lq < 16, Lk < 16) under a
# key mask and a block mask, and the cross shapes at the models' batch
ATTN_CASES = [(4, 4, 24, 128, 64, "keys"), (4, 4, 128, 24, 64, "keys"),
              (3, 2, 54, 54, 32, "none"), (3, 2, 130, 130, 32, "noncontig"),
              (3, 2, 40, 100, 32, "all_masked"),
              (2, 2, 130, 70, 32, "block"), (3, 2, 300, 300, 64, "self"),
              (3, 2, 5, 300, 32, "keys"), (3, 2, 5, 300, 32, "block"),
              (3, 2, 130, 7, 32, "keys"), (3, 2, 130, 7, 32, "block"),
              (64, 4, 24, 128, 64, "keys"), (64, 4, 128, 24, 64, "keys"),
              (4, 4, 24, 128, 128, "keys"), (3, 2, 54, 54, 128, "none"),
              (2, 2, 130, 70, 128, "block"), (3, 2, 300, 300, 128, "self"),
              (3, 2, 5, 300, 128, "keys")]


def _attn_case(dev, B, H, Lq, Lk, D, kind, dt, seed):
    """q, k, v, the mask, is_self and the live rows [B, Lq] (under
    is_self, the rows before each sample's last valid key)."""
    g = torch.Generator().manual_seed(seed)
    q = _rand(g, dev, B, Lq, H, D).to(dt)
    k = _rand(g, dev, B, Lk, H, D).to(dt)
    v = _rand(g, dev, B, Lk, H, D).to(dt)
    live = torch.ones(B, Lq, dtype=torch.bool, device=dev)
    mask = None
    if kind in ("keys", "self", "all_masked"):
        lengths = torch.linspace(1, Lk, B).long()
        if kind == "self":
            lengths = torch.tensor([10, 150, Lk])
        if kind == "all_masked":
            lengths[0] = 0
        mask = length_key_mask(lengths.to(dev), Lk)
    elif kind == "noncontig":
        mask = torch.rand(B, Lk, generator=g).to(dev) < 0.5
    elif kind == "block":
        mask = torch.rand(B, Lq, Lk, generator=g).to(dev) < 0.5
        mask[:, :, 0] = False
        mask[0, 3] = True
    if kind == "self":
        live = torch.arange(Lq, device=dev)[None] < key_ends(mask)[:, None]
    return q, k, v, mask, kind == "self", live


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind", ATTN_CASES)
@pytest.mark.parametrize("prec", list(PRECS))
def test_attention_kernel(dev, B, H, Lq, Lk, D, kind, prec):
    """The lean forward against the plain version, on live rows."""
    q, k, v, mask, is_self, live = _attn_case(dev, B, H, Lq, Lk, D, kind,
                                              PRECS[prec], seed=9)
    ops.reset_launches()
    out, ref = _both(lambda: ops.attention(q, k, v, mask, D ** .5, is_self))
    assert ops.launches["attention"] == 1
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    if is_self:
        dead = torch.arange(Lq, device=dev)[None] >= (
            (key_ends(mask)[:, None] + 63) // 64 * 64)
        assert not out[dead].any()


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind", ATTN_CASES)
@pytest.mark.parametrize("prec", list(PRECS))
def test_attention_training_kernels(dev, B, H, Lq, Lk, D, kind, prec):
    """The training forward and the backward kernels against autograd of
    the plain version: dq, dk and dv, the cotangent zero on dead rows."""
    dt = PRECS[prec]
    q, k, v, mask, is_self, live = _attn_case(dev, B, H, Lq, Lk, D, kind,
                                              dt, seed=10)
    g = torch.Generator().manual_seed(11)
    cot = _rand(g, dev, B, Lq, H, D).to(dt) * live[:, :, None, None]
    ops.reset_launches()
    (out, grads), (ref, ref_grads) = _grads(
        lambda *a: ops.attention(*a, mask, D ** .5, is_self), (q, k, v), cot)
    assert ops.launches["attention"] == ops.launches["attention_bwd"] == 1
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    _assert_grads_close(grads, ref_grads, prec, ["dq", "dk", "dv"])


@pytest.mark.parametrize("prec", list(PRECS))
def test_attention_takes_its_dtypes_route(dev, prec):
    """bf16 launches the tensor-core kernels and fp32 the FMA kernels,
    forward and backward, and nothing else (kernel names in a profiler
    trace, taken again where it holds no device event): no library
    attention."""
    from medical_tri_modal_pilot_tpu_torch.kernels.attention import \
        attention_route
    dt = PRECS[prec]
    route = attention_route(dt, 64)
    assert route == {"bf16": "tc", "fp32": "fma"}[prec]
    q, k, v, mask, _, _ = _attn_case(dev, 4, 4, 24, 128, 64, "keys", dt,
                                     seed=12)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def step():
        out = ops.attention(*leaves, mask, 8.0)
        torch.autograd.grad(out, leaves, torch.ones_like(out))

    names = _launched(step)
    tc = ("attention_fwd_tc_kernel", "attention_delta_kernel",
          "attention_dkv_tc_kernel", "attention_dq_tc_kernel")
    fma = ("attention_fwd_kernel", "attention_dkv_kernel",
           "attention_dq_kernel")
    want, other = (tc, fma) if route == "tc" else (fma, tc)
    for kernel in want:
        assert any(kernel in n for n in names), (kernel, names)
    for kernel in other:
        assert not any(kernel in n for n in names), (kernel, names)
    assert not any("flash" in n.lower() or "fmha" in n.lower()
                   or "efficient_attention" in n.lower() for n in names)


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind",
                         [(4, 4, 24, 128, 64, "keys"),
                          (3, 2, 300, 300, 64, "self"),
                          (2, 2, 130, 70, 32, "block"),
                          (3, 2, 300, 300, 128, "self")])
def test_attention_backward_is_bit_identical(dev, B, H, Lq, Lk, D, kind):
    """The bf16 backward (delta pre-pass, dK/dV and dQ passes) repeats bit
    for bit: no float atomics."""
    dt = torch.bfloat16
    q, k, v, mask, is_self, live = _attn_case(dev, B, H, Lq, Lk, D, kind,
                                              dt, seed=13)
    g = torch.Generator().manual_seed(14)
    cot = _rand(g, dev, B, Lq, H, D).to(dt) * live[:, :, None, None]
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.attention(*leaves, mask, D ** .5, is_self)
    first = torch.autograd.grad(out, leaves, cot, retain_graph=True)
    again = torch.autograd.grad(out, leaves, cot)
    for name, a, e in zip(["dq", "dk", "dv"], first, again):
        assert torch.equal(a, e), name


def test_attention_smem_table_matches_the_kernels(dev):
    """The wrapper's shared-memory reckoning of each tensor-core kernel is
    the bytes its launcher asks for, and its blocks an SM those the
    kernel's launch bounds ask for, whose shared memory fits an SM."""
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.kernels.attention import (
        TC_KERNELS, tc_min_blocks, tc_smem_bytes)
    lib = _build.library()
    for dh in (32, 64, 128):
        table, blocks = tc_smem_bytes(dh), tc_min_blocks(dh)
        for i, name in enumerate(TC_KERNELS):
            assert lib.attention_tc_smem(i, dh) == table[name], name
            assert lib.attention_tc_min_blocks(i, dh) == blocks[name], name
            assert blocks[name] * (table[name] + 1024) <= _sm_smem(dev), name


def test_attention_refuses_what_it_does_not_take(dev):
    q = torch.zeros(2, 8, 2, 32, device=dev)
    k = torch.zeros(2, 12, 2, 32, device=dev)
    with pytest.raises(ValueError, match="head width"):
        cuda_masked_attention(q[..., :16].contiguous(),
                              k[..., :16].contiguous(),
                              k[..., :16].contiguous(), None, 4.0)
    strided = torch.zeros(2, 2, 8, 32, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_masked_attention(strided, k, k, None, 4.0)
    with pytest.raises(TypeError, match="dtype"):
        cuda_masked_attention(q, k.bfloat16(), k, None, 4.0)
    with pytest.raises(ValueError, match="mask"):
        cuda_masked_attention(q, k, k, torch.zeros(2, 8, dtype=torch.bool,
                                                   device=dev), 4.0)


@pytest.mark.parametrize("C,hw,images", [(32, 14, 2), (64, 14, 1),
                                          (96, 21, 2), (768, 7, 3)])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("prec", list(PRECS))
def test_swin_attention_kernel(dev, C, hw, images, shifted, prec):
    """[images * M, 49, C] windows, 32-wide heads, the shift mask of an
    hw x hw map (window i takes mask i % M)."""
    g = torch.Generator().manual_seed(3)
    dt = PRECS[prec]
    nh, M = C // 32, (hw // 7) ** 2
    xw = _rand(g, dev, images * M, 49, C).to(dt)
    ws = (_rand(g, dev, C, 3 * C, std=C ** -.5), _rand(g, dev, 3 * C, std=.1),
          _rand(g, dev, C, C, std=C ** -.5), _rand(g, dev, C, std=.1))
    bias = _rand(g, dev, nh, 49, 49, std=.5)
    smask = (torch.from_numpy(_shift_attn_mask(hw, hw, 7, 3)).to(dev)
             if shifted else None)
    out, ref = _both(lambda: ops.swin_attention(xw, *ws, bias, smask, nh))
    torch.testing.assert_close(out, ref, **TOL[prec])


def _launched(fn):
    """The names of the device events (kernels, copies) of ``fn``, from a
    profiler trace over three calls after one outside it: a lone short
    launch right after the trace starts can be missed; a trace with no
    device event at all, which the profiler gives now and then, is taken
    again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names


def _route_kernels(names, table, route):
    """Every kernel of ``route`` in ``names``, and none of another route's
    that is not also the route's."""
    for kernel in table[route]:
        assert any(kernel + "<" in n or kernel + "(" in n for n in names), \
            (route, kernel, names)
    others = {k for r, ks in table.items() if r != route for k in ks}
    for kernel in others - set(table[route]):
        assert not any(kernel + "<" in n or kernel + "(" in n
                       for n in names), (route, kernel, names)


# the kernels of each swin_mlp route (kernels/swin_mlp.py ROUTES)
SWIN_MLP_ROUTE_KERNELS = {
    "tc_fused": ("swin_mlp_tc_kernel",),
    "tc_split": ("swin_fc1_tc_kernel", "gemm_bf16_kernel"),
    "fma_fused": ("swin_mlp_kernel",),
    "fma_split": ("layer_norm_kernel", "gemm_kernel")}


@pytest.mark.parametrize("R,C", [(70, 32), (200, 96), (130, 192),
                                 (100, 384), (49, 768), (7, 32), (7, 96),
                                 (13, 192), (5, 384), (11, 768), (1617, 96),
                                 (1617, 192), (1617, 384), (1617, 768)])
@pytest.mark.parametrize("prec", list(PRECS))
def test_swin_mlp_kernel(dev, R, C, prec):
    """Ragged row counts (below one 16-row fragment, and stage 4's 1617
    trunk rows) at Swin-T's widths and C = 32, through each dtype's route
    (bf16: the fused tensor-core launch up to C = 256, two above; fp32:
    the fused FMA kernel at C = 96, three launches elsewhere), which must
    launch that route's kernels and no other's."""
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_mlp import \
        swin_mlp_route
    g = torch.Generator().manual_seed(4)
    dt = PRECS[prec]
    x = _rand(g, dev, R, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, 4 * C, std=C ** -.5), _rand(g, dev, 4 * C, std=.1),
          _rand(g, dev, 4 * C, C, std=(4 * C) ** -.5),
          _rand(g, dev, C, std=.1))
    out, ref = _both(lambda: ops.swin_mlp(x, *ws))
    torch.testing.assert_close(out, ref, **TOL[prec])
    with torch.inference_mode():
        names = _launched(lambda: ops.swin_mlp(x, *ws))
    _route_kernels(names, SWIN_MLP_ROUTE_KERNELS, swin_mlp_route(dt, C))


@pytest.mark.parametrize("prec", list(PRECS))
def test_swin_mlp_split_form_at_fused_width(dev, prec):
    """The split form (three FMA launches in fp32, two tensor-core launches
    in bf16), forced at the width the fused kernel takes, agrees with the
    plain version as the fused kernel does."""
    g = torch.Generator().manual_seed(5)
    dt, C = PRECS[prec], 96
    x = _rand(g, dev, 150, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, 4 * C, std=C ** -.5), _rand(g, dev, 4 * C, std=.1),
          _rand(g, dev, 4 * C, C, std=(4 * C) ** -.5),
          _rand(g, dev, C, std=.1))
    with torch.inference_mode():
        out = cuda_swin_mlp(x, *ws, split=True).float()
        names = _launched(lambda: cuda_swin_mlp(x, *ws, split=True))
    ref = torch_swin_mlp(x, *ws).float()
    torch.testing.assert_close(out, ref, **TOL[prec])
    _route_kernels(names, SWIN_MLP_ROUTE_KERNELS,
                   {"fp32": "fma_split", "bf16": "tc_split"}[prec])


def _small_argv(types):
    return ["--model", "tri_mbt_vsltcls", "--input-types", types,
            "--imgtxt-time", "1", "--output-type", "intubation",
            "--modality-inclusion", "train-missing_test-missing",
            "--batch-size", "4", "--TIE-len", "300",
            "--transformer-num-layers", "2", "--transformer-dim", "64",
            "--transformer-num-head", "2", "--precision", "fp32"]


def test_small_slice_on_both_paths(dev):
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    cfg = parse_config(_small_argv("vslt_txt"))
    tr = Trainer(cfg, get_model(cfg), dev)
    batch = synthetic_batch(cfg, 4, seed=1)
    ops.reset_launches()
    probs, loss, _ = tr.eval_step(batch)
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0) | {
        "umse": 1, "attn_block": 4, "ffn": 4}
    with ops.reference_path():
        ref, ref_loss, _ = tr.eval_step(batch)
    np.testing.assert_allclose(probs, ref, atol=1e-5)
    assert loss == pytest.approx(ref_loss, abs=1e-5)


@pytest.mark.parametrize("present_frac", [0.5, 0.75])
def test_small_trimodal_slice_on_both_paths(dev, present_frac):
    """Config 4's flags at a small MBT width with the full Swin-T: the
    packed trunk (2 of 4 images) and its overflow (3 of 4)."""
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    cfg = parse_config(_small_argv("vslt_img_txt"))
    model = get_model(cfg)
    tr = Trainer(cfg, model, dev)
    batch = synthetic_batch(cfg, 4, seed=2, present_frac=present_frac)
    ops.reset_launches()
    probs, loss, _ = tr.eval_step(batch)
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0) | {
        "umse": 1, "attn_block": 6, "ffn": 6, "swin_attention": 12,
        "swin_mlp": 12}
    assert model.trunk_rows == (3 if present_frac == 0.5 else 4)
    with ops.reference_path():
        ref, ref_loss, _ = tr.eval_step(batch)
    np.testing.assert_allclose(probs, ref, atol=1e-4)
    assert loss == pytest.approx(ref_loss, abs=1e-4)


@pytest.mark.parametrize("dropout", ["0", "0.1"])
def test_small_train_step_on_both_paths(dev, dropout):
    """One train step of config 2's flags (small width, fp32) on each path
    from the same weights: the launch counts, the loss and every
    gradient. The last layer's txt stream feeds only the bottleneck mix,
    which nothing reads after the last layer, so autograd runs no backward
    for it: 4 forward launches, 3 backward."""
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    cfg = parse_config(_small_argv("vslt_txt") + ["--dropout", dropout])
    batch = synthetic_batch(cfg, 4, seed=1)
    runs = []
    for plain in (False, True):
        tr = Trainer(cfg, get_model(cfg), dev, eval_only=False)
        ops.reset_launches()
        if plain:
            with ops.reference_path():
                loss = tr.train_step(batch)
        else:
            loss = tr.train_step(batch)
            masks = 2 if dropout != "0" else 0
            assert ops.launches == dict.fromkeys(ops.KERNELS, 0) | {
                "umse": 1, "umse_bwd": 1, "attn_block": 4,
                "attn_block_bwd": 3, "ffn": 4, "ffn_bwd": 3,
                "dropout_masks": masks}
        runs.append((loss, {n: p.grad.float() for n, p in
                            tr.model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert loss == pytest.approx(ref_loss, abs=1e-4)
    # true gradient 0, rounding noise on both paths: a key-projection bias
    # (softmax is shift invariant) and the biases the head's BatchNorm
    # cancels
    zero = ("key_proj.linear.bias", "fc_list.0.bias",
            "layer_norms_after_concat.bias")
    names = [n for n in grads if not n.endswith(zero)]
    _assert_grads_close([grads[n] for n in names],
                        [ref_grads[n] for n in names], "fp32", names)


def _cross_argv(dropout="0"):
    return ["--model", "cross_transformer_txt_vslt", "--input-types",
            "vslt_txt", "--vslt-type", "carryforward",
            "--output-type", "intubation",
            "--modality-inclusion", "train-missing_test-missing",
            "--batch-size", "4", "--transformer-num-layers", "2",
            "--transformer-dim", "64", "--transformer-num-head", "2",
            "--precision", "fp32", "--dropout", dropout]


@pytest.mark.parametrize("dropout", ["0", "0.1"])
def test_small_cross_transformer_on_both_paths(dev, dropout):
    """The cross transformer at a small width (1 self + 1 cross layer per
    stream), fp32: one eval step and one train step on each path from the
    same weights; the launch counts, probabilities, loss and every
    gradient."""
    from medical_tri_modal_pilot_tpu_torch.data.synthetic import \
        synthetic_batch
    from medical_tri_modal_pilot_tpu_torch.models import get_model
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer
    cfg = parse_config(_cross_argv(dropout))
    batch = synthetic_batch(cfg, 4, seed=1)
    tr = Trainer(cfg, get_model(cfg), dev)
    ops.reset_launches()
    probs, loss, _ = tr.eval_step(batch)
    assert ops.launches == dict.fromkeys(ops.KERNELS, 0) | {
        "attn_block": 2, "ffn": 4, "attention": 2}
    with ops.reference_path():
        ref, ref_loss, _ = tr.eval_step(batch)
    np.testing.assert_allclose(probs, ref, atol=1e-4)
    runs = []
    for plain in (False, True):
        tr = Trainer(cfg, get_model(cfg), dev, eval_only=False)
        ops.reset_launches()
        if plain:
            with ops.reference_path():
                loss = tr.train_step(batch)
        else:
            loss = tr.train_step(batch)
            assert ops.launches == dict.fromkeys(ops.KERNELS, 0) | {
                "attn_block": 2, "attn_block_bwd": 2, "ffn": 4,
                "ffn_bwd": 4, "attention": 2, "attention_bwd": 2}
        runs.append((loss, {n: p.grad.float() for n, p in
                            tr.model.named_parameters()}))
    (loss, grads), (ref_loss, ref_grads) = runs
    assert loss == pytest.approx(ref_loss, abs=1e-4)
    # true gradient 0 (softmax is shift invariant per query; the head's
    # BatchNorm cancels the biases of fc_list.0 and of the LayerNorm
    # before it): rounding noise on both paths
    zero = ("key_proj.linear.bias", "fc_list.0.bias", "final_ln.bias")
    names = [n for n in grads if not n.endswith(zero)]
    _assert_grads_close([grads[n] for n in names],
                        [ref_grads[n] for n in names], "fp32", names)


# Swin-T's stages at 224 x 224: (C, map side), windows per image M =
# (side / 7)^2; three images per case, an odd multiple of M windows
SWIN_STAGES = [(96, 56), (192, 28), (384, 14), (768, 7)]


@pytest.mark.parametrize("C,hw", SWIN_STAGES)
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("route", ["fused", "split"])
def test_swin_attention_tensor_core_routes(dev, C, hw, shifted, route):
    """The bf16 tensor-core routes against the plain version at each
    stage's width over 3 M windows, with and without the shift mask: the
    fused launch where the width has one (stage 1), the three launches at
    every width; one launch count per call."""
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_attention import (
        cuda_window_attention, swin_attention_route)
    if route == "fused" and swin_attention_route(torch.bfloat16, C) != "fused":
        with pytest.raises(ValueError, match="route"):
            cuda_window_attention(
                torch.zeros(1, 49, C, dtype=torch.bfloat16, device=dev),
                torch.zeros(C, 3 * C, device=dev),
                torch.zeros(3 * C, device=dev), torch.zeros(C, C, device=dev),
                torch.zeros(C, device=dev),
                torch.zeros(C // 32, 49, 49, device=dev), None, C // 32,
                route="fused")
        return
    g = torch.Generator().manual_seed(12)
    nh, M = C // 32, (hw // 7) ** 2
    xw = _rand(g, dev, 3 * M, 49, C).to(torch.bfloat16)
    ws = [_rand(g, dev, C, 3 * C, std=C ** -.5), _rand(g, dev, 3 * C, std=.1),
          _rand(g, dev, C, C, std=C ** -.5), _rand(g, dev, C, std=.1)]
    ws = [t.to(torch.bfloat16) for t in ws]
    bias = _rand(g, dev, nh, 49, 49, std=.5)
    smask = (torch.from_numpy(_shift_attn_mask(hw, hw, 7, 3)).to(dev)
             if shifted else None)
    ops.reset_launches()
    with torch.inference_mode():
        out = cuda_window_attention(xw, *ws, bias, smask, nh,
                                    route=route).float()
    assert ops.launches["swin_attention"] == 1
    with torch.inference_mode(), ops.reference_path():
        ref = ops.swin_attention(xw, *ws, bias, smask, nh).float()
    torch.testing.assert_close(out, ref, **TOL["bf16"])


def test_swin_attention_route_table_matches_the_kernel(dev):
    """The wrapper's shared-memory reckoning of the fused route is the
    kernel's own and fits the card; each route refuses the dtype it was
    not built for (the FMA loops take fp32, the tensor cores bf16)."""
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.kernels.swin_attention import (
        cuda_window_attention, fused_smem_bytes)
    assert _build.library().swin_attention_fused_smem() == fused_smem_bytes()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert fused_smem_bytes() <= limit
    ws = (torch.zeros(64, 192, device=dev), torch.zeros(192, device=dev),
          torch.zeros(64, 64, device=dev), torch.zeros(64, device=dev),
          torch.zeros(2, 49, 49, device=dev))
    for dt, route in ((torch.float32, "split"), (torch.bfloat16, "fma")):
        x = torch.zeros(2, 49, 64, dtype=dt, device=dev)
        with pytest.raises(ValueError, match="route"):
            cuda_window_attention(x, *ws, None, 2, route=route)


# the FFN backward's tile flags: (B, L, C, flags over the 64-row tiles of
# the flattened rows, or None): every tile dead; every tile live; a live
# tile inside an otherwise dead 256-row block (wgrad's old flag span);
# rows that are not a multiple of the tile, with dead tiles between live
# ones; and the txt (133 rows) and img (54 rows) streams of the config-4
# step at its width
FFN_BWD_CASES = {
    "all_dead": (2, 256, 256, [0] * 8),
    "all_live": (2, 256, 256, [1] * 8),
    "island": (2, 512, 64, [0, 1, 0, 0, 0, 0, 0, 0,
                            0, 0, 0, 0, 0, 0, 1, 0]),
    "ragged": (3, 133, 64, [1, 0, 1, 1, 0, 0, 1]),
    "txt": (5, 133, 256, None),
    "img": (5, 54, 256, None),
    "wide_ragged": (3, 133, 512, [1, 0, 1, 1, 0, 0, 1]),
    "mid_island": (2, 512, 128, [0, 1, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 1, 0]),
}


@pytest.mark.parametrize("case", list(FFN_BWD_CASES))
@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("prec", list(PRECS))
def test_ffn_backward_tile_flags(dev, case, p, prec):
    """The backward (the tensor-core tile pass for bf16) against autograd
    of the plain version, the cotangent zero on the rows of dead tiles as
    in the model. Then the tile pass alone, with its weight-sum operands
    (ln, dz, hd, dh) filled with NaN on the rows of dead tiles, which it
    leaves unwritten: the weight sums must not read them."""
    B, L, C, flags = FFN_BWD_CASES[case]
    g = torch.Generator().manual_seed(13)
    F, dt = 4 * C, PRECS[prec]
    R = B * L
    x = _rand(g, dev, B, L, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, F, std=C ** -.5), _rand(g, dev, F, std=.1),
          _rand(g, dev, F, C, std=F ** -.5), _rand(g, dev, C, std=.1))
    live = torch.ones(R, dtype=torch.bool, device=dev)
    valid = None
    if flags is not None:
        valid = torch.tensor(flags, dtype=torch.bool, device=dev)
        live = valid.repeat_interleave(64)[:R]
    live = live.reshape(B, L)
    cot = _rand(g, dev, B, L, C).to(dt) * live[:, :, None]
    ops.reset_launches()
    (out, grads), (ref, ref_grads) = _grads(
        lambda *a: ops.ffn(*a, valid, p=p, training=True, seed=99),
        (x, *ws), cot)
    assert ops.launches["ffn"] == ops.launches["ffn_bwd"] == 1
    torch.testing.assert_close(out[live], ref[live], **TOL[prec])
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    _assert_grads_close(grads, ref_grads, prec,
                        ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"])
    from medical_tri_modal_pilot_tpu_torch.kernels.ffn import (
        ffn_bwd_tiles, ffn_weight_sums)
    *_, ln, dz, hd, dh, _, flags8 = ffn_bwd_tiles(
        x, *ws[:5], valid, p, 99, cot)
    if flags8 is not None:
        dead = ~live.reshape(R)
        for t in (ln, dz, hd, dh):
            t[dead] = float("nan")
    sums = ffn_weight_sums(ln, dz, hd, dh, flags8)
    _assert_grads_close(sums, ref_grads[3:], prec,
                        ["dw1", "db1", "dw2", "db2"])


def test_wgrad_tensor_cores_repeat_bit_for_bit_and_match_the_fma_sums(dev):
    """The bf16 weight sums on the tensor cores are identical from run to
    run, and equal the FMA form's sums of the same values in fp32 (bf16
    widens exactly) within summation-order rounding: both add the same exact products in
    fp32, in another order, over ~1000 rows of unit-variance data (sums of
    |value| ~ 30, fp32 ulp ~ 2e-6 per addition)."""
    from medical_tri_modal_pilot_tpu_torch.kernels.wgrad import CHUNK_ROWS
    g = torch.Generator().manual_seed(14)
    R = 5000
    a = _rand(g, dev, R, 256).to(torch.bfloat16)
    b = _rand(g, dev, R, 1024).to(torch.bfloat16)
    flags = torch.rand(-(-R // CHUNK_ROWS), generator=g).to(dev) < 0.6
    valid = flags.to(torch.int8)
    first = wgrad(a, b, valid, CHUNK_ROWS)
    again = wgrad(a, b, valid, CHUNK_ROWS)
    fma = wgrad(a.float(), b.float(), valid, CHUNK_ROWS)
    for x, y, z in zip(first, again, fma):
        assert torch.equal(x, y)
        torch.testing.assert_close(x, z, rtol=1e-4, atol=1e-3)
    keep = flags.repeat_interleave(CHUNK_ROWS)[:R, None]
    am, bm = a.double() * keep, b.double() * keep
    torch.testing.assert_close(first[0], am.t() @ bm, rtol=1e-4, atol=1e-3,
                               check_dtype=False)
    torch.testing.assert_close(first[1], bm.sum(0), rtol=1e-4, atol=1e-3,
                               check_dtype=False)


def test_wgrad_reads_flags_at_their_own_span(dev):
    """Flags over 64-row tiles (the FFN's) and over 256-row blocks
    (rowmm's) each leave out exactly their rows, in both forms (bf16 on
    the tensor cores, fp32 FMAs): a live 64-row tile inside a dead 256-row
    block is summed; rows under dead flags may hold NaN."""
    g = torch.Generator().manual_seed(15)
    R = 1000
    for dt in (torch.bfloat16, torch.float32):
        a = _rand(g, dev, R, 64).to(dt)
        b = _rand(g, dev, R, 128).to(dt)
        for span, flags in ((64, [0, 1] + [0] * 13 + [1]),
                            (256, [0, 1, 0, 1])):
            keep = torch.tensor(flags, dtype=torch.bool,
                                device=dev).repeat_interleave(span)[:R]
            an = torch.where(keep[:, None], a, float("nan"))
            bn = torch.where(keep[:, None], b, float("nan"))
            dw, db = wgrad(an, bn, keep.new_tensor(flags).to(torch.int8),
                           span)
            am = a.double() * keep[:, None]
            bm = b.double() * keep[:, None]
            torch.testing.assert_close(dw, am.t() @ bm, rtol=1e-4,
                                       atol=1e-3, check_dtype=False)
            torch.testing.assert_close(db, bm.sum(0), rtol=1e-4, atol=1e-3,
                                       check_dtype=False)


def test_tensor_core_kernels_compile_to_mma(dev):
    """cuobjdump -sass of the built library: each bf16 tensor-core kernel
    issues HMMA (or HGMMA) instructions."""
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    code = _build.sass()
    for kernel in ("swin_fused_kernel", "window_attn_tc_kernel",
                   "gemm_bf16_kernel", "ffn_bwd_tc_kernel", "wgrad_tc_kernel",
                   "block_qkv_tc_kernel", "block_attn_tc_kernel",
                   "block_dkv_tc_kernel", "block_dq_tc_kernel",
                   "block_ln_bwd_tc_kernel", "attention_fwd_tc_kernel",
                   "attention_dkv_tc_kernel", "attention_dq_tc_kernel",
                   "ffn_fwd_tc_kernel", "swin_mlp_tc_kernel",
                   "swin_fc1_tc_kernel", "rowmm_tc_kernel",
                   "rowmm_bwd_tc_kernel", "ffn_ln_bwd_tc_kernel"):
        found = {n: c for n, c in code.items() if kernel in n}
        assert found, f"{kernel} not in the library"
        for name, text in found.items():
            assert "HMMA" in text or "HGMMA" in text, name
