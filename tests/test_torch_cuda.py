"""The port's CUDA and Triton kernels against their plain PyTorch versions
on the card, at the small widths of the CPU tests (d_head 32, C 64) and at
the flagship's (d_head 64, C 256; Swin-T's C 96-768): forwards, the
backward kernels against autograd of the plain versions, the dropout
masks bit for bit; the masked attention of the cross-modal layers at
every mask form; and the small eval and train steps (vslt+txt, and
vslt+img+txt with the full Swin-T; the cross transformer) on both paths;
the row-skipping projections of tensor parallelism and the dropout masks'
column offset.
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
# points, one rounding flip and the fp32 probabilities of the kernel
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


@pytest.mark.parametrize("L,C,H", [(54, 64, 2), (130, 64, 2),
                                   (300, 256, 4)])
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


@pytest.mark.parametrize("C", [64, 256])
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


@pytest.mark.parametrize("L,C,H", [(54, 64, 2), (130, 64, 2),
                                   (300, 256, 4)])
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


@pytest.mark.parametrize("C", [64, 256])
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


@pytest.mark.parametrize("R,F,C", [(300, 256, 64), (1000, 0, 256),
                                   (65, 1024, 256)])
def test_dropout_masks_kernel_is_bit_identical(dev, R, F, C):
    for seed, p in ((5, 0.1), (2 ** 63 - 1, 0.5)):
        got = ops.dropout_masks(R, F, C, seed, p, dev)
        want = plain_dropout_masks(R, F, C, seed, p, dev)
        for a, e in zip(got, want):
            assert torch.equal(a, e)


@pytest.mark.parametrize("col0,F", [(0, 64), (1, 7), (5, 64), (512, 512)])
def test_dropout_masks_kernel_takes_the_column_offset(dev, col0, F):
    """A rank's hidden mask (F columns from col0) is bit for bit the
    plain version's and those columns of the kernel's whole mask; offset 0
    is the kernels' own mask."""
    R, C, p, seed = 300, 64, 0.1, 2 ** 40 + 5
    part = ops.dropout_masks(R, F, C, seed, p, dev, col0=col0)
    whole = ops.dropout_masks(R, col0 + F, C, seed, p, dev)
    want = plain_dropout_masks(R, F, C, seed, p, dev, col0=col0)
    assert torch.equal(part[0], want[0]) and torch.equal(part[1], want[1])
    assert torch.equal(part[0], whole[0][:, col0:])
    assert torch.equal(part[1], whole[1])


# rowmm: (B, L, Cin, Cout, lengths): small widths with a dead 256-row block
# and a ragged row count, and the tensor-parallel rank's widths (Cin 256,
# one rank's q|k|v of 384) with an all-dead sample
ROWMM_CASES = [(2, 512, 64, 192, (200, 512)), (1, 130, 64, 192, None),
               (3, 512, 256, 384, (0, 100, 512))]


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
    x = torch.zeros(2, 8, 64, device=dev)
    args = (torch.ones(64, device=dev), torch.zeros(64, device=dev),
            torch.zeros(64, 192, device=dev), torch.zeros(192, device=dev))
    with pytest.raises(NotImplementedError, match="3-D"):
        cuda_attn_block(x, *args, torch.zeros(2, 8, 8, dtype=torch.bool,
                                              device=dev), 4.0, 2)


# masked attention: (B, H, Lq, Lk, d_head, mask): the cross-modal layers'
# [24] x [128] keys and back, no mask, a key mask with padding mid-sequence,
# a sample whose keys are all masked, a block mask, a self-attention whose
# later q tiles are dead
ATTN_CASES = [(4, 4, 24, 128, 64, "keys"), (4, 4, 128, 24, 64, "keys"),
              (3, 2, 54, 54, 32, "none"), (3, 2, 130, 130, 32, "noncontig"),
              (3, 2, 40, 100, 32, "all_masked"),
              (2, 2, 130, 70, 32, "block"), (3, 2, 300, 300, 64, "self")]


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


@pytest.mark.parametrize("R,C", [(70, 32), (200, 96), (130, 192),
                                 (100, 384), (49, 768)])
@pytest.mark.parametrize("prec", list(PRECS))
def test_swin_mlp_kernel(dev, R, C, prec):
    """Ragged row counts, on the fused width (C 96) and on the
    three-launch path (C 32, 192, 384, 768)."""
    g = torch.Generator().manual_seed(4)
    dt = PRECS[prec]
    x = _rand(g, dev, R, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, 4 * C, std=C ** -.5), _rand(g, dev, 4 * C, std=.1),
          _rand(g, dev, 4 * C, C, std=(4 * C) ** -.5),
          _rand(g, dev, C, std=.1))
    out, ref = _both(lambda: ops.swin_mlp(x, *ws))
    torch.testing.assert_close(out, ref, **TOL[prec])


@pytest.mark.parametrize("prec", list(PRECS))
def test_swin_mlp_split_form_at_fused_width(dev, prec):
    """The three-launch form, forced at the width the fused kernel takes,
    agrees with the plain version as the fused kernel does."""
    g = torch.Generator().manual_seed(5)
    dt, C = PRECS[prec], 96
    x = _rand(g, dev, 150, C).to(dt)
    ws = (_rand(g, dev, C, std=.1, mean=1.), _rand(g, dev, C, std=.1),
          _rand(g, dev, C, 4 * C, std=C ** -.5), _rand(g, dev, 4 * C, std=.1),
          _rand(g, dev, 4 * C, C, std=(4 * C) ** -.5),
          _rand(g, dev, C, std=.1))
    with torch.inference_mode():
        out = cuda_swin_mlp(x, *ws, split=True).float()
    ref = torch_swin_mlp(x, *ws).float()
    torch.testing.assert_close(out, ref, **TOL[prec])


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
                "umse": 1, "attn_block": 4, "attn_block_bwd": 3, "ffn": 4,
                "ffn_bwd": 3, "dropout_masks": masks}
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
