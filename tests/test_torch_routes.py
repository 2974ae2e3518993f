"""The kernel wrappers' choices that the CPU can hold: which route the
bf16 and fp32 paths take (tensor cores or FMA loops), the fused window
attention's, the attention block's, the masked attention's, the FFN
forward's, the Swin MLP's and the row-skipping projections' shared-memory
reckoning, the weight sums' row slicing, and the checks the wrappers make
before they reach the card (umse and the dropout masks' too)."""
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch.kernels import (attention,
                                                       attn_block, ffn,
                                                       rowmm,
                                                       swin_attention,
                                                       swin_mlp, umse, wgrad)

# a block's shared memory on an H100 (opt-in), an SM's (1 KB of it
# reserved per block)
BLOCK_SMEM, SM_SMEM = 232448, 233472


@pytest.mark.parametrize("C", [32, 64, 96, 192, 384, 768])
def test_swin_attention_route_by_dtype_and_width(C):
    """fp32 keeps the FMA kernels at every width; bf16 takes the fused
    tensor-core launch at the one width it is built for (Swin-T's stage 1,
    C = 96), else the three tensor-core launches."""
    assert swin_attention.swin_attention_route(torch.float32, C) == "fma"
    want = "fused" if C == 96 else "split"
    assert swin_attention.swin_attention_route(torch.bfloat16, C) == want


def test_swin_attention_fused_budget_at_stage_one():
    """w_qkv 96 x 288 (55 KB with its padding), w_proj, two windows' x and
    q|k|v, the three heads' fp32 bias: 203 KB of the 227 KB."""
    assert swin_attention.FUSED_WIDTH == 96
    assert swin_attention.fused_smem_bytes() == 208012
    assert swin_attention.fused_smem_bytes() <= 232448


@pytest.mark.parametrize("R,Ka,Nb", [(65536, 256, 1024), (65536, 1024, 256),
                                     (65536, 256, 768), (65536, 256, 128),
                                     (8512, 256, 1024), (3456, 256, 1024),
                                     (399, 64, 256), (64, 64, 64), (1, 64, 64)])
def test_wgrad_slices_are_whole_chunks(R, Ka, Nb):
    """Every slice starts on a multiple of the tensor-core form's 64-row
    chunk, the slices cover the rows exactly once, and the grid aims at
    four blocks per SM."""
    rows, slices = wgrad.slicing(R, Ka, Nb)
    assert rows % wgrad.CHUNK_ROWS == 0
    assert (slices - 1) * rows < R <= slices * rows
    tiles = (Ka // 64) * (Nb // 64)
    assert slices == 1 or tiles * (slices - 1) < wgrad.TARGET_BLOCKS


def test_wrappers_refuse_before_the_card():
    """The checks the wrappers make on any device: a dtype the weight sums
    have no form for, row flags of a span the chunks do not divide or of
    the wrong count, swin attention on CPU tensors."""
    a = torch.zeros(300, 64)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        wgrad.wgrad(a.half(), a.half())
    flags = torch.ones(10, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 64"):
        wgrad.wgrad(a.bfloat16(), a.bfloat16(), flags, 32)
    with pytest.raises(ValueError, match="flags"):
        wgrad.wgrad(a.bfloat16(), a.bfloat16(), flags, 64)
    xw = torch.zeros(2, 49, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        swin_attention.cuda_window_attention(
            xw, torch.zeros(64, 192), torch.zeros(192), torch.zeros(64, 64),
            torch.zeros(64), torch.zeros(2, 49, 49), None, 2)


def test_wgrad_refuses_mismatched_cotangent_parts():
    """B in parts: more than three, parts of different widths or rows, or
    a width that is not whole 64-column tiles are refused before the
    card."""
    a = torch.zeros(300, 64, dtype=torch.bfloat16)
    part = torch.zeros(300, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        wgrad.wgrad(a, [part] * 4)
    with pytest.raises(ValueError, match="do not match"):
        wgrad.wgrad(a, [part, torch.zeros(300, 128, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="do not match"):
        wgrad.wgrad(a, [part, part[:200]])
    with pytest.raises(ValueError, match="multiples of 64"):
        wgrad.wgrad(a, [part[:, :32]] * 3)


@pytest.mark.parametrize("C,H", [(64, 2), (64, 1), (128, 4), (256, 4),
                                 (256, 8), (512, 8), (256, 2), (512, 4)])
def test_attn_block_route_by_dtype_and_head_width(C, H):
    """fp32 keeps the FMA kernels at every width; bf16 takes the tensor
    cores, at C 64, 128, 256 and 512 and d_head 32, 64 and 128."""
    assert C in attn_block.WIDTHS and C // H in attn_block.HEAD_DIMS
    assert attn_block.attn_block_route(torch.float32, C, H) == "fma"
    assert attn_block.attn_block_route(torch.bfloat16, C, H) == "tc"


@pytest.mark.parametrize("C,H", [(64, 4), (768, 12), (256, 3), (96, 0),
                                 (128, 8), (512, 2), (192, 3)])
def test_attn_block_route_refuses_other_head_widths(C, H):
    """d_head 16 and 256, a width outside 64/128/256/512 (768, 192), heads
    that do not divide C, no heads: refused in both dtypes."""
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="d_head"):
            attn_block.attn_block_route(dt, C, H)


@pytest.mark.parametrize("C,dh", [(64, 32), (256, 64), (256, 32), (128, 32),
                                  (512, 128), (256, 128), (512, 64)])
def test_attn_block_tc_smem_within_the_card(C, dh):
    """Each tensor-core kernel's shared memory fits a block's 227 KB at
    every width and head width, and as many blocks as its launch bounds
    ask for (two projections up to C = 256, one at 512, where the
    projection backward takes 201 KB; the flash loops' two at d_head 128)
    fit an SM's 228 KB (1 KB of it reserved per block)."""
    table = attn_block.tc_smem_bytes(C, dh)
    blocks = attn_block.tc_min_blocks(C, dh)
    assert set(table) == set(attn_block.TC_KERNELS) == set(blocks)
    assert all(0 < v <= 232448 for v in table.values())
    for name, smem in table.items():
        assert blocks[name] * (smem + 1024) <= 233472, name
    assert blocks["block_qkv_tc_kernel"] == (1 if C == 512 else 2)
    if C == 256:
        assert table["block_ln_bwd_tc_kernel"] == 111616
    if C == 512:
        assert table["block_ln_bwd_tc_kernel"] == 205824
    assert table["block_attn_tc_kernel"] == 5 * 2 * 64 * (dh + 8)


def test_attn_block_wrapper_refuses_before_the_card():
    """A mask of the wrong shape (2-D or 3-D), a head width no kernel is
    built for and weights of the wrong shape are refused in the wrapper,
    on any device; a [B, L, L] block mask passes the wrapper's checks and
    reaches the device check."""
    B, L, C = 2, 70, 64
    x = torch.zeros(B, L, C, dtype=torch.bfloat16)
    gamma, beta = torch.ones(C), torch.zeros(C)
    w, b = torch.zeros(C, 3 * C), torch.zeros(3 * C)
    for shape in ((B, L, L - 1), (B, L + 1, L + 1), (B, L - 1)):
        with pytest.raises(ValueError, match="key mask"):
            attn_block.cuda_attn_block(x, gamma, beta, w, b,
                                       torch.zeros(shape, dtype=torch.bool),
                                       4.0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.cuda_attn_block(x, gamma, beta, w, b,
                                   torch.zeros(B, L, L, dtype=torch.bool),
                                   4.0, 2)
    with pytest.raises(ValueError, match="d_head"):
        attn_block.cuda_attn_block(x, gamma, beta, w, b, None, 4.0, 4)
    with pytest.raises(ValueError, match="qkv weights"):
        attn_block.cuda_attn_block(x, gamma, beta, w[:, :C], b, None, 4.0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.cuda_attn_block(x, gamma, beta, w, b, None, 4.0, 2)


@pytest.mark.parametrize("d_head", [32, 64, 128])
def test_attention_route_by_dtype_and_head_width(d_head):
    """The masked attention: fp32 keeps the FMA kernels, bf16 takes the
    tensor cores, at the three head widths the kernels are built for."""
    assert attention.attention_route(torch.float32, d_head) == "fma"
    assert attention.attention_route(torch.bfloat16, d_head) == "tc"


@pytest.mark.parametrize("d_head", [0, 16, 48, 96, 8, 256])
def test_attention_route_refuses_other_head_widths(d_head):
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"d_head.*got {d_head}"):
            attention.attention_route(dt, d_head)


@pytest.mark.parametrize("d_head", [32, 64, 128])
def test_attention_tc_smem_within_the_card(d_head):
    """Each tensor-core kernel of the masked attention fits a block's
    227 KB, and as many blocks as its launch bounds ask for (4 / 3 / 4 up
    to d_head 64, 2 at 128) fit an SM's 228 KB (1 KB of it reserved per
    block)."""
    min_blocks = attention.tc_min_blocks(d_head)
    assert tuple(min_blocks) == attention.TC_KERNELS
    assert min_blocks["attention_dkv_tc_kernel"] == (2 if d_head == 128
                                                     else 3)
    table = attention.tc_smem_bytes(d_head)
    assert tuple(table) == attention.TC_KERNELS
    for name, smem in table.items():
        assert 0 < smem <= 232448, name
        assert min_blocks[name] * (smem + 1024) <= 233472, name
    if d_head == 64:
        assert table["attention_fwd_tc_kernel"] == 46080
        assert table["attention_dkv_tc_kernel"] == 56832
    if d_head == 128:
        assert table["attention_fwd_tc_kernel"] == 87040


@pytest.mark.parametrize("C", [64, 256, 128, 512])
def test_ffn_route_by_dtype_and_width(C):
    """The FFN: fp32 keeps the FMA kernels, bf16 takes the tensor cores,
    at the four model widths; at 512 each dtype's split route, bf16's on
    the wgmma mainloop."""
    split = C == ffn.SPLIT_WIDTH
    assert ffn.ffn_route(torch.float32, C) == \
        ("fma_split" if split else "fma")
    assert ffn.ffn_route(torch.bfloat16, C) == \
        ("wgmma_split" if split else "tc")


@pytest.mark.parametrize("C", [0, 32, 96, 192, 384, 768])
def test_ffn_route_refuses_other_widths(C):
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"C in .*got C={C}"):
            ffn.ffn_route(dt, C)


@pytest.mark.parametrize("C,want", [(64, 55552), (256, 209920),
                                    (128, 107008)])
def test_ffn_tc_smem_within_the_card(C, want):
    """The fused tensor-core forward's 128 normalised rows and its
    two-stage W1/W2 chunk ring, and the fused tile pass, fit a block's
    227 KB at the fused widths (209920 bytes forward at C = 256), and as
    many blocks as their launch bounds ask for fit an SM (two forward
    blocks at C = 64)."""
    assert ffn.TC_ROWS == 128
    smem = ffn.tc_smem_bytes(C)
    assert smem == want
    table = {"ffn_fwd_tc_kernel": smem,
             "ffn_bwd_tc_kernel": ffn.bwd_tc_smem_bytes(C)}
    blocks = ffn.tc_min_blocks(C)
    for name, v in table.items():
        assert 0 < v <= BLOCK_SMEM, name
        assert blocks[name] * (v + 1024) <= SM_SMEM, name
    assert blocks["ffn_fwd_tc_kernel"] == (2 if C <= 96 else 1)


def test_ffn_split_smem_within_the_card():
    """At C = 512 the fused tiles would outgrow a block (the forward's
    410 KB, the tile pass's 433 KB), so the width takes the split route,
    whose fp32 LN backward (202 KB on the FMAs) fits one block an SM; the
    bf16 products run on the wgmma mainloop, one persistent block an SM,
    its bytes read from the C entry on the card."""
    C = ffn.SPLIT_WIDTH
    assert ffn.tc_smem_bytes(C) > BLOCK_SMEM
    assert ffn.bwd_tc_smem_bytes(C) > BLOCK_SMEM
    table = ffn.split_smem_bytes()
    assert ffn.SPLIT_KERNELS == ("wg_gemm_kernel", "ffn_ln_bwd_kernel")
    assert table == {"ffn_ln_bwd_kernel": 206336}
    assert table["ffn_ln_bwd_kernel"] + 1024 <= SM_SMEM
    assert ffn.tc_min_blocks(C) == {"wg_gemm_kernel": 1,
                                    "ffn_ln_bwd_rows_kernel": 1}
    assert max(table.values()) <= BLOCK_SMEM


@pytest.mark.parametrize("C,fused", [(32, True), (64, True), (96, True),
                                     (128, True), (160, True), (192, True),
                                     (224, True), (256, True), (288, False),
                                     (384, False), (768, False),
                                     (1024, False)])
def test_swin_mlp_route_by_dtype_and_width(C, fused):
    """bf16 takes the fused tensor-core launch up to C = 256 (Swin-T's
    stages 1 and 2) and the two tensor-core launches above (stages 3 and
    4), or at any width when the split form is asked for; fp32 keeps the
    fused FMA kernel at C = 96 and the three FMA launches elsewhere."""
    bf16 = torch.bfloat16
    assert swin_mlp.swin_mlp_route(bf16, C) == ("tc_fused" if fused
                                                else "tc_split")
    assert swin_mlp.swin_mlp_route(bf16, C, split=True) == "tc_split"
    assert swin_mlp.swin_mlp_route(torch.float32, C) == (
        "fma_fused" if C == 96 else "fma_split")
    assert swin_mlp.swin_mlp_route(torch.float32, C, split=True) == \
        "fma_split"
    assert set(swin_mlp.ROUTES) == {"fma_fused", "fma_split", "tc_fused",
                                    "tc_split"}


@pytest.mark.parametrize("C", [0, 16, 48, 100, 200, 2048])
def test_swin_mlp_route_refuses_other_widths(C):
    """Widths that are not a multiple of 32, in either dtype; in bf16 also
    one whose LN tile outgrows a block's shared memory (the FMA loops
    stage the LN a row per warp and take it)."""
    dts = (torch.bfloat16,) if C % 32 == 0 else (torch.float32,
                                                 torch.bfloat16)
    for dt in dts:
        with pytest.raises(ValueError, match=f"C % 32 == 0.*got C={C}"):
            swin_mlp.swin_mlp_route(dt, C)
    if C == 2048:
        assert swin_mlp.swin_mlp_route(torch.float32, C) == "fma_split"


@pytest.mark.parametrize("C", list(range(32, 1600, 32)))
def test_swin_mlp_tc_smem_within_the_card(C):
    """The bf16 route's LN-fused kernel fits a block's 227 KB at every
    width the route takes (the fused tile loop up to C = 256, two blocks
    an SM up to 96 as its launch bounds ask; the split form's fc1 above:
    its LN rows [64][C] and a three-stage W1 ring of 26 KB)."""
    smem = swin_mlp.tc_smem_bytes(C)
    assert 0 < smem <= BLOCK_SMEM
    if C <= 96:
        assert 2 * (smem + 1024) <= SM_SMEM
    known = {96: 81280, 192: 158464, 256: 209920, 384: 76288, 768: 125440}
    if C in known:
        assert smem == known[C]


def _ffn_args(C=64, F=256, R=130, dt=torch.bfloat16):
    return (torch.zeros(R, C, dtype=dt), torch.ones(C), torch.zeros(C),
            torch.zeros(C, F, dtype=dt), torch.zeros(F, dtype=dt),
            torch.zeros(F, C, dtype=dt), torch.zeros(C, dtype=dt))


def test_ffn_wrapper_refuses_before_the_card():
    """A dtype, a width or a d_ff no kernel takes, weights of the wrong
    shape and flags of the wrong count are refused in the wrapper, on any
    device, before the library is built or the card touched; a CPU tensor
    with a valid shape is refused last."""
    x, g, b, w1, b1, w2, b2 = _ffn_args()
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ffn.cuda_ffn(x.half(), g, b, w1, b1, w2, b2)
    with pytest.raises(ValueError, match="C in"):
        ffn.cuda_ffn(*_ffn_args(C=96, F=384))
    with pytest.raises(ValueError, match="d_ff % 64"):
        ffn.cuda_ffn(*_ffn_args(F=96))
    with pytest.raises(ValueError, match="weights"):
        ffn.cuda_ffn(x, g, b, w1, b1, w2[:128], b2)
    with pytest.raises(ValueError, match="flags"):
        ffn.cuda_ffn(x, g, b, w1, b1, w2, b2,
                     torch.ones(2, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        ffn.cuda_ffn(x, g, b, w1, b1, w2, b2,
                     torch.ones(3, dtype=torch.bool))


def test_swin_mlp_wrapper_refuses_before_the_card():
    """swin_mlp: a dtype, a width or a hidden width no kernel takes, x not
    [R, C] and weights of the wrong shape are refused in the wrapper; a CPU
    tensor with a valid shape is refused last."""
    C = 96
    x = torch.zeros(70, C, dtype=torch.bfloat16)
    ws = (torch.ones(C), torch.zeros(C), torch.zeros(C, 4 * C),
          torch.zeros(4 * C), torch.zeros(4 * C, C), torch.zeros(C))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        swin_mlp.cuda_swin_mlp(x.half(), *ws)
    with pytest.raises(ValueError, match=r"x \[R, C\]"):
        swin_mlp.cuda_swin_mlp(x[None], *ws)
    with pytest.raises(ValueError, match="C % 32"):
        swin_mlp.cuda_swin_mlp(x[:, :80], *ws)
    with pytest.raises(ValueError, match="multiple of 64"):
        swin_mlp.cuda_swin_mlp(x, ws[0], ws[1], ws[2][:, :100], ws[3][:100],
                               ws[4][:100], ws[5])
    with pytest.raises(ValueError, match="weights"):
        swin_mlp.cuda_swin_mlp(x, ws[0], ws[1], ws[2], ws[3], ws[4][:128],
                               ws[5])
    with pytest.raises(ValueError, match="CUDA"):
        swin_mlp.cuda_swin_mlp(x, *ws)


@pytest.mark.parametrize("Cin", [64, 256, 128, 512])
def test_rowmm_route_by_dtype_and_width(Cin):
    """The row-skipping projections: fp32 keeps the FMA kernels, bf16 takes
    the tensor cores, at the four input widths the kernels are built for
    (no bf16 width falls back to the FMA loops)."""
    assert rowmm.rowmm_route(torch.float32, Cin) == "fma"
    assert rowmm.rowmm_route(torch.bfloat16, Cin) == "tc"


@pytest.mark.parametrize("Cin", [0, 32, 96, 192, 384, 768])
def test_rowmm_route_refuses_other_widths(Cin):
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"Cin in .*got Cin={Cin}"):
            rowmm.rowmm_route(dt, Cin)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        rowmm.rowmm_route(torch.float16, 64)


@pytest.mark.parametrize("Cin,want", [(64, (61440, 40960, 30720)),
                                      (256, (86016, 111616, 76800)),
                                      (128, (69632, 64512, 46080)),
                                      (512, (118784, 205824, 138240))])
def test_rowmm_tc_smem_within_the_card(Cin, want):
    """The tensor-core forward's 64 rows of x and its three-stage W ring,
    and the backward's ring (with x and the StdLN stats in the LN form),
    fit a block's 227 KB at every width, and as many blocks as their
    launch bounds ask for (two up to Cin 256, one at 512) fit an SM's
    228 KB (1 KB of it reserved per block). They are the attention
    block's projection kernels' bytes: the same loops."""
    table = rowmm.rowmm_tc_smem(Cin)
    blocks = rowmm.tc_min_blocks(Cin)
    assert tuple(table) == rowmm.TC_KERNELS == tuple(blocks)
    assert tuple(table.values()) == want
    for name, smem in table.items():
        assert 0 < smem <= BLOCK_SMEM, name
        assert blocks[name] * (smem + 1024) <= SM_SMEM, name
    assert set(blocks.values()) == {1 if Cin == 512 else 2}
    if Cin in attn_block.WIDTHS:
        block = attn_block.tc_smem_bytes(Cin, 64)
        assert table["rowmm_tc_kernel"] == block["block_qkv_tc_kernel"]
        assert table["rowmm_bwd_tc_kernel (LN)"] == \
            block["block_ln_bwd_tc_kernel"]


def test_rowmm_wrapper_refuses_before_the_card():
    """A dtype or an input width no kernel takes, weights of the wrong
    shape and output widths that are not whole 64-column tiles (each third
    in the LN form) are refused in the wrapper, on any device, before the
    library is built or the card touched; a CPU tensor with a valid shape
    is refused last."""
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    vec = torch.ones(64)
    w, b = torch.zeros(64, 192), torch.zeros(192)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        rowmm.cuda_rowskip_affine(x.half(), w, b)
    with pytest.raises(ValueError, match="Cin in"):
        rowmm.cuda_rowskip_affine(torch.zeros(2, 8, 96), w, b)
    with pytest.raises(ValueError, match=r"w \[Cin, Cout\]"):
        rowmm.cuda_rowskip_affine(x, torch.zeros(32, 192), b)
    with pytest.raises(ValueError, match="multiples of 64"):
        rowmm.cuda_rowskip_affine(x, torch.zeros(64, 96), torch.zeros(96))
    with pytest.raises(ValueError, match="multiples of 64"):
        rowmm.cuda_rowskip_ln_affine(x, vec, vec, torch.zeros(64, 128),
                                     torch.zeros(128))
    with pytest.raises(ValueError, match="CUDA"):
        rowmm.cuda_rowskip_affine(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        rowmm.cuda_rowskip_ln_affine(x, vec, vec, w, b)


def _umse_args(D=64, n_ids=20):
    x = torch.zeros(2, 9, 3)
    vecs = [torch.zeros(1, D)] + [torch.zeros(D)] * 3
    return [x, *vecs, *vecs, torch.zeros(n_ids, D)]


def test_umse_wrappers_refuse_before_the_card():
    """The umse forward and backward: x not fp32 [B, L, 3], a compute dtype
    other than fp32 and bf16, a width no kernel is built for, stem vectors
    of another width, a table of another width or larger than the kernels'
    shared-memory budget, a cotangent of the wrong shape or dtype are
    refused in the wrapper, on any device, before the library is built or
    the card touched; CPU tensors with valid shapes are refused last."""
    args = _umse_args()
    x, rest = args[0], args[1:]
    dout = torch.zeros(2, 9, 64, dtype=torch.bfloat16)
    for call in (lambda *a: umse.cuda_umse(*a),
                 lambda *a: umse.cuda_umse_bwd(*a[:-1], dout, a[-1])):
        with pytest.raises(ValueError, match=r"fp32 \[B, L, 3\]"):
            call(x.double(), *rest, torch.bfloat16)
        with pytest.raises(ValueError, match=r"fp32 \[B, L, 3\]"):
            call(x[..., :2], *rest, torch.bfloat16)
        with pytest.raises(TypeError, match="fp32 or bf16"):
            call(x, *rest, torch.float16)
        with pytest.raises(ValueError, match="D in"):
            call(*_umse_args(D=96), torch.bfloat16)
        with pytest.raises(ValueError, match="hold 64 values"):
            call(x, *rest[:2], torch.zeros(32), *rest[3:], torch.bfloat16)
        with pytest.raises(ValueError, match=r"\[n_ids, 64\]"):
            call(x, *rest[:-1], torch.zeros(20, 32), torch.bfloat16)
        with pytest.raises(ValueError, match="exceeds"):
            call(*_umse_args(D=256, n_ids=49), torch.bfloat16)
    assert umse.MAX_TABLE_BYTES == 48 * 1024
    for bad in (dout.float(), dout[:, :8]):
        with pytest.raises(ValueError, match="cotangent"):
            umse.cuda_umse_bwd(*args, bad, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        umse.cuda_umse(*args, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        umse.cuda_umse_bwd(*args, dout, torch.bfloat16)


def test_dropout_masks_wrapper_refuses_before_the_card():
    """Negative sizes or a negative column offset are refused on any
    device; a CPU device with valid sizes is refused last."""
    for bad in ((-1, 0, 256, 0), (64, -4, 256, 0), (64, 0, -1, 0),
                (64, 512, 256, -512)):
        with pytest.raises(ValueError, match=">= 0"):
            ffn.cuda_dropout_masks(*bad[:3], 5, 0.1, "cpu", col0=bad[3])
    with pytest.raises(ValueError, match="CUDA"):
        ffn.cuda_dropout_masks(64, 512, 256, 5, 0.1, "cpu", col0=512)
