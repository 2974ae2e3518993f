"""The kernel wrappers' choices that the CPU can hold: which route the
bf16 and fp32 paths take (tensor cores or FMA loops), the fused window
attention's, the attention block's and the masked attention's
shared-memory reckoning, the weight sums' row slicing, and the checks the
wrappers make before they reach the card."""
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch.kernels import (attention,
                                                       attn_block,
                                                       swin_attention, wgrad)


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


@pytest.mark.parametrize("C,H", [(64, 2), (64, 1), (128, 4), (256, 4),
                                 (256, 8), (512, 8), (768, 12)])
def test_attn_block_route_by_dtype_and_head_width(C, H):
    """fp32 keeps the FMA kernels at every width; bf16 takes the tensor
    cores at d_head 32 and 64."""
    assert C // H in attn_block.HEAD_DIMS
    assert attn_block.attn_block_route(torch.float32, C, H) == "fma"
    assert attn_block.attn_block_route(torch.bfloat16, C, H) == "tc"


@pytest.mark.parametrize("C,H", [(64, 4), (256, 2), (256, 3), (96, 0)])
def test_attn_block_route_refuses_other_head_widths(C, H):
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="d_head"):
            attn_block.attn_block_route(dt, C, H)


@pytest.mark.parametrize("C,dh", [(64, 32), (256, 64), (256, 32)])
def test_attn_block_tc_smem_within_the_card(C, dh):
    """Each tensor-core kernel's shared memory fits a block's 227 KB at the
    widths the backward is built for, and the projection backward (the
    largest, 109 KB at C = 256) and the projection fit two blocks in an
    SM's 228 KB (1 KB of it reserved per block), as their launch bounds
    ask."""
    table = attn_block.tc_smem_bytes(C, dh)
    assert set(table) == set(attn_block.TC_KERNELS)
    assert all(0 < v <= 232448 for v in table.values())
    for name in ("block_ln_bwd_tc_kernel", "block_qkv_tc_kernel"):
        assert 2 * (table[name] + 1024) <= 233472, name
    if C == 256:
        assert table["block_ln_bwd_tc_kernel"] == 111616
    assert table["block_attn_tc_kernel"] == 5 * 2 * 64 * (dh + 8)


def test_attn_block_wrapper_refuses_before_the_card():
    """A 3-D block mask, a head width no kernel is built for and weights
    of the wrong shape are refused in the wrapper, on any device."""
    B, L, C = 2, 70, 64
    x = torch.zeros(B, L, C, dtype=torch.bfloat16)
    gamma, beta = torch.ones(C), torch.zeros(C)
    w, b = torch.zeros(C, 3 * C), torch.zeros(3 * C)
    with pytest.raises(NotImplementedError, match="3-D"):
        attn_block.cuda_attn_block(x, gamma, beta, w, b,
                                   torch.zeros(B, L, L, dtype=torch.bool),
                                   4.0, 2)
    with pytest.raises(ValueError, match="d_head"):
        attn_block.cuda_attn_block(x, gamma, beta, w, b, None, 4.0, 4)
    with pytest.raises(ValueError, match="qkv weights"):
        attn_block.cuda_attn_block(x, gamma, beta, w[:, :C], b, None, 4.0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        attn_block.cuda_attn_block(x, gamma, beta, w, b, None, 4.0, 2)


@pytest.mark.parametrize("d_head", [32, 64])
def test_attention_route_by_dtype_and_head_width(d_head):
    """The masked attention: fp32 keeps the FMA kernels, bf16 takes the
    tensor cores, at both head widths the kernels are built for."""
    assert attention.attention_route(torch.float32, d_head) == "fma"
    assert attention.attention_route(torch.bfloat16, d_head) == "tc"


@pytest.mark.parametrize("d_head", [0, 16, 48, 96, 128])
def test_attention_route_refuses_other_head_widths(d_head):
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match=f"d_head.*got {d_head}"):
            attention.attention_route(dt, d_head)


@pytest.mark.parametrize("d_head", [32, 64])
def test_attention_tc_smem_within_the_card(d_head):
    """Each tensor-core kernel of the masked attention fits a block's
    227 KB, and as many blocks as its launch bounds ask for fit an SM's
    228 KB (1 KB of it reserved per block)."""
    # the blocks per SM of each kernel's __launch_bounds__
    min_blocks = {"attention_fwd_tc_kernel": 4, "attention_dkv_tc_kernel": 3,
                  "attention_dq_tc_kernel": 4}
    table = attention.tc_smem_bytes(d_head)
    assert tuple(table) == attention.TC_KERNELS
    for name, smem in table.items():
        assert 0 < smem <= 232448, name
        assert min_blocks[name] * (smem + 1024) <= 233472, name
    if d_head == 64:
        assert table["attention_fwd_tc_kernel"] == 46080
        assert table["attention_dkv_tc_kernel"] == 56832
