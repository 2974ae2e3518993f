"""The kernel wrappers' choices that the CPU can hold: which route the
bf16 and fp32 paths take (tensor cores or FMA loops), the fused window
attention's shared-memory reckoning, the weight sums' row slicing, and the
checks the wrappers make before they reach the card."""
import pytest
import torch

from medical_tri_modal_pilot_tpu_torch.kernels import swin_attention, wgrad


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
