"""Device time per call of the bf16 attention kernels of the PyTorch/CUDA
port, by kernel name, from torch.profiler, on one NVIDIA GPU. Two
measurements, each importing the port from the tree given, so that a
parent and a change can be held against each other on one card:

    # parent's package beside the change, then runs in turns
    git archive HEAD medical_tri_modal_pilot_tpu_torch | tar -x -C build/parent
    python tools/chip_attention_ab.py build build/parent   # compile only
    for r in build/parent . . build/parent; do
        python tools/chip_attention_ab.py steps $r; done
    python tools/chip_attention_ab.py masks .

``steps``: the attn_block training forward and backward at [64, 1024,
256] (4 heads) and the tensor-parallel self attention at [64, 1024, 2,
64], both under TIE-like key masks (lengths uniform in [10, 1005]),
forward and backward, 20 of each after a warm-up; one line per kernel
whose name holds ``block_`` or ``attention``. ``masks``: the attention
at [64, 1024, 2, 64] and scaled_dot_product_attention on the same
inputs under several key-length draws (the TIE one, every key valid, a
fixed 512, the TIE lengths sorted either way): how much of the time is
the work the mask leaves and how much the imbalance between samples.
Each tree builds its kernels into its own build/torch_kernels.
"""
from __future__ import annotations

import os
import subprocess
import sys


def _profile(fns, reps: int):
    """Device ms per call of each CUDA event the calls launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    out = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            out.append((e.key, us / reps / 1e3, e.count / reps))
    return out


def main() -> None:
    what, root = sys.argv[1], os.path.abspath(sys.argv[2])
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from medical_tri_modal_pilot_tpu_torch import ops
    from medical_tri_modal_pilot_tpu_torch.kernels import _build
    from medical_tri_modal_pilot_tpu_torch.models.modules import \
        length_key_mask
    if what == "build":
        _build.library()
        return
    if not torch.cuda.is_available():
        sys.exit("chip_attention_ab: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(1)
    bf = torch.bfloat16
    B, L = 64, 1024
    tag = os.path.basename(root.rstrip("/")) or root

    def rnd(*shape, std=1.0, mean=0.0):
        return (mean + std * torch.randn(*shape, generator=g)).to(dev)

    tie = torch.randint(5, 1001, (B,), generator=g) + 5
    qkv = [rnd(B, L, 2, 64).to(bf).requires_grad_(True) for _ in range(3)]
    cot = rnd(B, L, 2, 64).to(bf)

    def attention(mask):
        def run():
            out = ops.attention(*qkv, mask, 8.0, True)
            torch.autograd.grad(out, qkv, cot)
        return run

    if what == "steps":
        D, H = 256, 4
        mask = length_key_mask(tie.to(dev), L)
        blk = [rnd(B, L, D).to(bf), rnd(D, std=.1, mean=1.),
               rnd(D, std=.1), rnd(D, 3 * D, std=D ** -.5).to(bf),
               rnd(3 * D, std=.1).to(bf)]
        blk = [t.requires_grad_(True) for t in blk]
        dy = rnd(B, L, D).to(bf)

        def block():
            out = ops.attn_block(*blk, mask, 8.0, H)
            torch.autograd.grad(out, blk, dy)

        for key, ms, n in _profile([block, attention(mask)], reps=20):
            if "block_" in key or "attention" in key:
                print(f"ab {tag} {ms:.4f} ms/call x{n:.0f} {key[:70]}")
        return
    lengths = {"tie": tie, "full": torch.full((B,), L),
               "half": torch.full((B,), 512),
               "tie_sorted": tie.sort(descending=True).values,
               "tie_ascending": tie.sort().values}
    qt = [t.detach().transpose(1, 2).contiguous().requires_grad_(True)
          for t in qkv]
    for name, n in lengths.items():
        mask = length_key_mask(n.to(dev), L)
        keep = ~mask[:, None, None, :]

        def sdpa():
            out = F.scaled_dot_product_attention(*qt, attn_mask=keep)
            torch.autograd.grad(out, qt, cot.transpose(1, 2).contiguous())

        ours = _profile([attention(mask)], reps=10)
        lib = _profile([sdpa], reps=10)
        print(f"masks {name}: " + "; ".join(
            f"{k.split('<')[0].split()[-1]} {ms:.4f}" for k, ms, _ in ours))
        print(f"masks {name} sdpa total {sum(ms for _, ms, _ in lib):.4f} ms")


if __name__ == "__main__":
    main()
