"""Build and bind the CUDA C++ kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one
process per source, all started together, and the objects are linked into
one shared library with a plain C interface, which is loaded with ctypes.
The library's file name carries a hash of the sources and flags, so an edit
rebuilds it and a stale build is never loaded. The build directory is
resolved from this file (``<repo>/build/torch_kernels``), not from the
working directory.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_uint64
_U32 = ctypes.c_uint32
# C entry points: name -> (argtypes); each returns an int: the launchers
# cudaGetLastError(), the *_smem entries a byte count, the *_min_blocks
# entries the blocks an SM a kernel's launch bounds ask for
_SIGNATURES = {
    # x, gamma, beta, w, bias, mask, tmap, kend, qkv, out, attn, stats, B,
    # L, C, H, block, mult, dtype, stream
    "attn_block_fwd": [_P] * 12 + [_I] * 5 + [_F, _I, _P],
    # mask, map, B, Lq, Lk, stream
    "attn_block_tile_map": [_P] * 2 + [_I] * 3 + [_P],
    # x, gamma, beta, w, bias, kend, qkv, B, L, C, dtype, stream
    "attn_block_qkv": [_P] * 7 + [_I] * 4 + [_P],
    # x, gamma, beta, w, mask, tmap, kend, attn, stats, dy, qkv, delta,
    # dqkv, ln_o, dx, gpart, B, L, C, H, block, mult, dtype, stream
    "attn_block_bwd": [_P] * 16 + [_I] * 5 + [_F, _I, _P],
    # kernel, C, dh -> shared-memory bytes of a tensor-core kernel
    "attn_block_tc_smem": [_I] * 3,
    "attn_block_tc_min_blocks": [_I] * 3,
    # x, gamma, beta, w1, b1, w2, b2, valid, y, R, C, F, seed, thr, q_t,
    # drop, row0, dtype, stream
    "ffn_fwd": [_P] * 9 + [_I] * 3 + [_U64, _U32, _F, _I, _I, _I, _P],
    # C -> shared-memory bytes of the tensor-core forward
    "ffn_tc_smem": [_I],
    "ffn_tc_min_blocks": [_I] * 2,
    # x, gamma, beta, w1, b1, w2, valid, dy, dx, ln_o, dz_o, hd_o, dh_o,
    # gpart, R, C, F, seed, thr, q_t, q_f, drop, row0, dtype, stream
    "ffn_bwd": [_P] * 14 + [_I] * 3 + [_U64, _U32, _F, _F, _I, _I, _I, _P],
    # x, gamma, beta, w1, b1, w2, b2, valid, ln, hidden, y, R, C, F, seed,
    # thr, q_t, drop, row0, dtype, stream
    "ffn_split_fwd": [_P] * 11 + [_I] * 3 + [_U64, _U32, _F, _I, _I, _I,
                                            _P],
    # as ffn_bwd, with the fp32 dln scratch before gpart
    "ffn_split_bwd": [_P] * 15 + [_I] * 3 + [_U64, _U32, _F, _F, _I, _I, _I,
                                            _P],
    # a, b, R, Ka, Nb, valid, part, colpart, rows_per_slice, S, stream
    "ffn_split_wsum": [_P] * 2 + [_I] * 3 + [_P] * 3 + [_I] * 2 + [_P],
    # kernel -> shared-memory bytes of the split route's LN backward
    "ffn_split_smem": [_I],
    "ffn_split_min_blocks": [_I],
    # k1, k2, R, F, C, col0, row0, seed, thr, stream
    "dropout_masks": [_P] * 2 + [_I] * 5 + [_U64, _U32, _P],
    # x, wv, bv, sv, bbv, wt, bt, st, bbt, table, out, R, D, n_ids, dtype,
    # stream
    "umse_fwd": [_P] * 11 + [_I] * 4 + [_P],
    # x, wv, bv, sv, bbv, wt, bt, st, bbt, dout, part, grads, R, D, n_ids,
    # blocks, dtype, stream
    "umse_bwd": [_P] * 12 + [_I] * 5 + [_P],
    # A, B0, B1, B2, R, Ka, Nb, Bcs, rows_per_slice, S, part, colpart,
    # valid, flag_rows, dtype, stream
    "wgrad_partials": [_P] * 4 + [_I] * 6 + [_P] * 3 + [_I] * 2 + [_P],
    # part, S, N, out, stream
    "col_sum": [_P, _I, _I, _P, _P],
    # xw, wqkv, bqkv, wproj, bproj, bias, smask, qkv, heads, out, I, C, M,
    # scale, dtype, route, stream
    "swin_attention_fwd": [_P] * 10 + [_I] * 3 + [_F, _I, _I, _P],
    # () -> shared-memory bytes of the fused route
    "swin_attention_fused_smem": [],
    # qkv, bqkv, dov, bias, smask, heads, dqkv, part, I, C, M, G, scale,
    # dtype, stream
    "swin_attention_bwd": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    # x, scale, bias, w1, b1, w2, b2, ln, hidden, y, R, C, F, route, stream
    "swin_mlp_fwd": [_P] * 10 + [_I] * 4 + [_P],
    # C -> shared-memory bytes of the bf16 route's LN-fused kernel
    "swin_mlp_tc_smem": [_I],
    # x, scale, bias, w1, b1, w2, dy, ln, g, dh, dln, dx, gpart, R, C, F,
    # rows_per_block, dtype, stream
    "swin_mlp_bwd": [_P] * 13 + [_I] * 5 + [_P],
    # q, k, v, mask, out, stats, B, Lq, Lk, H, dh, mode, is_self, mult,
    # dtype, stream
    "attention_fwd": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # q, k, v, out, stats, dout, mask, delta, dq, dk, dv, B, Lq, Lk, H, dh,
    # mode, is_self, mult, dtype, stream
    "attention_bwd": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
    # kernel, dh -> shared-memory bytes of a tensor-core kernel
    "attention_tc_smem": [_I] * 2,
    "attention_tc_min_blocks": [_I] * 2,
    # x, gamma, beta, w, b, valid, out0, out1, out2, R, Cin, Cout, Cs, ln,
    # dtype, stream
    "rowmm_fwd": [_P] * 9 + [_I] * 6 + [_P],
    # x, gamma, beta, w, valid, dy0, dy1, dy2, dx, ln_o, gpart, R, Cin, Cout,
    # Cs, ln, dtype, stream
    "rowmm_bwd": [_P] * 11 + [_I] * 6 + [_P],
    # kernel, Cin -> shared-memory bytes of a tensor-core kernel
    "rowmm_tc_smem": [_I] * 2,
    "rowmm_tc_min_blocks": [_I] * 2,
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    sources, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources + headers:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libmtp_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the errors of any that
    fail."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failed = []
    try:
        for cmd, proc in zip(cmds, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{err}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def _compile(out: Path) -> None:
    sources, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private directory, then rename: a concurrent reader
    # never sees a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(sources, objs)])
        lib = Path(tmp) / out.name
        _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib), *objs]])
        os.replace(lib, out)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if needed."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def sass() -> dict:
    """The built library's machine code by kernel: {mangled name: its SASS
    text}, from the CUDA toolkit's cuobjdump (beside nvcc)."""
    tool = Path(nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(library_path())],
                          capture_output=True, text=True, check=True).stdout
    parts = re.split(r"Function : (\S+)", text)
    return dict(zip(parts[1::2], parts[2::2]))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
