"""UMSE TIE-token embedding, per token

    relu(LN(value*Wv + bv)) + relu(LN(time*Wt + bt)) + table[feat_id],

as a plain PyTorch version (``torch_umse``) and the CUDA kernels of
``csrc/umse.cu``: the forward, and a backward that writes the nine
parameter gradients in one pass over the rows and a fixed-order sum of the
blocks' partials. ``torch_umse_bwd`` is that backward's closed form in plain
PyTorch, rounded where the kernel rounds: the kernel's oracle on the card.
On the CPU the gradient stays autograd of ``torch_umse``.

Counterpart of medical_tri_modal_pilot_tpu/kernels/umse.py (``xla_umse`` and
``pallas_umse``, whose backward is jax.vjp of xla_umse): the affines run in
the compute dtype, the LayerNorm statistics (biased variance, eps 1e-5) in
fp32, the table row is added in fp32 and the sum is cast to the compute
dtype once.
"""
from __future__ import annotations

import functools

import torch

from . import _build
from ._util import count, dtype_code, needs_grad, stream

LN_EPS = 1e-5    # torch nn.LayerNorm default (the reference stems)
# the widths the kernels are built for (a warp a row, D / 32 columns a lane)
WIDTHS = (32, 64, 128, 256)
# the table's bytes, which each block stages in shared memory
# (csrc/umse.cu kUmseMaxTableBytes)
MAX_TABLE_BYTES = 48 * 1024
# the backward takes one block an SM, and at least this many rows a block
BWD_BLOCK_ROWS = 256


def _stem_parts(x_col, w, b, scale, bias, dtype):
    """One stem before its relu, for a column of scalars x_col [R, 1] and
    w [1, D]: (E[h^2] - mu^2 before its clamp, 1 / sqrt(var + eps), the
    normalised n, y = n * scale + bias), h = x * w + b in ``dtype``."""
    h = x_col.to(dtype) * w.to(dtype)[0][None, :] + b.to(dtype)[None, :]
    h32 = h.float()
    mu = h32.mean(dim=-1, keepdim=True)
    var = (h32 * h32).mean(dim=-1, keepdim=True) - mu * mu
    rs = torch.rsqrt(var.clamp_min(0.0) + LN_EPS)
    n = (h32 - mu) * rs
    return var, rs, n, n * scale.float()[None, :] + bias.float()[None, :]


def stem(x_col, w, b, scale, bias, dtype):
    """relu(LN(x*w + b)) for a column of scalars x_col [R, 1]; w [1, D]."""
    return _stem_parts(x_col, w, b, scale, bias, dtype)[3].clamp_min(0.0)


def _ids(x, n_ids: int):
    """The one-hot [R, n_ids] fp32 of the feature ids: zeros for an id
    outside the table, as the TPU kernel's one-hot product gives."""
    fid = x[:, :, 2].to(torch.int64).reshape(-1)
    return (fid[:, None] == torch.arange(n_ids, device=fid.device)).float()


def torch_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """x: [B, L, 3] (time, value, feat_id) fp32 -> [B, L, D] in ``dtype``."""
    B, L, _ = x.shape
    D = wv.shape[1]
    t = x[:, :, 0].reshape(B * L, 1)
    v = x[:, :, 1].reshape(B * L, 1)
    ev = stem(v, wv, bv, sv, bbv, dtype)
    et = stem(t, wt, bt, st, bbt, dtype)
    # the table row as a one-hot product, as the TPU kernel computes it:
    # exact in fp32, zeros for an id outside the table, and a backward that
    # is one product (the gather's index backward serialises the 64000
    # rows that share 20 ids)
    ef = _ids(x, table.shape[0]) @ table.float()
    return (ev + et + ef).to(dtype).reshape(B, L, D)


def torch_umse_bwd(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dout, dtype):
    """The gradients of torch_umse's output for the cotangent ``dout``
    [B, L, D] with respect to (wv, bv, sv, bbv, wt, bt, st, bbt, table),
    fp32, shaped as those: the closed form the backward kernel computes,
    rounded where it rounds. Per stem: dy = dout where y > 0, dn = dy *
    scale, dh = rs (dn - mean(dn) - n mean(dn n)) (the last term only where
    E[h^2] - mu^2 >= 0, which its clamp passes), rounded to ``dtype`` where
    the JAX vjp rounds it (the h.astype(f32) cast); dW = sum dh x, db = sum
    dh, dscale = sum dy n, dbias = sum dy, in fp32. The table row of each
    id gets dout; an id outside the table gives nothing."""
    B, L, _ = x.shape
    D = wv.shape[1]
    g = dout.reshape(B * L, D).float()
    grads = []
    for col, w, b, scale, bias in ((1, wv, bv, sv, bbv), (0, wt, bt, st, bbt)):
        a = x[:, :, col].reshape(B * L, 1)
        var, rs, n, y = _stem_parts(a, w, b, scale, bias, dtype)
        dy = torch.where(y > 0, g, 0.0)
        dn = dy * scale.float()[None, :]
        m1 = dn.mean(dim=-1, keepdim=True)
        m2 = torch.where(var >= 0, (dn * n).mean(dim=-1, keepdim=True), 0.0)
        dh = (rs * (dn - m1 - n * m2)).to(dtype).float()
        grads += [(dh * a.to(dtype).float()).sum(0)[None], dh.sum(0),
                  (dy * n).sum(0), dy.sum(0)]
    grads.append(_ids(x, table.shape[0]).t() @ g)
    return grads


class _UMSE(torch.autograd.Function):
    """The forward kernel; the backward kernel writes the gradients."""

    @staticmethod
    def forward(ctx, x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
        args = _operands(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype)
        ctx.save_for_backward(*args)
        ctx.shapes = [t.shape for t in (wv, bv, sv, bbv, wt, bt, st, bbt,
                                        table)]
        ctx.dtype = dtype
        return _launch_fwd(*args, dtype)

    @staticmethod
    def backward(ctx, dout):
        grads = _launch_bwd(*ctx.saved_tensors, dout, ctx.dtype)
        return (None, *(g.view(s) if need else None for g, s, need in
                        zip(grads, ctx.shapes, ctx.needs_input_grad[1:10])),
                None)


def cuda_umse(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    """Launch the forward kernel on CUDA tensors, through the autograd
    Function when a gradient is needed (x is data and gets none). A
    feature id outside the table embeds as zeros, as the TPU kernel's
    one-hot product does."""
    args = (x, wv, bv, sv, bbv, wt, bt, st, bbt, table)
    if needs_grad(*args):
        return _UMSE.apply(*args, dtype)
    return _launch_fwd(*_operands(*args, dtype), dtype)


def cuda_umse_bwd(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dout, dtype):
    """The backward kernel on CUDA tensors: torch_umse_bwd's gradients,
    shaped as the parameters."""
    args = (wv, bv, sv, bbv, wt, bt, st, bbt, table)
    grads = _launch_bwd(*_operands(x, *args, dtype, dout), dout, dtype)
    return [g.view(t.shape) for g, t in zip(grads, args)]


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t itself when it is fp32 and contiguous, as the model's parameters
    are; else an fp32 contiguous copy."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _operands(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype,
              dout=None):
    """x [B, L, 3], the eight stem vectors and the table as the kernels take
    them (fp32, contiguous, on x's card), after the checks the kernels
    need: shapes and dtypes (and the cotangent's, when given) first, on
    any device, then the device."""
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != 3:
        raise ValueError(f"umse takes fp32 [B, L, 3], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"umse emits fp32 or bf16, got {dtype}")
    D = wv.shape[-1]
    if D not in WIDTHS:
        raise ValueError(f"the CUDA umse kernels take D in {WIDTHS}, got "
                         f"D={D}")
    vecs = [_f32(p) for p in (wv, bv, sv, bbv, wt, bt, st, bbt)]
    if any(p.numel() != D for p in vecs):
        raise ValueError(f"umse stem parameters must hold {D} values")
    if table.dim() != 2 or table.shape[1] != D or table.shape[0] == 0:
        raise ValueError(f"umse table must be [n_ids, {D}], got "
                         f"{tuple(table.shape)}")
    if table.numel() * 4 > MAX_TABLE_BYTES:
        raise ValueError(f"umse table [{table.shape[0]}, {D}] exceeds the "
                         f"kernels' {MAX_TABLE_BYTES} bytes of fp32")
    if dout is not None:
        _check_cot(x, D, dout, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"cuda_umse needs CUDA tensors, got {x.device}")
    table = _f32(table)
    for p in vecs + [table]:
        if p.device != x.device:
            raise ValueError(f"umse operands on {p.device}, x on {x.device}")
    return [_f32(x), *vecs, table]


def _launch_fwd(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dtype):
    B, L, _ = x.shape
    D = wv.shape[-1]
    out = torch.empty(B, L, D, dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _build.library().umse_fwd(
        x.data_ptr(), *(p.data_ptr() for p in (wv, bv, sv, bbv, wt, bt, st,
                                                bbt)),
        table.data_ptr(), out.data_ptr(), B * L, D, table.shape[0],
        dtype_code(dtype), stream(x))
    _build.check(rc, "umse")
    count("umse")
    return out


def _check_cot(x, D: int, dout, dtype) -> None:
    want = (*x.shape[:2], D)
    if tuple(dout.shape) != want or dout.dtype != dtype:
        raise ValueError(f"umse cotangent must be {dtype} {want}, got "
                         f"{dout.dtype} {tuple(dout.shape)}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_bwd(x, wv, bv, sv, bbv, wt, bt, st, bbt, table, dout, dtype):
    """Flat fp32 gradients: wv, bv, sv, bbv, wt, bt, st, bbt [D] each and
    table [n_ids, D], as views of one buffer."""
    B, L, _ = x.shape
    R, D, n_ids = B * L, wv.shape[-1], table.shape[0]
    if R == 0:
        flat = torch.zeros((8 + n_ids) * D, dtype=torch.float32,
                           device=x.device)
    else:
        flat = torch.empty((8 + n_ids) * D, dtype=torch.float32,
                           device=x.device)
        dout = dout.contiguous()
        if dout.data_ptr() % 16:
            dout = dout.clone()
        blocks = max(1, min(_sm_count(x.device.index or 0),
                            -(-R // BWD_BLOCK_ROWS)))
        part = torch.empty(blocks, flat.numel(), dtype=torch.float32,
                           device=x.device)
        rc = _build.library().umse_bwd(
            x.data_ptr(), *(p.data_ptr() for p in (wv, bv, sv, bbv, wt, bt,
                                                    st, bbt)),
            dout.data_ptr(), part.data_ptr(), flat.data_ptr(), R, D, n_ids,
            blocks, dtype_code(dtype), stream(x))
        _build.check(rc, "umse_bwd")
        count("umse_bwd")
    return [*flat[:8 * D].view(8, D), flat[8 * D:].view(n_ids, D)]
