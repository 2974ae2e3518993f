"""Rank bodies of the tensor-parallel CPU tests (tests/test_torch_tp.py),
started by ``medical_tri_modal_pilot_tpu_torch.parallel.launch`` over gloo.
Imports no jax: the launcher blocks it in every rank. Each body reads its
inputs from, and writes its results to, the directory it is given; rank 0
writes the shared results, every rank its replicated parameters."""
import copy
import json
import os
import sys

import numpy as np
import torch

from medical_tri_modal_pilot_tpu_torch import ops
from medical_tri_modal_pilot_tpu_torch.config import parse_config
from medical_tri_modal_pilot_tpu_torch.models import get_model
from medical_tri_modal_pilot_tpu_torch.models.modules import (
    DropoutSeeds, TransformerEncoderLayer, length_key_mask)
from medical_tri_modal_pilot_tpu_torch.parallel import mesh as M
from medical_tri_modal_pilot_tpu_torch.parallel.distributed import (
    maybe_init_distributed)
from medical_tri_modal_pilot_tpu_torch.train import checkpoints
from medical_tri_modal_pilot_tpu_torch.train.trainer import Trainer


def _start():
    assert sys.modules.get("jax") is None
    torch.set_num_threads(1)
    rank, world = maybe_init_distributed(None, "gloo")
    return rank, world


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def collectives(out: str) -> None:
    """Each collective against its definition, then an encoder layer cut
    over the ranks against the whole layer on the same inputs: output on
    live rows and every gradient (the split ones gathered), at dropout 0
    and 0.1, on a stream with 256-row blocks (the LN-fused projection) and
    on one without."""
    rank, world = _start()
    mesh = M.make_mesh(1, None, world)
    res = {}
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 8, generator=g)
    mine = x * (rank + 1)
    res["reduce"] = _rel(M.reduce_from_model(mesh, mine),
                         x * sum(range(1, world + 1)))
    xs = mine.clone().requires_grad_()
    y = M.gather_from_model(mesh, xs)
    cot = torch.randn(3, 8 * world, generator=g)
    y.backward(cot)
    res["gather"] = _rel(y, torch.cat([x * (r + 1) for r in range(world)], -1))
    res["gather_bwd"] = _rel(xs.grad, cot[:, 8 * rank:8 * (rank + 1)])
    leaf = mine.clone().requires_grad_()
    (c,) = M.copy_to_model(mesh, leaf)
    c.backward(torch.full_like(c, rank + 1.0))
    res["copy_bwd"] = _rel(leaf.grad,
                           torch.full_like(x, sum(range(1, world + 1))))

    D, H, F, B = 16, 2, 64, 2
    for L, lengths in ((512, [200, 512]), (130, [100, 7])):
        for p in (0.0, 0.1):
            torch.manual_seed(1)
            whole = TransformerEncoderLayer(D, H, F, p)
            with torch.no_grad():
                for prm in whole.parameters():
                    prm.normal_(0, 0.3)
            part = copy.deepcopy(whole)
            split = M.shard_model(part, mesh)
            whole.train()
            part.train()
            gx = torch.Generator().manual_seed(2)
            xin = torch.randn(B, L, D, generator=gx)
            mask = length_key_mask(torch.tensor(lengths), L)
            live = ~mask
            cot = torch.randn(B, L, D, generator=gx) * live[:, :, None]
            outs = []
            for layer in (whole, part):
                xi = xin.clone().requires_grad_()
                y = layer(xi, mask, DropoutSeeds(5, 3))
                (y * cot).sum().backward()
                grads = dict(layer.named_parameters())
                grads = {n: q.grad for n, q in grads.items()}
                if layer is part:
                    grads = M.gather_state_dict(grads, split, mesh)
                outs.append((y.detach(), xi.grad, grads))
            (y0, dx0, g0), (y1, dx1, g1) = outs
            tag = f"L{L}_p{p}"
            res[f"{tag}_out"] = _rel(y1[live], y0[live])
            res[f"{tag}_dx"] = _rel(dx1, dx0)
            # the key bias's true gradient is 0 (softmax is shift
            # invariant per query): both sides hold rounding noise there,
            # held to the layer's gradient scale
            scale = 1e-3 * max(float(g.abs().max()) for g in g0.values())
            for n in g0:
                err = float((g1[n] - g0[n]).abs().max())
                res[f"{tag}_{n}"] = err / max(float(g0[n].abs().max()),
                                              scale)
            res[f"{tag}_split"] = sorted(split)

    # LARS: a shard's trust ratio takes the norms of the whole tensor
    from medical_tri_modal_pilot_tpu_torch.train.trainer import Optimizer
    cfg = parse_config(["--optim", "sgd_lars", "--momentum", "0.8"])
    gw = torch.Generator().manual_seed(3)
    whole = [torch.randn(8, 6, generator=gw), torch.randn(5, generator=gw)]
    grads = [torch.randn_like(t) for t in whole]
    mine = [whole[0].chunk(world)[rank].clone(), whole[1].clone()]
    for params, gs, split in ((whole, grads, None),
                              (mine, [grads[0].chunk(world)[rank],
                                      grads[1]], [True, False])):
        params = [torch.nn.Parameter(t.clone()) for t in params]
        for prm, g in zip(params, gs):
            prm.grad = g.clone()
        Optimizer(cfg, params, split, mesh).step(0.1)
        if split is None:
            want = [params[0].detach().chunk(world)[rank], params[1].detach()]
        else:
            res["lars_shard"] = _rel(params[0].detach(), want[0])
            res["lars_whole"] = _rel(params[1].detach(), want[1])
    if rank == 0:
        with open(os.path.join(out, "collectives.json"), "w") as f:
            json.dump(res, f)


def _counting_rowmm(calls):
    orig = ops.rowskip_ln_affine

    def counted(*args, **kwargs):
        calls["rowmm_ln"] += 1
        return orig(*args, **kwargs)
    ops.rowskip_ln_affine = counted


def _trainer(cfg, mesh, init):
    model = get_model(cfg)
    model.load_state_dict(init)
    return Trainer(cfg, model, "cpu", eval_only=False, seed=7, mesh=mesh)


def _replicated(tr):
    return {n: p.detach().clone() for n, p in tr.model.named_parameters()
            if n not in tr.split}


def steps(out: str) -> None:
    """A run under --mp-size 2 from the whole weights in ``init.pt`` on the
    batches of ``batches.pt`` (argv in ``argv.json``): eval probabilities
    on batch 0, then a train step per batch (the gathered state after
    them), and, with ``single_step1.pth`` present, a TP checkpoint after
    step 1 and a resume from the single-process checkpoint of step 1."""
    rank, world = _start()
    with open(os.path.join(out, "argv.json")) as f:
        cfg = parse_config(json.load(f))
    mesh = M.make_mesh(cfg.dp_size, cfg.batch_size, cfg.mp_size)
    init = torch.load(os.path.join(out, "init.pt"))
    batches = torch.load(os.path.join(out, "batches.pt"), weights_only=False)
    calls = {"rowmm_ln": 0}
    _counting_rowmm(calls)
    tr = _trainer(cfg, mesh, init)
    probs, eval_loss, _ = tr.eval_step(batches[0])
    single = os.path.join(out, "single_step1.pth")
    losses, lrs = [], []
    for i, batch in enumerate(batches):
        lrs.append(tr.current_lr())
        losses.append(tr.train_step(batch))
        if i == 0 and os.path.exists(single):
            checkpoints.save_checkpoint(os.path.join(out, "tp_step1.pth"), tr,
                                        score=0.5, epoch=1, last_step=1)
    model_sd, opt_sd = tr.state_dicts()
    res = {"probs": probs, "eval_loss": eval_loss, "losses": losses,
           "lrs": lrs, "model": model_sd, "optimizer": opt_sd,
           "rowmm_ln": calls["rowmm_ln"], "split": tr.split}
    if os.path.exists(single):
        resumed = _trainer(cfg, mesh, init)
        checkpoints.restore(resumed, checkpoints.load_checkpoint(single))
        res["resumed_step"] = resumed.step
        res["resumed_losses"] = [resumed.train_step(b)
                                 for b in batches[resumed.step:]]
        res["resumed_model"], res["resumed_optimizer"] = \
            resumed.state_dicts()
    torch.save(_replicated(tr), os.path.join(out, f"replicated{rank}.pt"))
    if rank == 0:
        torch.save(res, os.path.join(out, "tp.pt"))


def fails(out: str) -> None:
    """Rank 1 raises; rank 0 then waits in a collective that never
    completes."""
    rank, world = _start()
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    t = torch.zeros(1)
    torch.distributed.all_reduce(t)
    np.save(os.path.join(out, "unreachable.npy"), t.numpy())
