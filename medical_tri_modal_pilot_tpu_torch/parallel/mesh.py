"""The (data, model) mesh of the processes and the tensor-parallel layout
(counterpart of medical_tri_modal_pilot_tpu/parallel/mesh.py).

Rank r sits at data index r // mp and model index r % mp, as the JAX
package reshapes its devices to (dp, mp): a model group is mp consecutive
ranks. This port covers dp = 1 (every rank one model shard, the batch
replicated over 'model'); dp > 1 raises.

Tensor-parallel layout (Megatron's column- then row-parallel pairs, the
JAX package's ``_tp_spec`` under the port's parameter names):
  * ``feed_forward.w_1`` Conv1d weight [F, C, 1] and its bias split on F;
  * ``feed_forward.w_2`` Conv1d weight [C, F, 1] split on F (its bias
    stays whole);
  * ``{query,key,value}_proj.linear`` weight [out, in] and bias split on
    out: each rank holds the q|k|v columns of its heads;
  * everything else (norms, stems, bottlenecks, the head and its
    BatchNorm, the frozen trunk) is replicated.
A dimension is split only when the model axis divides it.

The layers meet through three autograd collectives over the model group:
``copy_to_model`` (identity forward, all-reduce of the gradient backward),
``reduce_from_model`` (all-reduce forward, identity backward) and
``gather_from_model`` (all-gather of the last dimension forward, this
rank's slice of the gradient backward).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# name suffix, dimensions, split dimension
_SPLITS = [("feed_forward.w_1.weight", 3, 0), ("feed_forward.w_1.bias", 1, 0),
           ("feed_forward.w_2.weight", 3, 1)]
for _proj in ("query_proj", "key_proj", "value_proj"):
    _SPLITS += [(f"{_proj}.linear.weight", 2, 0),
                (f"{_proj}.linear.bias", 1, 0)]


def auto_dp_size(batch_size: int, n_devices: int) -> int:
    """Largest count <= n_devices that divides the batch."""
    for n in range(min(batch_size, n_devices), 0, -1):
        if batch_size % n == 0:
            return n
    return 1


def mesh_shape(dp_size: int, batch_size: Optional[int], mp_size: int,
               world: int) -> Tuple[int, int]:
    """(dp, mp) for ``world`` processes (JAX make_mesh's rule: dp_size 0
    means the largest batch-divisible count). Every process must hold a
    shard; dp > 1 is not ported."""
    mp = max(mp_size, 1)
    if world % mp:
        raise ValueError(f"--mp-size {mp} does not divide the {world} "
                         "processes")
    avail = world // mp
    if dp_size > 0:
        dp = dp_size
    elif batch_size is not None:
        dp = auto_dp_size(batch_size, avail)
    else:
        dp = avail
    if dp * mp != world:
        raise ValueError(f"a ({dp}, {mp}) mesh leaves some of the {world} "
                         "processes without a shard: adjust --batch-size, "
                         "--dp-size or --mp-size")
    if dp > 1:
        raise NotImplementedError(
            f"--dp-size {dp}: data parallelism (DDP, and the batch "
            "statistics a data-sharded BatchNorm needs) is ROADMAP Queue 1 "
            "item 8; the port runs dp = 1")
    return dp, mp


class Mesh:
    """This process's place in the (dp, mp) mesh and its model group."""

    def __init__(self, dp: int, mp: int, rank: int, model_group=None):
        self.dp, self.mp, self.rank = dp, mp, rank
        self.data_index, self.model_index = divmod(rank, mp)
        self.model_group = model_group


def make_mesh(dp_size: int = 0, batch_size: Optional[int] = None,
              mp_size: int = 0) -> Mesh:
    """The mesh over the processes of the group (one process: (1, 1))."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp, mp = mesh_shape(dp_size, batch_size, mp_size, world)
    if mp == 1:
        return Mesh(dp, mp, rank)
    group = None
    for d in range(dp):
        ranks = list(range(d * mp, (d + 1) * mp))
        g = dist.new_group(ranks)   # every rank takes part in every new_group
        if rank in ranks:
            group = g
    return Mesh(dp, mp, rank, group)


def _rule(name: str, ndim: int) -> Optional[int]:
    for suffix, n, dim in _SPLITS:
        if name.endswith(suffix) and ndim == n:
            return dim
    return None


def tp_spec(name: str, shape: Sequence[int], mp: int) -> Optional[int]:
    """The dimension tensor parallelism splits a parameter (or its
    optimizer moments) on, by name and full shape; None: replicated."""
    dim = _rule(name, len(shape))
    return dim if dim is not None and shape[dim] % mp == 0 else None


def shard_state_dict(sd: Mapping[str, torch.Tensor], mp: int, index: int
                     ) -> Dict[str, torch.Tensor]:
    """A full state_dict (the reference's layout) -> model rank ``index``'s
    shard of it."""
    out = {}
    for k, v in sd.items():
        dim = tp_spec(k, v.shape, mp)
        out[k] = v if dim is None else v.chunk(mp, dim)[index].clone()
    return out


def _all_gather_cat(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.mp)]
    dist.all_gather(parts, t, group=mesh.model_group)
    return torch.cat(parts, dim=dim)


def gather_state_dict(sd: Mapping[str, torch.Tensor], split: Mapping[str, int],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's shards -> the full state_dict, on every rank of the
    model group (a collective: every rank calls it with the same keys).
    ``split``: name -> dimension, as shard_model returns it."""
    return {k: (_all_gather_cat(v.detach(), split[k], mesh) if k in split
                else v) for k, v in sd.items()}


def shard_model(model: torch.nn.Module, mesh: Mesh) -> Dict[str, int]:
    """Cut every parameter that tp_spec splits down to this rank's shard, in
    place, and hand the mesh to each module whose split parameters make it
    tensor-parallel (the modules with a ``tp`` attribute: the attention and
    the FFN). Returns name -> split dimension. A module whose heads the
    model axis does not divide raises."""
    mp, index = mesh.mp, mesh.model_index
    split = {}
    if mp == 1:
        return split
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = tp_spec(name, p.shape, mp)
            if dim is not None:
                p.data = p.data.chunk(mp, dim)[index].contiguous()
                split[name] = dim
    for mname, mod in model.named_modules():
        if not hasattr(mod, "tp"):
            continue
        own = [n for n, p in mod.named_parameters(prefix=mname)
               if _rule(n, p.dim()) is not None]
        if not any(n in split for n in own):
            continue
        if getattr(mod, "num_heads", mp) % mp or not all(n in split
                                                         for n in own):
            raise NotImplementedError(
                f"{mname}: --mp-size {mp} must divide its heads and every "
                "width it splits")
        mod.tp = mesh
    return split


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.contiguous().clone()
            dist.all_reduce(g, group=ctx.mesh.model_group)
            out.append(g)
        return (None, *out)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.model_group)
        return y

    @staticmethod
    def backward(ctx, g):
        return None, g


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _all_gather_cat(x, -1, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return None, g.chunk(mesh.mp, -1)[mesh.model_index].contiguous()


def copy_to_model(mesh: Mesh, *xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Identity forward; the gradients all-reduced over the model group
    backward (Megatron's f): the entry of a column-parallel product."""
    return _CopyToModel.apply(mesh, *xs)


def reduce_from_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group forward; identity backward
    (Megatron's g): the exit of a row-parallel product."""
    return _ReduceFromModel.apply(mesh, x)


def gather_from_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The model group's last dimensions concatenated in rank order
    forward; this rank's slice of the gradient backward: the exit of
    head-parallel attention."""
    return _GatherFromModel.apply(mesh, x)
