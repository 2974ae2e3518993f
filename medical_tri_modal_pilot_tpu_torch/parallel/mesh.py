"""The (data, model) mesh of the processes and the tensor-parallel layout
(counterpart of medical_tri_modal_pilot_tpu/parallel/mesh.py).

Rank r sits at data index r // mp and model index r % mp, as the JAX
package reshapes its devices to (dp, mp): a model group is mp consecutive
ranks, a data group the dp ranks of one model index (r % mp equal). A
model group holds one shard of the batch (rows d B / dp .. (d + 1) B / dp
of data index d) and computes on it as one tensor-parallel model; the
data groups sum what the JAX package's global arrays sum: the losses and
their counts, the BatchNorm statistics and the gradients.

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

Data parallelism has two over the data group. Each rank back-propagates
its own share of the global loss (the global loss over dp, every rank
computing the same global loss), so the sum of the ranks' gradients is
the gradient of the global loss: ``data_sum`` (all-reduce forward and
backward: every rank's share reads the sum) and ``gather_from_data``
(all-gather of the first dimension forward, the all-reduced gradient's
slice of this rank backward). A module that needs them holds the mesh in
its ``dp`` attribute (``mark_data_parallel``): the BatchNorms and the
AUXCPC models' auxiliary loss.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .distributed import gather_global

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
    shard, and dp must divide the batch."""
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
    if batch_size is not None and batch_size % dp:
        raise ValueError(f"--dp-size {dp} does not divide --batch-size "
                         f"{batch_size}")
    return dp, mp


class Mesh:
    """This process's place in the (dp, mp) mesh, its model group (the
    ranks of its data index) and its data group (the ranks of its model
    index)."""

    def __init__(self, dp: int, mp: int, rank: int, model_group=None,
                 data_group=None):
        self.dp, self.mp, self.rank = dp, mp, rank
        self.data_index, self.model_index = divmod(rank, mp)
        self.model_group = model_group
        self.data_group = data_group

    def shard_rows(self, n: int) -> slice:
        """The rows of an n-row global batch that this rank's model group
        computes on (equal shards in data order)."""
        if n % self.dp:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{self.dp} equal data shards")
        per = n // self.dp
        return slice(self.data_index * per, (self.data_index + 1) * per)


def group_ranks(dp: int, mp: int) -> Tuple[List[List[int]], List[List[int]]]:
    """(model groups, data groups) of a (dp, mp) mesh: the rows and the
    columns of the ranks laid out as a [dp, mp] array."""
    model = [list(range(d * mp, (d + 1) * mp)) for d in range(dp)]
    data = [list(range(m, dp * mp, mp)) for m in range(mp)]
    return model, data


def _groups(rank: int, sets) -> Optional[object]:
    """A new group per rank set (every rank takes part in every
    new_group, in one order); the one that holds ``rank``."""
    mine = None
    for ranks in sets:
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


def make_mesh(dp_size: int = 0, batch_size: Optional[int] = None,
              mp_size: int = 0) -> Mesh:
    """The mesh over the processes of the group (one process: (1, 1)):
    the model groups under mp > 1, the data groups under dp > 1."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp, mp = mesh_shape(dp_size, batch_size, mp_size, world)
    model_sets, data_sets = group_ranks(dp, mp)
    model = _groups(rank, model_sets) if mp > 1 else None
    data = _groups(rank, data_sets) if dp > 1 else None
    return Mesh(dp, mp, rank, model, data)


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
    the FFN). Returns name -> split dimension. A module whose width the
    model axis does not divide keeps its parameters whole and runs whole
    on every rank; an attention whose heads it does not divide splits its
    q|k|v columns and computes every head on every rank (as the JAX
    package does)."""
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
        if not all(n in split for n in own):
            raise NotImplementedError(
                f"{mname}: --mp-size {mp} splits some of its widths and "
                "not others")
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


def data_parallel(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh`` has more than one data rank."""
    return mesh is not None and mesh.dp > 1


def mark_data_parallel(model: torch.nn.Module, mesh: Mesh) -> None:
    """Hand the mesh to the modules that reduce over the data group: every
    BatchNorm (global batch statistics) and every module with a ``dp``
    attribute (the AUXCPC models' auxiliary loss)."""
    for mod in model.modules():
        if (isinstance(mod, torch.nn.modules.batchnorm._BatchNorm)
                or hasattr(mod, "dp")):
            mod.dp = mesh


class _DataSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.data_group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.data_group)
        return None, g


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return gather_global(x, mesh.data_group)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = g.contiguous().clone()
        dist.all_reduce(g, group=mesh.data_group)
        return None, g.chunk(mesh.dp, 0)[mesh.data_index].contiguous()


def data_sum(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group forward; the sum of the ranks'
    gradients backward (each rank's share of a global quantity reads the
    whole sum). ``x`` itself without data parallelism."""
    return _DataSum.apply(mesh, x) if data_parallel(mesh) else x


def gather_from_data(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The data group's ``x`` concatenated on the first dimension in data
    order (the global batch's rows) forward; this rank's rows of the
    summed gradient backward. ``x`` itself without data parallelism."""
    return _GatherFromData.apply(mesh, x) if data_parallel(mesh) else x
