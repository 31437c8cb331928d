"""The (dp, tp) mesh over a ``torch.distributed`` world, and its collectives.

Counterpart of ``chatts_tpu/parallel/mesh.py``.  JAX runs every device from
one controller and GSPMD inserts the collectives; PyTorch runs one process a
rank, so the port's mesh is this rank's place in the world plus the process
groups its collectives run in.  Ranks lie on the mesh as JAX lays devices
out (``np.asarray(devices).reshape(dp, tp)``): rank r is at dp index r // tp
and tp index r % tp, so a tp group is tp consecutive ranks.

Every collective of the port lives here: ``all_reduce_tp`` (row-parallel
projections, the vocab-parallel embedding), ``all_gather_tp`` (the vocab of
the logits, an activation-order projection's input), ``max_tp`` (an int8
row-parallel projection's column or row maxima) and ``broadcast_from_driver``
(tp rank 0's sampled ids and, for the serving engine, its plans).  Each is
the identity without a mesh or at tp = 1.

Those work in place or into fresh buffers, which autograd cannot follow.
Where it records (training), the model takes Megatron's conjugate pairs
instead, each a ``torch.autograd.Function``:

- ``copy_to_tp``: the identity forward, the sum of the gradient over tp
  backward (the input of a column-parallel block, whose ranks each see
  part of the output);
- ``reduce_from_tp``: the sum over tp forward, the identity backward (a
  row-parallel projection's and the vocab-parallel embedding's output);
- ``gather_from_tp``: the concatenation over tp forward, this rank's slice
  of the gradient backward (the vocab of the logits).

``torch.distributed.nn.functional``'s ``all_reduce`` and ``all_gather``
sum the gradient over the group in their backward.  Downstream of a tp
layer every rank computes the same loss, so a rank's gradient there is
already the whole one, and that sum would make it tp times too large.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "dp"
MODEL_AXIS = "tp"


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place on a (dp, tp) mesh and the groups it talks in."""

    shape: Dict[str, int]  # {DATA_AXIS: dp, MODEL_AXIS: tp}, as JAX's mesh.shape
    dp_index: int
    tp_index: int
    tp_ranks: Tuple[int, ...]  # the world ranks of this rank's tp group, by tp index
    dp_ranks: Tuple[int, ...]  # the world ranks of this rank's dp group, by dp index
    tp_group: Any
    dp_group: Any
    backend: str

    @property
    def tp(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def driver_rank(self) -> int:
        """The world rank of tp index 0 in this rank's tp group."""
        return self.tp_ranks[0]

    @property
    def is_driver(self) -> bool:
        return self.tp_index == 0


def create_mesh(dp: Optional[int] = None, tp: Optional[int] = None) -> Optional[Mesh]:
    """The (dp, tp) mesh over the initialized world, JAX's defaults: all
    ranks on the model axis unless told otherwise.  Every rank must call it,
    with the same arguments, in the same order as its other group calls.  A
    world of one rank (or none initialized) gives None: a single-device
    model, as JAX's ``infer_mesh`` reports for unsharded parameters."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None and tp is None:
        dp, tp = 1, n
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
    if n == 1:
        return None
    rank = dist.get_rank()
    mine: Dict[str, Any] = {}
    # new_group is collective over the world: every rank makes every group.
    for d in range(dp):
        ranks = tuple(range(d * tp, (d + 1) * tp))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine["tp"] = (ranks, group)
    for t in range(tp):
        ranks = tuple(range(t, n, tp))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine["dp"] = (ranks, group)
    return Mesh(shape={DATA_AXIS: dp, MODEL_AXIS: tp}, dp_index=rank // tp,
                tp_index=rank % tp, tp_ranks=mine["tp"][0], dp_ranks=mine["dp"][0],
                tp_group=mine["tp"][1], dp_group=mine["dp"][1],
                backend=dist.get_backend())


def _tp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.tp > 1


def all_reduce_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the tp group, in x's type, in place."""
    if _tp_active(mesh):
        dist.all_reduce(x, group=mesh.tp_group)
    return x


def max_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the tp group, in place."""
    if _tp_active(mesh):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.tp_group)
    return x


def all_gather_tp(mesh: Optional[Mesh], x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The tp group's ``x`` concatenated along ``dim`` in tp order."""
    if not _tp_active(mesh):
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x, group=mesh.tp_group)
    return torch.cat(parts, dim=dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.tp_group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.tp_group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return all_gather_tp(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return g.narrow(ctx.dim, mesh.tp_index * ctx.size, ctx.size).contiguous(), None, None


def copy_to_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """``x`` forward; backward, the gradient summed over the tp group."""
    return _CopyToTP.apply(x, mesh) if _tp_active(mesh) else x


def reduce_from_tp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the tp group, a new tensor; backward, the
    identity."""
    return _ReduceFromTP.apply(x, mesh) if _tp_active(mesh) else x


def gather_from_tp(mesh: Optional[Mesh], x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``all_gather_tp``; backward, this rank's slice of the gradient."""
    if not _tp_active(mesh):
        return x
    return _GatherFromTP.apply(x, mesh, dim % x.dim())


def all_reduce_dp(mesh: Optional[Mesh], x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the dp group, in place."""
    if mesh is not None and mesh.dp > 1:
        dist.all_reduce(x, group=mesh.dp_group)
    return x


def all_gather_dp(mesh: Optional[Mesh], obj: Any) -> list:
    """Every dp group's picklable ``obj``, in dp order."""
    if mesh is None or mesh.dp == 1:
        return [obj]
    out = [None] * mesh.dp
    dist.all_gather_object(out, obj, group=mesh.dp_group)
    return out


def broadcast_from_driver(mesh: Optional[Mesh], value: Any, *, world: bool = False) -> Any:
    """tp rank 0's ``value`` on every rank of its tp group: a tensor in
    place (every rank passes one of the same shape and type), anything else
    pickled (what the other ranks pass is ignored).  With ``world`` (the
    serving engine, whose one driver is world rank 0), world rank 0's on
    every rank of the world, also when dp > 1."""
    if world and mesh is not None and mesh.dp > 1:
        src, group = 0, None
    elif _tp_active(mesh):
        src, group = mesh.driver_rank, mesh.tp_group
    else:
        return value
    if isinstance(value, torch.Tensor):
        dist.broadcast(value, src=src, group=group)
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
