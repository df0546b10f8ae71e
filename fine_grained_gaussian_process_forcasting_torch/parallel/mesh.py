"""The (data, model) device mesh over ``torch.distributed``, and the
collectives the port's parallel paths take.

Counterpart of the JAX package's ``parallel/mesh.py``.  JAX runs one
controller over many devices and XLA inserts the collectives; here each
rank is a process of its own (``torchrun``), its batch is its slice of the
global batch (``batch_slice``) and the collectives are written out below:

- ``all_reduce`` / ``all_gather``: no gradient (statistics, predictions);
- ``copy_to`` (identity forward, all-reduce backward) and ``reduce_from``
  (all-reduce forward, identity backward): Megatron's *f* and *g* around a
  column- and a row-parallel pair over ``model``;
- ``sum_over``: all-reduce both ways, for a sum whose result every rank uses
  for its own part of the loss (a head-partial mean, batch statistics);
- ``gather`` (all-gather forward, the rank's slice of the gradient
  backward) and ``split`` (the slice forward, all-gather backward): an op
  that mixes every head runs replicated between them.

A gloo collective on CUDA tensors goes through host memory (gloo's CUDA
support differs by collective and version); NCCL takes them in place.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from fine_grained_gaussian_process_forcasting_torch.device import resolve_device

AXES = ("data", "model")


def _start_group(device: torch.device) -> None:
    """The default process group from the ``torchrun`` environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL where every rank of this
    host has a card of its own, gloo for CPU tensors and where ranks share
    a card (NCCL refuses two ranks on one device)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group is running and {missing} are not set: start "
            "each rank with torchrun, e.g. torchrun --standalone "
            "--nproc-per-node N -m fine_grained_gaussian_process_forcasting_"
            "torch.train.cli ... --dp N")
    backend = "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   os.environ["WORLD_SIZE"]))
        if local <= torch.cuda.device_count():
            backend = "nccl"
    dist.init_process_group(backend)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device="cuda") -> DeviceMesh:
    """A 2-D ('data', 'model') mesh over the process group, started from the
    ``torchrun`` environment when none is running.  Rank r sits at
    (r // n_model, r % n_model).  On CUDA each rank takes
    ``cuda:{LOCAL_RANK % device_count()}``; ``device="cpu"`` keeps every
    tensor on the host, over gloo."""
    device = resolve_device(device)
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    if not dist.is_initialized():
        _start_group(device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    needed = n_data * n_model
    if needed < 1:
        raise ValueError(
            f"mesh needs at least 1 device: n_data={n_data} n_model={n_model}")
    if world != needed:
        raise ValueError(
            f"make_mesh(n_data={n_data}, n_model={n_model}) needs {needed} "
            f"devices but the process group has {world} ranks "
            f"({device.type}). Start {needed} ranks: torchrun --standalone "
            f"--nproc-per-node {needed} -m ...")
    return init_device_mesh(device.type, (n_data, n_model),
                            mesh_dim_names=AXES)


def axis_sizes(mesh) -> dict:
    """{'data': n, 'model': m} of a ``DeviceMesh``, or of a mapping of
    axis sizes (the spec functions take either)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {axis: int(mesh.get(axis, 1)) for axis in AXES}


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of the mesh as this rank sees it."""

    group: dist.ProcessGroup
    size: int
    rank: int
    staged: bool  # gloo: CUDA tensors go through host memory


def axis(mesh: DeviceMesh, name: str) -> Axis:
    group = mesh.get_group(name)
    return Axis(group=group, size=mesh.size(AXES.index(name)),
                rank=mesh.get_local_rank(name),
                staged=dist.get_backend(group) == "gloo")


def world_axis() -> Axis:
    """Every rank (the default group, which the mesh spans)."""
    return Axis(group=dist.group.WORLD, size=dist.get_world_size(),
                rank=dist.get_rank(),
                staged=dist.get_backend() == "gloo")


def batch_slice(mesh, batch: int, data_rank: Optional[int] = None) -> slice:
    """This rank's rows of a global batch of ``batch``: ``batch_sharding``'s
    P('data') as a slice.  Raises unless ``n_data`` divides ``batch`` (the
    shards' mean loss is the global mean only for equal shards)."""
    n_data = axis_sizes(mesh)["data"]
    if batch % n_data:
        raise ValueError(f"a batch of {batch} does not split into {n_data} "
                         "equal data shards")
    if data_rank is None:
        data_rank = mesh.get_local_rank("data")
    per = batch // n_data
    return slice(data_rank * per, (data_rank + 1) * per)


# -- collectives ------------------------------------------------------ #

def _host(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    return t.cpu() if ax.staged and t.is_cuda else t


def all_reduce(t: torch.Tensor, ax: Axis,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) over the axis; a new tensor, ``t`` untouched."""
    if ax.size == 1:
        return t.clone()
    buf = _host(t, ax).clone().contiguous()
    dist.all_reduce(buf, op=op, group=ax.group)
    return buf.to(t.device)


def all_gather(t: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """The axis' pieces concatenated along ``dim``, in rank order."""
    if ax.size == 1:
        return t.clone()
    buf = _host(t, ax).contiguous()
    parts = [torch.empty_like(buf) for _ in range(ax.size)]
    dist.all_gather(parts, buf, group=ax.group)
    return torch.cat(parts, dim=dim).to(t.device)


def reduce_scatter(t: torch.Tensor, ax: Axis, dim: int = 0) -> torch.Tensor:
    """The sum over the axis of ``t``, of which this rank keeps its
    ``1/size`` chunk along ``dim``."""
    if ax.size == 1:
        return t.clone()
    chunks = _host(t, ax).chunk(ax.size, dim=dim)
    # the rank-r chunk at rows r n .. (r + 1) n of one input
    buf = torch.cat([c.contiguous() for c in chunks])
    out = torch.empty_like(chunks[0], memory_format=torch.contiguous_format)
    with warnings.catch_warnings():  # the name both torch 2.11 and 2.13 take
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, buf, group=ax.group)
    return out.to(t.device)


def broadcast_object(obj, src: int = 0):
    """``obj`` as rank ``src`` holds it, on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _chunk(t: torch.Tensor, ax: Axis, dim: int) -> torch.Tensor:
    return t.chunk(ax.size, dim=dim)[ax.rank]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.ax), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.ax, ctx.dim).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _chunk(x, ax, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.ax, ctx.dim), None, None


def copy_to(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Megatron's *f*: the replicated input of a column-parallel layer;
    its gradient, partial on each rank, is summed over the axis."""
    return x if ax is None else _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """Megatron's *g*: the sum of a row-parallel layer's partial outputs;
    the result is replicated, so its gradient is every rank's already."""
    return x if ax is None else _ReduceFrom.apply(x, ax)


def sum_over(x: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum over the axis of partial sums whose result each rank uses
    for its own part of the loss: the gradient is summed back."""
    return x if ax is None else _SumOver.apply(x, ax)


def gather(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """Every rank's piece along ``dim``, for an op that runs replicated on
    them; each rank keeps its slice of the (replicated) gradient."""
    return x if ax is None else _Gather.apply(x, ax, dim)


def split(x: torch.Tensor, ax: Optional[Axis], dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated tensor; the gradient
    is gathered so that it is whole on every rank again."""
    return x if ax is None else _Split.apply(x, ax, dim)


def replicated(t: torch.Tensor, ax: Axis) -> bool:
    """Whether ``t`` is bit-equal on every rank of the axis: the check that
    a leaf placed ``P()`` stayed replicated (NaNs compared by their bits)."""
    bits = t.detach().contiguous().reshape(-1).view(torch.uint8)
    parts = all_gather(bits.reshape(1, -1), ax, dim=0)
    return bool((parts == parts[:1]).all())
