"""Process groups, device meshes and the collectives of data and tensor
parallelism, over ``torch.distributed``.

The counterpart of the JAX package's ``parallel/mesh.py``. There a mesh is
a set of devices under one program, GSPMD inserts the collectives, and a
sharded run computes the function of the unsharded one. Here each GPU is a
process (started by ``torchrun``) and the collectives are written out, so
that a run at any world size still computes the function (loss, gradients,
batch statistics, random draws) that the same global batch gives in one
process:

- ``init_distributed(device)`` reads ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` as ``torchrun`` sets
  them (the reference's env rank discovery): NCCL on ``cuda``, gloo on the
  CPU. Without that environment there is one process and no group, and
  every single-process call runs as before.
- ``make_mesh(dp, tp)`` is a ``DeviceMesh`` with dims ``("data",
  "model")``; ``mesh_axis(mesh, name)`` gives one dim as an ``Axis`` (its
  group, this rank's index along it, its size), which the train steps and
  the models take (``None``: no parallelism).
- ``process_count``, ``process_index``, ``is_main_process``,
  ``local_batch_slice``, ``replicate``, ``shard_batch``,
  ``allgather_by_index`` as in the JAX package.
- Differentiable collectives, each an ``autograd.Function`` whose backward
  is stated with it. Over ``data`` a gradient is a piece: each rank
  differentiates a share of the loss, the shares sum to the loss, and
  ``all_reduce_grads`` sums the pieces (``gather_rows``, ``mean_over``).
  Over ``model`` the convention is Megatron's: an activation outside a
  parallel region is replicated and carries its whole gradient on every
  rank (``tp_copy`` = f, ``tp_reduce`` = g, ``tp_gather``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from zs_aac_tpu_torch.utils.device import resolve_device

__all__ = [
    "Axis",
    "init_distributed",
    "make_mesh",
    "make_mesh_for_batch",
    "mesh_axis",
    "tensor_axis",
    "process_count",
    "process_index",
    "is_main_process",
    "barrier",
    "broadcast_object",
    "destroy_distributed",
    "local_batch_slice",
    "replicate",
    "shard_batch",
    "allgather_by_index",
    "gather_rows",
    "mean_over",
    "all_sum",
    "all_reduce_grads",
    "tp_copy",
    "tp_reduce",
    "tp_gather",
]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One dim of a mesh as this rank sees it: the process group of the
    ranks along it, this rank's index among them and their number."""
    group: Any
    rank: int
    size: int

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` global rows (contiguous, equal shares)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def local(self, t):
        """This rank's rows of ``t`` (its leading dim global)."""
        return t[self.rows(len(t))]


def init_distributed(device="cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes and return this
    rank's device (``cuda:LOCAL_RANK`` for ``cuda``, made current). With no
    ``RANK``/``WORLD_SIZE`` in the environment: the resolved ``device``, no
    group. Asking for ``cuda`` where there is no card or no NCCL raises; it
    never carries on over gloo or on the CPU."""
    dev = resolve_device(device)
    if "RANK" not in os.environ and "WORLD_SIZE" not in os.environ:
        return dev
    if not dist.is_available():
        raise RuntimeError("this torch has no torch.distributed")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    backend = "gloo"
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("device 'cuda' was requested but this torch has no NCCL")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(local)
        dev, backend = torch.device("cuda", local), "nccl"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return dev


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """The reference's rank-0 check: only it writes checkpoints and logs."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (a no-op in one process)."""
    if process_count() > 1:
        dist.barrier()


def broadcast_object(obj):
    """Rank 0's ``obj`` (picklable) on every rank; ``obj`` in one process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def destroy_distributed() -> None:
    """Leave the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(dp: Optional[int] = None, tp: int = 1):
    """A ``(dp, tp)`` ``DeviceMesh`` of ranks ``0..dp*tp-1``, dims ``("data",
    "model")`` (``dp`` defaults to the world size over ``tp``). Every rank
    must call it. Without a process group a 1 x 1 mesh is ``None`` (the
    single-process path) and a larger one raises."""
    from torch.distributed.device_mesh import DeviceMesh

    world = process_count()
    dp = world // tp if dp is None else dp
    if not (dist.is_available() and dist.is_initialized()):
        if dp * tp != 1:
            raise RuntimeError(f"a {dp} x {tp} mesh needs {dp * tp} processes "
                               "(start them with torchrun)")
        return None
    if dp < 1 or dp * tp > world:
        raise ValueError(f"a {dp} x {tp} mesh does not fit {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=("data", "model"))


def make_mesh_for_batch(batch_size: int):
    """A data-parallel mesh over every rank for global batches of
    ``batch_size`` rows, which must divide by the world size (raises
    otherwise): every rank loads its ``local_batch_slice`` of each batch, so
    no rank can sit out of the mesh."""
    local_batch_slice(batch_size)
    return make_mesh(process_count(), 1)


def mesh_axis(mesh, name: str) -> Optional[Axis]:
    """Dim ``name`` of ``mesh`` as this rank's ``Axis``; ``None`` for no mesh."""
    if mesh is None:
        return None
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {process_index()} is not in the mesh {mesh}")
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


def tensor_axis(mesh) -> Optional[Axis]:
    """The ``model`` axis of ``mesh`` where it has more than one rank, else
    ``None``. A shard over one rank is the whole model and its f, g and
    vocabulary gather are identities, which would still cost a collective
    call each: 0.1-0.18 ms of host time a call beside an NVIDIA H100, and
    2-2.7x the wall of a bf16 GPT-2 decode (``chip_smoke.py`` phase 20)."""
    axis = mesh_axis(mesh, "model")
    return axis if axis is not None and axis.size > 1 else None


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a global batch (DistributedSampler's
    rank-offset sharding). The batch must divide evenly: a floored share
    would drop the tail rows of every batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must be divisible by process_count "
                         f"{n} for per-process sharding")
    per = global_batch // n
    start = per * process_index()
    return slice(start, start + per)


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    return []


@torch.no_grad()
def replicate(tree):
    """Broadcast every tensor of ``tree`` (dicts, lists, modules, dataclass
    states) from rank 0, in place, so that all ranks start from rank 0's
    values; returns ``tree``. A no-op without a process group."""
    if process_count() == 1:
        return tree
    for t in _tensors(tree):
        dist.broadcast(t.data, src=0)
    return tree


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows (along ``data``) of each entry of a global batch
    (numpy arrays, tensors or lists); the batch itself without a mesh."""
    axis = mesh_axis(mesh, "data")
    if axis is None:
        return batch
    return {k: axis.local(v) for k, v in batch.items()}


def _reassemble(gathered_index: np.ndarray, gathered_arrays):
    """Merge gathered, -1-padded (index, array) pairs back into global index
    order (pure, so one process can test it)."""
    gi = np.asarray(gathered_index).reshape(-1)
    keep = gi >= 0
    order = np.argsort(gi[keep], kind="stable")
    out = []
    for a in gathered_arrays:
        a = np.asarray(a)
        flat = a.reshape(-1, *a.shape[2:])
        out.append(flat[keep][order])
    return tuple(out)


def allgather_by_index(index: np.ndarray, *arrays: np.ndarray):
    """Gather every process's (index, arrays) rows onto every process, in
    global index order (the eval aggregation the reference does on rank 0).
    Unequal per-process counts are padded with index -1 and zero rows
    before the ``all_gather``. Every rank must call it."""
    index = np.asarray(index, np.int64)
    if process_count() == 1:
        order = np.argsort(index, kind="stable")
        return tuple(np.asarray(a)[order] for a in arrays)
    dev = _comm_device()
    m = torch.tensor([index.shape[0]], device=dev)
    dist.all_reduce(m, op=dist.ReduceOp.MAX)
    m = int(m.item())

    def gather(a, fill):
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        pad = torch.full((m - t.shape[0], *t.shape[1:]), fill, dtype=t.dtype, device=dev)
        t = torch.cat([t, pad])
        parts = [torch.empty_like(t) for _ in range(process_count())]
        dist.all_gather(parts, t)
        return torch.stack(parts).cpu().numpy()

    return _reassemble(gather(index, -1), [gather(np.asarray(a), 0) for a in arrays])


def _dense(x):
    return torch.clone(x, memory_format=torch.contiguous_format)


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' rows concatenated in rank order. Backward: the
    sum over ranks of the incoming gradients, this rank's rows of it (the
    exact adjoint). Each rank differentiates 1 / size of the replicated
    loss, so this is the one-process gradient of the local rows."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = _dense(grad)
        dist.all_reduce(grad, group=ctx.axis.group)
        return ctx.axis.local(grad), None


class _MeanOver(torch.autograd.Function):
    """Forward: the mean over ranks (of equal shares, the global batch's
    mean of per-row quantities). Backward: the mean over ranks of the
    gradient pieces (its adjoint)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        y = _dense(x)
        dist.all_reduce(y, group=axis.group)
        return y / axis.size

    @staticmethod
    def backward(ctx, grad):
        grad = _dense(grad)
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad / ctx.axis.size, None


class _Copy(torch.autograd.Function):
    """Megatron's f: identity forward; backward the sum over the group."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = _dense(grad)
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Megatron's g: the sum over the group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        y = _dense(x)
        dist.all_reduce(y, group=axis.group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    """Forward: the ranks' shards concatenated along the last dim (a
    vocab-parallel logit row made whole). Backward: this rank's shard of
    the gradient, which every rank holds whole (Megatron's convention)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(axis.size)]
        dist.all_gather(parts, x.contiguous(), group=axis.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.axis.rank * ctx.n, ctx.n).contiguous(), None


def gather_rows(x, axis: Optional[Axis]):
    """The global batch from each rank's rows (``_GatherRows``)."""
    return x if axis is None else _GatherRows.apply(x, axis)


def mean_over(x, axis: Optional[Axis]):
    """The mean over ``axis``'s ranks (``_MeanOver``): batch-norm moments."""
    return x if axis is None else _MeanOver.apply(x, axis)


@torch.no_grad()
def all_sum(x, axis: Optional[Axis]):
    """The sum over ``axis``'s ranks, outside autograd (counts, logged losses)."""
    if axis is None:
        return x
    y = _dense(x)
    dist.all_reduce(y, group=axis.group)
    return y


@torch.no_grad()
def all_reduce_grads(grads, axis: Optional[Axis]):
    """Sum a list of gradient pieces over ``axis`` (one ``all_reduce`` per
    dtype over the flattened pieces); returns the summed list."""
    if axis is None:
        return list(grads)
    out = list(grads)
    for dtype in {g.dtype for g in grads}:
        idx = [i for i, g in enumerate(grads) if g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=axis.group)
        o = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[o:o + n].view_as(grads[i])
            o += n
    return out


def tp_copy(x, axis: Optional[Axis]):
    """Megatron's f, before a column-parallel product (``_Copy``)."""
    return x if axis is None else _Copy.apply(x, axis)


def tp_reduce(x, axis: Optional[Axis]):
    """Megatron's g, after a row-parallel product (``_Reduce``)."""
    return x if axis is None else _Reduce.apply(x, axis)


def tp_gather(x, axis: Optional[Axis]):
    """Vocab-parallel logits made whole along the last dim (``_GatherLast``)."""
    return x if axis is None else _GatherLast.apply(x, axis)
