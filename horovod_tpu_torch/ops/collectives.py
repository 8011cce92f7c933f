"""Collective operations on ``torch.distributed`` (port of the subset of
``horovod_tpu/ops/collectives.py`` that the data-parallel optimizer and
ZeRO use: allreduce, broadcast, reduce-scatter and the equal-size
allgather).

Every rank holds its own tensor, as in the reference Horovod; the
collectives run on the process group ``init()`` created (NCCL between
GPUs, gloo on the CPU). ``*_async`` returns a :class:`Handle` whose
``synchronize`` waits for the collective and applies what follows it
(averaging, decompression). With NCCL the wait orders the current CUDA
stream after the collective without blocking the host.

``name`` is accepted for the reference's API; the negotiation runtime that
keys on it (tensor queue, fusion, response cache) is not ported yet, so
every call issues its own collective. :data:`COUNTS` counts the
collectives issued, per kind.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import basics

# Reduction ops (reference: horovod_tpu/ops/collectives.py:52-56).
Average = 0
Sum = 1
Min = 2
Max = 3
Product = 4

_TORCH_OPS = {Average: dist.ReduceOp.SUM, Sum: dist.ReduceOp.SUM,
              Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX,
              Product: dist.ReduceOp.PRODUCT}

#: collectives issued since the last :func:`reset_counts`, per kind
COUNTS = {"allreduce": 0, "broadcast": 0, "reducescatter": 0, "allgather": 0}


def reset_counts() -> None:
    for kind in COUNTS:
        COUNTS[kind] = 0


def _resolve_op(average: Optional[bool], op: Optional[int]) -> int:
    if op is not None and average is not None:
        raise ValueError("specify either average or op, not both")
    if op is None:
        # reference default: average=True (torch/mpi_ops.py allreduce)
        return Average if (average is None or average) else Sum
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown op {op}")
    return op


class Handle:
    """Future for an async collective (reference: horovod/torch/
    mpi_ops.py:93-124): the collective's work object plus what turns its
    buffer into the result."""

    __slots__ = ("_work", "_finish")

    def __init__(self, work, finish: Callable[[], torch.Tensor]):
        self._work = work
        self._finish = finish

    def poll(self) -> bool:
        return self._work.is_completed()

    def wait(self) -> torch.Tensor:
        self._work.wait()
        return self._finish()


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None, op: Optional[int] = None,
                     compression=Compression.none) -> Handle:
    """Reduce ``tensor`` in place across all ranks; the result lands in
    ``tensor`` at :func:`synchronize`."""
    red = _resolve_op(average, op)
    world = basics.size()
    wire, ctx = compression.compress(tensor)
    work = dist.all_reduce(wire, op=_TORCH_OPS[red], async_op=True)
    COUNTS["allreduce"] += 1

    def finish():
        out = _average(compression.decompress(wire, ctx), red, world)
        if out is not tensor:
            tensor.copy_(out)
        return tensor

    return Handle(work, finish)


def _average(out: torch.Tensor, red: int, world: int) -> torch.Tensor:
    """A SUM turned into the Average: ``div_`` by the world for floats (the
    bits of a mean over the ranks), division rounded toward zero for
    integers, as the reference divides and casts back
    (``horovod_tpu/runtime/executor.py:927-949, 1146-1148``,
    ``horovod_tpu/torch/mpi_ops.py:65-75``): a sum of -5 over 2 ranks
    averages to -2."""
    if red != Average:
        return out
    if out.is_floating_point():
        return out.div_(world)
    return torch.div(out, world, rounding_mode="trunc")


def allreduce_async(tensor, average=None, name=None, op=None,
                    compression=Compression.none) -> Handle:
    """Out-of-place async allreduce: ``tensor`` is left unchanged."""
    return allreduce_async_(tensor.clone(), average=average, name=name,
                            op=op, compression=compression)


def allreduce(tensor, average=None, name=None, op=None,
              compression=Compression.none) -> torch.Tensor:
    """Reduce a tensor across all ranks; every rank gets the result
    (reference: horovod/torch/mpi_ops.py:126-180)."""
    return synchronize(allreduce_async(tensor, average=average, name=name,
                                       op=op, compression=compression))


def allreduce_(tensor, average=None, name=None, op=None,
               compression=Compression.none) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average=average, name=name,
                                        op=op, compression=compression))


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, op=None, compression=Compression.none):
    """Allreduce a list of tensors as one logical operation: all are in
    flight before the first is waited on."""
    handles = [allreduce_async(t, average=average, op=op,
                               compression=compression) for t in tensors]
    return [synchronize(h) for h in handles]


# torch 2.13 names the one-tensor forms reduce_scatter_single and
# all_gather_single; older releases have only the *_tensor names
_reduce_scatter_one = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather_one = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def reducescatter_async(tensor: torch.Tensor, op: Optional[int] = None,
                        name: Optional[str] = None) -> Handle:
    """Reduce ``tensor`` across the ranks; rank i keeps shard i of dim 0
    (reference: horovod_tpu/torch/mpi_ops.py:287-317). ``op`` omitted
    means Average. Dim 0 must divide evenly by the world size. The
    collective is issued at every world size, one rank included."""
    red = _resolve_op(None, op)
    world = basics.size()
    if tensor.ndim == 0 or tensor.shape[0] % world:
        dim0 = tensor.shape[0] if tensor.ndim else "a scalar"
        raise ValueError(f"reducescatter dim 0 ({dim0}) must divide evenly "
                         f"by size ({world})")
    inp = tensor.contiguous()
    out = inp.new_empty((inp.shape[0] // world,) + tuple(inp.shape[1:]))
    work = _reduce_scatter_one(out, inp, op=_TORCH_OPS[red], async_op=True)
    COUNTS["reducescatter"] += 1
    return Handle(work, lambda: _average(out, red, world))


def reducescatter(tensor, op=None, name=None) -> torch.Tensor:
    """Sync reduce-scatter (see :func:`reducescatter_async`)."""
    return synchronize(reducescatter_async(tensor, op=op, name=name))


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> Handle:
    """Concatenate every rank's ``tensor`` along dim 0 (reference:
    horovod_tpu/torch/mpi_ops.py:247-257). The ranks first exchange their
    dim 0: a ragged dim 0 is not ported yet and raises ValueError on every
    rank. The collective is issued at every world size."""
    if tensor.ndim == 0:
        raise ValueError("allgather needs a tensor with a dim 0")
    world = basics.size()
    if world > 1:
        mine = torch.tensor([tensor.shape[0]], dtype=torch.int64,
                            device=tensor.device)
        dims = mine.new_empty(world)
        _all_gather_one(dims, mine)
        dims = dims.tolist()
        if len(set(dims)) > 1:
            raise ValueError(f"allgather with a ragged dim 0 ({dims}) is "
                             "not ported yet: every rank must give the "
                             "same shape")
    return allgather_equal_async(tensor)


def allgather_equal_async(tensor: torch.Tensor) -> Handle:
    """:func:`allgather_async` for callers that know every rank gives the
    same shape (ZeRO's equal shards): no dim 0 exchange."""
    world = basics.size()
    inp = tensor.contiguous()
    out = inp.new_empty((world * inp.shape[0],) + tuple(inp.shape[1:]))
    work = _all_gather_one(out, inp, async_op=True)
    COUNTS["allgather"] += 1
    return Handle(work, lambda: out)


def allgather(tensor, name=None) -> torch.Tensor:
    """Sync allgather (see :func:`allgather_async`)."""
    return synchronize(allgather_async(tensor, name=name))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> Handle:
    """Every rank's ``tensor`` becomes rank ``root_rank``'s, in place."""
    world = basics.size()
    if not 0 <= root_rank < world:
        raise ValueError(f"root_rank {root_rank} out of range [0, {world})")
    work = dist.broadcast(tensor, src=root_rank, async_op=True)
    COUNTS["broadcast"] += 1
    return Handle(work, lambda: tensor)


def broadcast_async(tensor, root_rank, name=None) -> Handle:
    return broadcast_async_(tensor.clone(), root_rank, name=name)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Every rank receives rank ``root_rank``'s tensor (reference:
    horovod/torch/mpi_ops.py broadcast)."""
    return synchronize(broadcast_async(tensor, root_rank, name=name))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name))


def broadcast_object(obj, root_rank: int = 0):
    """Broadcast a picklable object from ``root_rank`` (one collective)."""
    world = basics.size()
    if not 0 <= root_rank < world:
        raise ValueError(f"root_rank {root_rank} out of range [0, {world})")
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    COUNTS["broadcast"] += 1
    return box[0]


def poll(handle: Handle) -> bool:
    """True once the collective behind ``handle`` has completed."""
    return handle.poll()


def synchronize(handle: Handle) -> torch.Tensor:
    """Wait for the collective and return its result."""
    return handle.wait()
