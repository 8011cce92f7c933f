"""Collective operations through the enqueue runtime (port of the part of
``horovod_tpu/ops/collectives.py`` and ``horovod_tpu/torch/mpi_ops.py``
that the data-parallel optimizer and ZeRO use: allreduce, broadcast,
reduce-scatter and the equal-size allgather).

Every rank holds its own tensor, as in the reference Horovod. Each call
enqueues a named op into the runtime (``runtime/runtime.py``), which
negotiates it by ``name`` across the ranks, fuses ready allreduces into
one collective a bin and runs them on its data group (NCCL between GPUs,
gloo on the CPU). An unnamed op gets the call-order name
``"<kind>.noname.<n>"``, so every rank must issue its unnamed ops in the
same order. ``*_async`` returns a :class:`Handle`; ``synchronize`` waits
for the runtime to have queued the collective and applies what follows it
(decompression). On the card the wait orders the caller's current CUDA
stream after the collective without blocking the host.

:data:`COUNTS` counts the ops requested, per kind; ``runtime.COUNTS``
counts what the runtime issued.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.runtime import runtime, types

# Reduction ops (reference: horovod_tpu/ops/collectives.py:52-56).
Average = 0
Sum = 1
Min = 2
Max = 3
Product = 4

_REDUCE_OPS = {Average: types.REDUCE_AVERAGE, Sum: types.REDUCE_SUM,
               Min: types.REDUCE_MIN, Max: types.REDUCE_MAX,
               Product: types.REDUCE_PRODUCT}

#: ops requested since the last :func:`reset_counts`, per kind
COUNTS = {"allreduce": 0, "broadcast": 0, "reducescatter": 0, "allgather": 0}

# call-order numbers of unnamed ops, per kind (reference: horovod/torch/
# mpi_ops_v2.cc GetOpName, "allreduce.noname.<handle>")
_noname = {}
_noname_lock = threading.Lock()


def reset_counts() -> None:
    for kind in COUNTS:
        COUNTS[kind] = 0


def _op_name(kind: str, name: Optional[str]) -> str:
    if name is not None:
        return name
    with _noname_lock:
        n = _noname.get(kind, 0)
        _noname[kind] = n + 1
    return f"{kind}.noname.{n}"


def _resolve_op(average: Optional[bool], op: Optional[int]) -> int:
    if op is not None and average is not None:
        raise ValueError("specify either average or op, not both")
    if op is None:
        # reference default: average=True (torch/mpi_ops.py allreduce)
        return Average if (average is None or average) else Sum
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op}")
    return op


class Handle:
    """Future of an async collective (reference: horovod/torch/
    mpi_ops.py:93-124): the runtime's handle plus what turns its result
    into the caller's."""

    __slots__ = ("_inner", "_finish")

    def __init__(self, inner: runtime.RuntimeHandle,
                 finish: Callable[[torch.Tensor], torch.Tensor]):
        self._inner = inner
        self._finish = finish

    def poll(self) -> bool:
        return self._inner.poll()

    def wait(self) -> torch.Tensor:
        return self._finish(self._inner.wait())


def _wire(tensor: torch.Tensor, compression):
    """The compressed tensor the runtime reduces in place: contiguous, as
    the fusion buffer packs flat views. (``contiguous()`` releases the
    interpreter lock even when it has nothing to do: asked first, a
    gradient hook keeps the lock.)"""
    wire, ctx = compression.compress(tensor)
    return (wire if wire.is_contiguous() else wire.contiguous()), ctx


def _into(tensor: torch.Tensor, wire: torch.Tensor, ctx, compression):
    """The tail of an in-place allreduce: the reduced wire, decompressed,
    lands in ``tensor``."""

    def finish(_):
        out = compression.decompress(wire, ctx)
        if out is not tensor:
            tensor.copy_(out)
        return tensor

    return finish


def allreduce_async_(tensor: torch.Tensor, average: Optional[bool] = None,
                     name: Optional[str] = None, op: Optional[int] = None,
                     compression=Compression.none) -> Handle:
    """Reduce ``tensor`` in place across all ranks; the result lands in
    ``tensor`` at :func:`synchronize`. ``name`` is the negotiation key: at
    most one op of a name may be in flight."""
    red = _resolve_op(average, op)
    wire, ctx = _wire(tensor, compression)
    inner = runtime.get_runtime().enqueue_allreduce(
        _op_name("allreduce", name), wire, reduce_op=_REDUCE_OPS[red])
    COUNTS["allreduce"] += 1
    return Handle(inner, _into(tensor, wire, ctx, compression))


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
    """Allreduce a list of tensors as one group: one enqueue, so the group
    negotiates in one cycle and fuses into as few collectives as the
    fusion threshold allows. The inputs are left unchanged; tensor ``i``
    is named ``"<name>.<i>"``, or by call order when ``name`` is None."""
    red = _resolve_op(average, op)
    tensors = [t.clone() for t in tensors]
    wires = [_wire(t, compression) for t in tensors]
    names = [f"{name}.{i}" if name is not None else _op_name("allreduce", None)
             for i in range(len(tensors))]
    inner = runtime.get_runtime().enqueue_allreduce_group(
        names, [w for w, _ in wires], reduce_op=_REDUCE_OPS[red])
    COUNTS["allreduce"] += len(tensors)
    handles = [Handle(h, _into(t, w, ctx, compression))
               for h, t, (w, ctx) in zip(inner, tensors, wires)]
    return [synchronize(h) for h in handles]


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
    inner = runtime.get_runtime().enqueue_reducescatter(
        _op_name("reducescatter", name), tensor, reduce_op=_REDUCE_OPS[red])
    COUNTS["reducescatter"] += 1
    return Handle(inner, lambda out: out)


def reducescatter(tensor, op=None, name=None) -> torch.Tensor:
    """Sync reduce-scatter (see :func:`reducescatter_async`)."""
    return synchronize(reducescatter_async(tensor, op=op, name=name))


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> Handle:
    """Concatenate every rank's ``tensor`` along dim 0 (reference:
    horovod_tpu/torch/mpi_ops.py:247-257). The ranks' dim 0 meet in the
    negotiation: a ragged dim 0 is not ported yet and raises ValueError on
    every rank at :func:`synchronize`. The collective is issued at every
    world size."""
    if tensor.ndim == 0:
        raise ValueError("allgather needs a tensor with a dim 0")
    inner = runtime.get_runtime().enqueue_allgather(
        _op_name("allgather", name), tensor)
    COUNTS["allgather"] += 1
    return Handle(inner, lambda out: out)


def allgather(tensor, name=None) -> torch.Tensor:
    """Sync allgather (see :func:`allgather_async`)."""
    return synchronize(allgather_async(tensor, name=name))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> Handle:
    """Every rank's ``tensor`` becomes rank ``root_rank``'s, in place."""
    world = basics.size()
    if not 0 <= root_rank < world:
        raise ValueError(f"root_rank {root_rank} out of range [0, {world})")
    inner = runtime.get_runtime().enqueue_broadcast(
        _op_name("broadcast", name), tensor, root_rank)
    COUNTS["broadcast"] += 1
    return Handle(inner, lambda _: tensor)


def broadcast_async(tensor, root_rank, name=None) -> Handle:
    return broadcast_async_(tensor.clone(), root_rank, name=name)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Every rank receives rank ``root_rank``'s tensor (reference:
    horovod/torch/mpi_ops.py broadcast)."""
    return synchronize(broadcast_async(tensor, root_rank, name=name))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name))


def broadcast_object(obj, root_rank: int = 0):
    """Broadcast a picklable object from ``root_rank``: one direct call on
    the default group, which the runtime never uses. (Not on the control
    group: the runtime's thread issues there, and a call from another
    thread would meet its cycles in a different order on each rank.)"""
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
