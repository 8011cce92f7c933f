"""Collective operations through the enqueue runtime (port of
``horovod_tpu/torch/mpi_ops.py`` and the part of
``horovod_tpu/ops/collectives.py`` behind it): allreduce, broadcast,
allgather (a ragged dim 0 included), reduce-scatter, alltoall, the sparse
allreduce, the object broadcast, and the autograd of allreduce, allgather
and broadcast.

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

Dtypes: neither data plane carries int16 (gloo and NCCL have no such
type), so an int16 tensor travels as int32 and its result comes back
narrowed, as the JAX package widens small integers for its host ring. The
unsigned 16-, 32- and 64-bit types are refused with a ``TypeError`` before
anything is enqueued, on the card and on the CPU alike: gloo refuses them,
and a collective that works on one plane only would be a different API on
each.

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
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.exceptions import OrderedLaneError
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
COUNTS = {"allreduce": 0, "broadcast": 0, "reducescatter": 0, "allgather": 0,
          "alltoall": 0}

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


# dtypes no data plane carries: int16 travels widened, the unsigned wider
# types are refused
_WIDEN = {torch.int16: torch.int32}
_REFUSED = (torch.uint16, torch.uint32, torch.uint64)


def _plane(tensor: torch.Tensor) -> torch.Tensor:
    """The tensor the data plane carries for ``tensor``: itself, or an
    int32 copy of an int16 one. Raises ``TypeError`` for a dtype neither
    plane carries."""
    if tensor.dtype in _REFUSED:
        raise TypeError(
            f"collectives do not carry {tensor.dtype}: gloo refuses it, so "
            "neither plane takes it; cast to int64 (or a signed type that "
            "holds the values) first")
    wide = _WIDEN.get(tensor.dtype)
    return tensor if wide is None else tensor.to(wide)


def _narrow(like: torch.Tensor):
    """The tail that turns a result of ``_plane(like)`` into like's dtype."""
    if like.dtype not in _WIDEN:
        return lambda out: out
    return lambda out: out.to(like.dtype)


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
    wire, ctx = compression.compress(_plane(tensor))
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
    (reference: horovod/torch/mpi_ops.py:126-180). Differentiable: the
    gradient is the allreduce of the gradient with the same op
    (``horovod_tpu/torch/mpi_ops.py:358-371``); compression wraps the
    differentiable part, as there."""
    red = _resolve_op(average, op)
    wire, ctx = compression.compress(tensor)
    return compression.decompress(_AllreduceFunction.apply(wire, red, name),
                                  ctx)


def allreduce_(tensor, average=None, name=None, op=None,
               compression=Compression.none) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average=average, name=name,
                                        op=op, compression=compression))


def grouped_allreduce_async_(tensors: Sequence[torch.Tensor], names,
                             average=None, op=None, priority: int = 0,
                             group_callback=None,
                             compression=Compression.none) -> list:
    """Reduce a group of tensors in place with one enqueue
    (``Runtime.enqueue_allreduce_group``): the group negotiates in one
    cycle and fuses into as few collectives as the fusion threshold
    allows. ``names`` pairs up with ``tensors``; ``priority`` puts the
    group ahead of lower ones in negotiation; ``group_callback(ok)`` fires
    on the runtime's thread once a tensor as it completes. One
    :class:`Handle` a tensor, in order (reference:
    ``horovod_tpu/ops/collectives.py:1000-1030``)."""
    red = _resolve_op(average, op)
    tensors, names = list(tensors), list(names)
    if len(tensors) != len(names):
        raise ValueError("tensors and names must pair up")
    if not tensors:
        return []
    wires = [_wire(t, compression) for t in tensors]
    inner = runtime.get_runtime().enqueue_allreduce_group(
        names, [w for w, _ in wires], reduce_op=_REDUCE_OPS[red],
        priority=priority, group_callback=group_callback)
    COUNTS["allreduce"] += len(tensors)
    return [Handle(h, _into(t, w, ctx, compression))
            for h, t, (w, ctx) in zip(inner, tensors, wires)]


def grouped_allreduce_async(tensors, names, average=None, op=None,
                            priority: int = 0, group_callback=None,
                            compression=Compression.none) -> list:
    """Out-of-place :func:`grouped_allreduce_async_`: the inputs are left
    unchanged."""
    return grouped_allreduce_async_(
        [t.clone() for t in tensors], names, average=average, op=op,
        priority=priority, group_callback=group_callback,
        compression=compression)


def grouped_allreduce(tensors: Sequence[torch.Tensor], average=None,
                      name=None, op=None, compression=Compression.none):
    """Allreduce a list of tensors as one group (see
    :func:`grouped_allreduce_async_`). The inputs are left unchanged;
    tensor ``i`` is named ``"<name>.<i>"``, or by call order when ``name``
    is None."""
    names = [f"{name}.{i}" if name is not None else _op_name("allreduce", None)
             for i in range(len(tensors))]
    return [synchronize(h) for h in grouped_allreduce_async(
        tensors, names, average=average, op=op, compression=compression)]


def reducescatter_async(tensor: torch.Tensor, op: Optional[int] = None,
                        name: Optional[str] = None,
                        priority: int = 0) -> Handle:
    """Reduce ``tensor`` across the ranks; rank i keeps shard i of dim 0
    (reference: horovod_tpu/torch/mpi_ops.py:287-317). ``op`` omitted
    means Average. Dim 0 must divide evenly by the world size. The
    collective is issued at every world size, one rank included; a higher
    ``priority`` enters negotiation first."""
    red = _resolve_op(None, op)
    _divisible("reducescatter", tensor)
    wire = _plane(tensor)
    inner = runtime.get_runtime().enqueue_reducescatter(
        _op_name("reducescatter", name), wire, reduce_op=_REDUCE_OPS[red],
        priority=priority)
    COUNTS["reducescatter"] += 1
    return Handle(inner, _narrow(tensor))


def reducescatter(tensor, op=None, name=None) -> torch.Tensor:
    """Sync reduce-scatter (see :func:`reducescatter_async`)."""
    return synchronize(reducescatter_async(tensor, op=op, name=name))


def _divisible(kind: str, tensor: torch.Tensor) -> None:
    """The JAX binding's check of an equal split of dim 0 (its message)."""
    world = basics.size()
    if tensor.ndim == 0 or tensor.shape[0] % world:
        dim0 = tensor.shape[0] if tensor.ndim else "a scalar"
        raise ValueError(f"{kind} dim 0 ({dim0}) must divide evenly by "
                         f"size ({world})")


def allgather_async(tensor: torch.Tensor,
                    name: Optional[str] = None) -> Handle:
    """Concatenate every rank's ``tensor`` along dim 0, in rank order
    (reference: horovod_tpu/torch/mpi_ops.py:247-257). The ranks' dim 0
    may differ (a ragged gather): they meet in the negotiation, which
    hands the executor every rank's size; the other dims must match. The
    collective is issued at every world size."""
    if not isinstance(tensor, torch.Tensor) or tensor.ndim == 0:
        raise ValueError("allgather needs a tensor with a dim 0")
    wire = _plane(tensor)
    inner = runtime.get_runtime().enqueue_allgather(
        _op_name("allgather", name), wire)
    COUNTS["allgather"] += 1
    return Handle(inner, _narrow(tensor))


def allgather(tensor, name=None) -> torch.Tensor:
    """Sync allgather (see :func:`allgather_async`). Differentiable: the
    gradient is this rank's rows of the summed gradient
    (``horovod_tpu/torch/mpi_ops.py:374-401``)."""
    return _AllgatherFunction.apply(tensor, name)


def alltoall_async(tensor: torch.Tensor,
                   name: Optional[str] = None) -> Handle:
    """Split dim 0 into ``size`` equal chunks, send chunk j to rank j and
    receive one chunk from every rank, in rank order (reference:
    horovod_tpu/torch/mpi_ops.py:325-349; ``runtime.py:545``
    ``enqueue_alltoall``). Dim 0 must divide evenly by the world size. One
    ``all_to_all_single`` an op, issued at every world size."""
    _divisible("alltoall", tensor)
    wire = _plane(tensor)
    inner = runtime.get_runtime().enqueue_alltoall(
        _op_name("alltoall", name), wire)
    COUNTS["alltoall"] += 1
    return Handle(inner, _narrow(tensor))


def alltoall(tensor, name=None) -> torch.Tensor:
    """Sync all-to-all (see :func:`alltoall_async`)."""
    return synchronize(alltoall_async(tensor, name=name))


def broadcast_async_(tensor: torch.Tensor, root_rank: int,
                     name: Optional[str] = None) -> Handle:
    """Every rank's ``tensor`` becomes rank ``root_rank``'s, in place."""
    world = basics.size()
    if not 0 <= root_rank < world:
        raise ValueError(f"root_rank {root_rank} out of range [0, {world})")
    wire = _plane(tensor)
    inner = runtime.get_runtime().enqueue_broadcast(
        _op_name("broadcast", name), wire, root_rank)
    COUNTS["broadcast"] += 1

    def finish(_):
        if wire is not tensor:
            tensor.copy_(wire)
        return tensor

    return Handle(inner, finish)


def broadcast_async(tensor, root_rank, name=None) -> Handle:
    return broadcast_async_(tensor.clone(), root_rank, name=name)


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Every rank receives rank ``root_rank``'s tensor (reference:
    horovod/torch/mpi_ops.py broadcast). Differentiable: the root's
    gradient is the sum of the ranks' gradients, the others' zero
    (``horovod_tpu/torch/mpi_ops.py:404-425``)."""
    return _BroadcastFunction.apply(tensor, root_rank, name)


def broadcast_(tensor, root_rank: int, name: Optional[str] = None):
    return synchronize(broadcast_async_(tensor, root_rank, name=name))


def broadcast_object(obj, root_rank: int = 0, name: Optional[str] = None):
    """Broadcast a picklable object from ``root_rank``: one direct call on
    the default group, which the runtime never uses. (Not on the control
    group: the runtime's thread issues there, and a call from another
    thread would meet its cycles in a different order on each rank.)
    ``name`` is the JAX binding's; a direct call needs none."""
    world = basics.size()
    if not 0 <= root_rank < world:
        raise ValueError(f"root_rank {root_rank} out of range [0, {world})")
    box = [obj]
    dist.broadcast_object_list(box, src=root_rank)
    COUNTS["broadcast"] += 1
    return box[0]


class SparseHandle:
    """Future of a sparse allreduce (``horovod_tpu/torch/mpi_ops.py:193-
    225``): the two gathers of every rank's indices and values. ``wait``
    decompresses the values and builds the COO result; duplicates sum on
    ``coalesce``, so the result is the allreduce of the dense tensors the
    ranks hold."""

    __slots__ = ("_h_idx", "_h_vals", "_shape", "_average", "_compression",
                 "_ctx", "_result")

    def __init__(self, h_idx: Handle, h_vals: Handle, shape,
                 average: bool, compression=Compression.none, ctx=None):
        self._h_idx, self._h_vals = h_idx, h_vals
        self._shape, self._average = shape, average
        self._compression, self._ctx = compression, ctx
        self._result = None

    def poll(self) -> bool:
        return self._result is not None or (self._h_idx.poll()
                                            and self._h_vals.poll())

    def wait(self) -> torch.Tensor:
        if self._result is None:
            idx = synchronize(self._h_idx)    # (nnz of all ranks, ndim)
            vals = self._compression.decompress(
                synchronize(self._h_vals), self._ctx)
            if self._average:
                vals = vals / basics.size()
            self._result = torch.sparse_coo_tensor(
                idx.t(), vals, self._shape).coalesce()
        return self._result


def sparse_allreduce_async(tensor: torch.Tensor, average: bool = True,
                           name: Optional[str] = None,
                           compression=Compression.none) -> SparseHandle:
    """Allreduce a sparse COO tensor without densifying it
    (``horovod_tpu/torch/mpi_ops.py:228-245``): every rank's coalesced
    indices and values are gathered (ragged dim 0: each rank has its own
    nnz), as ``"<name>.indices"`` and ``"<name>.values"``; ``compression``
    casts the values on the wire (the JAX package's
    ``exchange_sparse_grad``)."""
    t = tensor.coalesce()
    name = _op_name("sparse_allreduce", name)
    values, ctx = compression.compress(t.values().contiguous())
    h_idx = allgather_async(t.indices().t().contiguous(),
                            name=f"{name}.indices")
    h_vals = allgather_async(values.contiguous(), name=f"{name}.values")
    return SparseHandle(h_idx, h_vals, t.shape, average, compression, ctx)


class _AllreduceFunction(torch.autograd.Function):
    """grad(allreduce) = allreduce(grad) (``horovod_tpu/torch/
    mpi_ops.py:358-371``); a named forward's gradient is
    ``"<name>.grad"``."""

    @staticmethod
    def forward(ctx, tensor, op, name):
        ctx.op, ctx.name = op, name
        return synchronize(allreduce_async(tensor, op=op, name=name))

    @staticmethod
    def backward(ctx, grad):
        name = f"{ctx.name}.grad" if ctx.name else None
        return synchronize(allreduce_async(grad, op=ctx.op, name=name)), \
            None, None


class _AllgatherFunction(torch.autograd.Function):
    """grad(allgather) = this rank's rows of the sum-allreduce of the
    gradient (``horovod_tpu/torch/mpi_ops.py:374-401``). The backward
    gathers the ranks' dim 0 to find them, so a forward-only caller never
    pays for it."""

    @staticmethod
    def forward(ctx, tensor, name):
        ctx.dim0, ctx.name = tensor.shape[0], name
        return synchronize(allgather_async(tensor, name=name))

    @staticmethod
    def backward(ctx, grad):
        sizes = synchronize(allgather_async(
            torch.tensor([ctx.dim0], device=grad.device),
            name=_op_name("allgather", ctx.name) + ".sizes"))
        offset = int(sizes[:basics.rank()].sum())
        name = f"{ctx.name}.grad" if ctx.name else None
        summed = synchronize(allreduce_async(grad, op=Sum, name=name))
        return summed[offset:offset + ctx.dim0], None


class _BroadcastFunction(torch.autograd.Function):
    """grad(broadcast) = the sum-allreduce of the gradient on the root,
    zero on the other ranks (``horovod_tpu/torch/mpi_ops.py:404-425``)."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        ctx.root_rank, ctx.name = root_rank, name
        return synchronize(broadcast_async(tensor, root_rank, name=name))

    @staticmethod
    def backward(ctx, grad):
        name = f"{ctx.name}.grad" if ctx.name else None
        summed = synchronize(allreduce_async(grad, op=Sum, name=name))
        if basics.rank() != ctx.root_rank:
            summed = torch.zeros_like(summed)
        return summed, None, None


def assert_collective_lane_clear() -> None:
    """Raise :class:`~horovod_tpu_torch.exceptions.OrderedLaneError` when,
    in a world of more than one rank and off the runtime's cycle thread,
    the runtime holds named collectives in flight (the JAX package's guard,
    ``horovod_tpu/ops/collectives.py:89-118``). Call it before issuing a
    collective of your own on a group the runtime also uses (its data
    group, or the default group where ``broadcast_object`` runs), so that
    a cross-rank order hazard raises instead of hanging. At world 1, before
    the runtime starts and on the cycle thread it returns.

    The model-parallel entry points call it too (``ring_attention`` and
    ``ulysses_attention`` forward and backward, ``pipeline_apply``, its
    hand-offs' backward and ``last_stage_value``, ``tp_train_step``'s
    step), though they issue on the axes' own groups: on NCCL two process
    groups whose kernels reach the card in another order on each rank can
    deadlock (a kernel of one waits for a peer whose kernel queues behind
    the other's), and the runtime's thread issues at cycles no caller
    foresees. On four H100s a ring backward with ``DistributedOptimizer``'s
    hooks in flight hung in its third layer. Exchange a model-parallel
    step's gradients after its backward (``allreduce_gradients``, or
    ``make_train_step`` with a plain optimizer): every rank then issues
    the step's model-parallel collectives, then the runtime's."""
    st = state_mod.global_state()
    rt = st.runtime
    if not st.initialized or st.size <= 1 or rt is None:
        return
    if threading.current_thread() is rt._thread:
        return
    n = rt.in_flight()
    if n:
        raise OrderedLaneError(
            f"{n} named collective(s) are still in flight in the runtime; "
            "issuing a collective of the caller's own now can order the "
            "collectives differently across the ranks (a hang or garbage). "
            "Call hvd.synchronize() on the outstanding handles (or "
            "optimizer.synchronize()) first")


def poll(handle) -> bool:
    """True once the collective behind ``handle`` has completed."""
    return handle.poll()


def synchronize(handle) -> torch.Tensor:
    """Wait for the collective and return its result."""
    return handle.wait()
