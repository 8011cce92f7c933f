"""Two-level collectives over sub-communicators (port of
``horovod_tpu/runtime/hierarchy.py``; reference: NCCLHierarchicalAllreduce,
horovod/common/ops/nccl_operations.cc).

Ranks are grouped into slices: an explicit ``HOROVOD_HIERARCHY_GROUP_SIZE``
takes contiguous blocks of ranks, and group size 0 groups the ranks that
share a host name (``HOROVOD_HOSTNAME``, else the machine's), gathered once
through the gloo controller's ``allgather_blob``. A layout that does not
split the world into at least two equal groups of at least two ranks, or a
world under 4, falls back to the flat collectives (:func:`build_plan`, the
JAX package's plan, field for field).

The plan's process groups (:class:`HierarchyGroups`): G intra groups (each
slice, in slot order) and g cross groups (the ranks of one slot, one a
slice), on the data group's backend (NCCL on the card, gloo on the CPU).
``dist.new_group`` is collective over the whole world, so every rank
creates every group, member or not, in that one order; the executor builds
them at its first hierarchical dispatch, which every rank reaches at the
same point of the negotiated order. NCCL starts a communicator at its first
call, so each rank makes one warm call on its two groups there.

The collectives, each hop a call on its own group, issued with
``async_op=True`` on the caller's current stream (the executor's comm
stream) and waited at once: on the card ``wait`` orders the current stream
after the hop without blocking the host, on gloo it blocks.

* :func:`hier_allreduce`: the intra reduce-scatter of the packed slab
  (its length a multiple of g), the cross allreduce of this rank's 1/g
  chunk (in the wire dtype of ``HOROVOD_HIERARCHY_COMPRESSION`` when the
  payload is floating), the intra allgather back into the slab.
* :func:`hier_reducescatter`: the j-major permutation, the intra
  reduce-scatter, the cross reduce-scatter: rank r ends with flat chunk r.
* :func:`hier_allgather`: the intra allgather, then the cross allgather
  of the intra blocks, in rank order.

Numerical contract (the JAX package's): the two-level sum adds in another
order than the flat call, so it is bit-equal to it for integer payloads and
exactly representable floats only. Under compression every rank still ends
with the same bytes (the cross allreduce hands every member one result, and
the intra allgather spreads it), so the integrity digests' CRC vote agrees.

Each hop passes the chaos seam (``resilience.inject("hier_intra" |
"hier_cross", ..., crossings=...)``: a ``netdelay:<ms>:hop=cross`` fault
sleeps its delay once a crossing of the slow link) and is a record of the
comms observatory's ``hier_intra`` or ``hier_cross`` lane: on the card a
CUDA event pair on the stream, read once the device has passed it
(``comms.record_span``), on the CPU the host's interval.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from horovod_tpu_torch import comms
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils import resilience

# torch 2.13 names the one-tensor forms reduce_scatter_single and
# all_gather_single; older releases have only the *_tensor names
_reduce_scatter_one = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather_one = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

# the bytes a host name takes in the roster's gather (equal parts)
_HOST_BYTES = 256

#: member groups built and destroyed in this process
STATS = {"built": 0, "destroyed": 0}


@dataclasses.dataclass(frozen=True)
class HierarchyPlan:
    """One rank's view of the two-level grouping (the JAX package's plan;
    ``layout``, every slice in group order, is the port's addition: each
    rank creates every group).

    ``members`` is this rank's slice in slot order; ``cross_members`` the
    one rank a slice at this rank's ``local_index``. A degenerate plan
    (``group_size`` or ``num_groups`` of 1) runs the flat collectives;
    ``enabled`` says which."""

    world: int
    rank: int
    group_size: int          # g: ranks per slice
    num_groups: int          # G: slices
    members: Tuple[int, ...]
    cross_members: Tuple[int, ...]
    group_index: int
    local_index: int
    source: str              # "env" | "hosts" | "flat"
    layout: Tuple[Tuple[int, ...], ...] = dataclasses.field(
        default=(), compare=False, repr=False)

    @property
    def enabled(self) -> bool:
        return self.group_size > 1 and self.num_groups > 1

    def describe(self) -> str:
        return (f"{self.num_groups}x{self.group_size} ({self.source}); "
                f"rank {self.rank} = group {self.group_index} "
                f"slot {self.local_index}")


def _flat(world: int, rank: int) -> HierarchyPlan:
    return HierarchyPlan(world, rank, 1, world, (rank,),
                         tuple(range(world)), rank, 0, "flat")


def build_plan(net, group_size: int = 0) -> HierarchyPlan:
    """Form groups for ``net``'s world (``net``: ``world``, ``rank`` and
    ``allgather_blob``, as the controllers have them). An explicit
    ``group_size`` takes contiguous blocks with no wire traffic; 0 gathers
    every rank's host name once. Uneven or degenerate layouts fall back to
    a flat plan, an explicit size that does not tile with a warning."""
    w, r = net.world, net.rank
    if w < 4:
        return _flat(w, r)  # two levels need >= 2 groups of >= 2
    if group_size:
        g = int(group_size)
        if g < 2 or w % g or w // g < 2:
            log.warning(
                "hierarchy: HOROVOD_HIERARCHY_GROUP_SIZE=%d does not "
                "tile world %d into >=2 equal groups of >=2 — flat ring",
                g, w)
            return _flat(w, r)
        gi, j = divmod(r, g)
        return HierarchyPlan(
            w, r, g, w // g, tuple(range(gi * g, (gi + 1) * g)),
            tuple(k * g + j for k in range(w // g)), gi, j, "env",
            tuple(tuple(range(k * g, (k + 1) * g)) for k in range(w // g)))
    host = os.environ.get("HOROVOD_HOSTNAME") or socket.gethostname()
    blob = host.encode("utf-8")[:_HOST_BYTES].ljust(_HOST_BYTES, b"\0")
    hosts = [b.rstrip(b"\0").decode("utf-8", "replace")
             for b in net.allgather_blob(blob)]
    by_host = {}
    for rr, h in enumerate(hosts):
        by_host.setdefault(h, []).append(rr)
    groups = sorted(by_host.values(), key=lambda m: m[0])
    sizes = {len(m) for m in groups}
    if len(groups) < 2 or len(sizes) != 1 or next(iter(sizes)) < 2:
        return _flat(w, r)
    g = len(groups[0])
    gi = next(i for i, m in enumerate(groups) if r in m)
    j = groups[gi].index(r)
    return HierarchyPlan(
        w, r, g, len(groups), tuple(groups[gi]),
        tuple(m[j] for m in groups), gi, j, "hosts",
        tuple(tuple(m) for m in groups))


def _cross_of(plan: HierarchyPlan, slot: int) -> List[int]:
    """The ranks of slot ``slot``'s cross group in the group's rank order
    (``new_group`` orders a group's ranks by their world rank)."""
    return sorted(m[slot] for m in plan.layout)


class HierarchyGroups:
    """The process groups of an enabled ``plan``: every intra group (one a
    slice, in group order), then every cross group (one a slot), created
    by every rank; ``intra`` and ``cross`` are this rank's. ``warm``
    makes one call on each of this rank's two groups (a communicator
    starts at its first call). A group that fails to form raises."""

    def __init__(self, plan: HierarchyPlan, backend: str,
                 warm: Optional[torch.device] = None):
        if not plan.enabled:
            raise ValueError(f"a flat plan has no groups: {plan.describe()}")
        self.plan = plan
        intra = cross = None
        for members in plan.layout:
            pg = dist.new_group(list(members), backend=backend)
            if plan.rank in members:
                intra = pg
        for slot in range(plan.group_size):
            ranks = _cross_of(plan, slot)
            pg = dist.new_group(ranks, backend=backend)
            if plan.rank in ranks:
                cross = pg
        if intra is None or cross is None:
            raise RuntimeError(f"hierarchy groups did not form for rank "
                               f"{plan.rank}: {plan.describe()}")
        self.intra, self.cross = intra, cross
        STATS["built"] += 2
        self._rs_order = {}  # device -> the reduce-scatter's permutation
        if warm is not None:
            one = torch.ones(1, device=warm)
            for pg in (intra, cross):
                dist.all_reduce(one, group=pg)

    def destroy(self, abort: bool = False) -> None:
        """Destroy this rank's two groups (``abort``: abort them, for a
        world that lost a peer on the card). Idempotent."""
        groups, self.intra, self.cross = (self.intra, self.cross), None, None
        for pg in groups:
            if pg is None:
                continue
            if abort:
                dist.distributed_c10d._abort_process_group(pg)
            else:
                dist.destroy_process_group(pg)
            STATS["destroyed"] += 1

    def reducescatter_order(self, device) -> torch.Tensor:
        """The j-major permutation of the world's chunks: slot j's
        superchunk holds, in cross-group rank order, the chunks of slot j's
        cross group, so the intra then the cross reduce-scatter hand rank r
        chunk r (``reshape(G, g, c).transpose(1, 0, 2)`` for contiguous
        slices)."""
        order = self._rs_order.get(device)
        if order is None:
            plan = self.plan
            order = self._rs_order[device] = torch.tensor(
                [r for slot in range(plan.group_size)
                 for r in _cross_of(plan, slot)],
                dtype=torch.long, device=device)
        return order

    def allgather_order(self) -> Optional[List[int]]:
        """The ranks whose parts the intra then the cross allgather leave
        at each position, or None when that is rank order."""
        plan = self.plan
        slice_of = {m[0]: m for m in plan.layout}
        first = {r: s[0] for s in plan.layout for r in s}
        order = [r for c in _cross_of(plan, plan.local_index)
                 for r in slice_of[first[c]]]
        return None if order == list(range(plan.world)) else order


class Chain:
    """The hops of one two-level collective: each was issued and waited in
    turn, so ``wait`` has nothing left to do; the chain holds the hops'
    temporaries until the executor lets go of the bin."""

    __slots__ = ("keep",)

    def __init__(self, keep: tuple):
        self.keep = keep

    def wait(self) -> bool:
        return True


def _hop(stream, fn, op: str, lane: str, nbytes: int, world: int):
    """Issue one hop's call, wait for it, and record it on ``lane``: a
    CUDA event pair on the card (read once passed), the host's interval on
    the CPU."""
    if stream is not None:
        s0 = comms.stamp(stream)
        fn().wait()
        s1 = comms.stamp(stream)
        if s0 is not None and s1 is not None and nbytes:
            comms.record_span(op, lane, nbytes, comms.span(s0, s1),
                              world=world)
        return
    t0 = time.perf_counter()
    fn().wait()
    if nbytes:
        comms.record(op, lane, nbytes, time.perf_counter() - t0, world=world)


def _to_wire(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    if wire_dtype is not None and x.is_floating_point() and x.numel() \
            and x.dtype != wire_dtype:
        return x.to(wire_dtype)
    return x


def hier_allreduce(h: HierarchyGroups, buf: torch.Tensor, op,
                   wire_dtype=None, stream=None) -> Chain:
    """Two-level in-place allreduce of the 1-D ``buf`` (its length a
    multiple of g): intra reduce-scatter, cross allreduce of this rank's
    1/g chunk (cast to ``wire_dtype`` when given and the payload is
    floating), intra allgather. An Average stays the caller's: the
    executor divides after assembly, as on the flat path."""
    plan = h.plan
    g, big_g = plan.group_size, plan.num_groups
    if buf.numel() % g:
        raise ValueError(f"hier_allreduce needs a length that is a multiple "
                         f"of {g}, got {buf.numel()}")
    chunk = buf.new_empty(buf.numel() // g)
    resilience.inject("hier_intra", "reducescatter", crossings=0)
    _hop(stream, lambda: _reduce_scatter_one(
        chunk, buf, op=op, group=h.intra, async_op=True),
        "reducescatter", "hier_intra", buf.numel() * buf.element_size(), g)
    # every step of the cross allreduce crosses the slow group boundary
    resilience.inject("hier_cross", "allreduce", crossings=2 * (big_g - 1))
    wire = _to_wire(chunk, wire_dtype)
    _hop(stream, lambda: dist.all_reduce(
        wire, op=op, group=h.cross, async_op=True),
        "allreduce", "hier_cross", wire.numel() * wire.element_size(), big_g)
    if wire is not chunk:
        chunk.copy_(wire)
    resilience.inject("hier_intra", "allgather", crossings=0)
    _hop(stream, lambda: _all_gather_one(
        buf, chunk, group=h.intra, async_op=True),
        "allgather", "hier_intra", buf.numel() * buf.element_size(), g)
    return Chain((chunk, wire))


def hier_reducescatter(h: HierarchyGroups, x: torch.Tensor,
                       out: torch.Tensor, op, wire_dtype=None,
                       stream=None) -> Chain:
    """Two-level reduce-scatter with the flat call's output: rank r's
    ``out`` gets the reduction of flat chunk r of every rank's ``x``.
    ``x.numel()`` must be a multiple of the world (the executor runs the
    flat call otherwise)."""
    plan = h.plan
    w, g, big_g = plan.world, plan.group_size, plan.num_groups
    n = x.numel()
    if n % w:
        raise ValueError(
            f"hier_reducescatter needs size % world == 0, got {n} % {w}")
    c = n // w
    order = h.reducescatter_order(x.device)
    work = x.reshape(w, c).index_select(0, order).reshape(-1)
    sup = work.new_empty(big_g * c)
    resilience.inject("hier_intra", "reducescatter", crossings=0)
    _hop(stream, lambda: _reduce_scatter_one(
        sup, work, op=op, group=h.intra, async_op=True),
        "reducescatter", "hier_intra", n * x.element_size(), g)
    resilience.inject("hier_cross", "reducescatter", crossings=big_g - 1)
    wire = _to_wire(sup, wire_dtype)
    part = out.reshape(-1) if wire is sup else wire.new_empty(c)
    _hop(stream, lambda: _reduce_scatter_one(
        part, wire, op=op, group=h.cross, async_op=True),
        "reducescatter", "hier_cross", wire.numel() * wire.element_size(),
        big_g)
    if part.data_ptr() != out.data_ptr():
        out.reshape(-1).copy_(part)
    return Chain((work, sup, wire, part))


def hier_allgather(h: HierarchyGroups, x: torch.Tensor,
                   out: torch.Tensor, stream=None) -> Chain:
    """Two-level allgather of equal parts: the intra allgather of this
    slice's parts, then the cross allgather of the slices' blocks; ``out``
    holds every rank's ``x`` in rank order."""
    plan = h.plan
    g = plan.group_size
    part = x.contiguous().reshape(-1)
    block = part.new_empty(g * part.numel())
    resilience.inject("hier_intra", "allgather", crossings=0)
    _hop(stream, lambda: _all_gather_one(
        block, part, group=h.intra, async_op=True),
        "allgather", "hier_intra", block.numel() * block.element_size(), g)
    order = h.allgather_order()
    flat = out.reshape(-1)
    gathered = flat if order is None else flat.new_empty(flat.numel())
    resilience.inject("hier_cross", "allgather",
                      crossings=plan.num_groups - 1)
    _hop(stream, lambda: _all_gather_one(
        gathered, block, group=h.cross, async_op=True),
        "allgather", "hier_cross", flat.numel() * flat.element_size(),
        plan.num_groups)
    if order is not None:
        idx = torch.tensor(order, dtype=torch.long, device=flat.device)
        flat.view(plan.world, -1).index_copy_(
            0, idx, gathered.view(plan.world, -1))
    return Chain((part, block, gathered))


def wire_dtype_from_name(name: str) -> Optional[torch.dtype]:
    """``HOROVOD_HIERARCHY_COMPRESSION`` -> the cross hop's wire dtype:
    ``fp16`` and ``bf16`` bfloat16, ``ieee_fp16`` float16 (the JAX
    package's names). ``none``/empty disables compression; unknown names
    raise."""
    name = (name or "none").strip().lower()
    if name in ("", "none", "off", "0", "false"):
        return None
    if name in ("fp16", "bf16", "bfloat16"):
        return torch.bfloat16
    if name in ("ieee_fp16", "float16", "f16"):
        return torch.float16
    raise ValueError(
        f"unknown HOROVOD_HIERARCHY_COMPRESSION {name!r} "
        "(expected none | fp16 | ieee_fp16)")

