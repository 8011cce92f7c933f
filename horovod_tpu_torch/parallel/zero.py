"""ZeRO stages 1, 2 and 3 over the port's collectives.

Port of the one-process-a-rank ("local") lane of
``horovod_tpu/parallel/zero.py``. The gradient allreduce is decomposed as

    reduce-scatter  ->  update on the local shard  ->  allgather

so each rank holds and updates only 1/N of the optimizer state, with the
same bytes on the wire as an allreduce (stage 1). Stages 2 and 3 drop the
"same bytes":

* **Stage 2**: gradients live only as the local 1/N shard
  (:class:`ShardedGrads`), made by :func:`scatter_gradients` or released
  bucket by bucket during the backward by
  ``GradReleasePlan(reduce_scatter=True)`` (``parallel/buckets.py``). The
  updates consume them and skip their own reduce-scatter.
* **Stage 3**: parameters are sharded at rest (:class:`ShardedParams`,
  from :func:`shard_params`) and gathered group by group on demand
  (:func:`iter_param_buckets`, :func:`gather_params`), with up to
  ``HOROVOD_ZERO_PREFETCH_BUCKETS`` group allgathers in flight ahead of
  the consumer. An update given ``ShardedParams`` returns them updated
  with no trailing allgather.

The parameters are flattened into one flat buffer per dtype group, laid
out exactly as the JAX package lays it out (:func:`build_spec`; a
``partition``, such as a release plan's buckets, gives one group per cell
and dtype): each per-rank shard is padded to a size bucket of
``HOROVOD_FUSION_BUCKET_QUANTUM`` (``runtime/fusion_buffer.py``), and the
pad holds zeros, the identity of sum and average, so the padded result
bit-matches the unpadded one.

Two entry points:

* :func:`sharded_adamw`: step-level AdamW with flat float32 master
  weights and moments in the local shard, one launch of the flat AdamW
  kernel a group (:mod:`horovod_tpu_torch.ops.fused_optimizer`).
* :func:`sharded_update`: any elementwise ``torch.optim`` optimizer (SGD,
  Adam, AdamW, ...) run over the flat shards. Where the JAX package keeps
  optax's delta contract, the port keeps PyTorch's: an optimizer of the
  user's class and hyperparameters steps the shard tensors, whose ``.grad``
  is the reduced gradient shard. What ``DistributedOptimizer(...,
  shard_optimizer_states=True)`` returns.

The collectives are those of :mod:`horovod_tpu_torch.ops.collectives`,
issued at every world size under names that are the same every step
(``sharded.adamw.grads.g<i>``, ``zero2.grads.g<i>``,
``zero3.params.g<i>``, ...), so the runtime's response cache answers them
from the second step on. Updates take and return dicts keyed like
``named_parameters()`` and write gathered values into the given tensors
in place: the port's departure from the JAX package's pure functions,
which saves a copy of the model.

The checkpoint layer's view of a sharded state (``ckpt/``):
:func:`is_sharded_state`, :func:`layout_of`, :func:`export_shard_arrays`
and :func:`from_full_buffers`, which re-slices full flat buffers read from
shard files under another world size, for all four kinds (the JAX
package's ``zero.py:1595-1732``).

The observability planes (the JAX package's hooks): each group's
reduce-scatter or allgather is an ``op_dispatch`` and ``op_complete``
flight event with its phase (``grad_scatter``, ``sharded_grads``,
``sharded_updates``, ``sharded_params``, ``param_gather``), shard, group
and bytes, and a record of the comms observatory's ``zero`` lane with its
exact payload bytes (the padded group): on the card its seconds are the
device's, from an ``enable_timing`` CUDA event pair on the caller's stream
(recorded at the dispatch and after the wait, less any part before the
previous group's end), read once the card has passed it; on the CPU the
host's. The memory ledger holds ``optimizer_shards`` (the flat AdamW
master and moments, or the inner optimizer's state), ``grad_shards`` and
``param_shards``, and adopts the optimizer's shard tensors (a re-slice or
a re-sync adopts the new ones in their place); the optimizer's state is
noted when it is made (the flat AdamW state at ``init``, a torch
optimizer's at its first step), since the updates write it in place. A stage-3 gather's stall is
the goodput ledger's ``exposed_comm``; ``zero_shard_params``,
``sharded_resync`` and ``sharded_resync_replica`` are flight events.

Not ported: the traced (``shard_map``) and single-controller stacked
lanes, which a one-process-a-GPU world has no counterpart of; the
metrics families. The stage-3 gather's stall and hidden seconds are plain
counters here (:data:`GATHER_SECONDS`).
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional

import torch

from horovod_tpu_torch import comms
from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch import memory
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.fused_adamw import adamw_scalars, check_keys
from horovod_tpu_torch.ops.fused_optimizer import flat_adamw_shard
from horovod_tpu_torch.runtime.fusion_buffer import bucket_elems
from horovod_tpu_torch.utils import env

_INT32_MAX = 2**31 - 1

#: stage-3 gather seconds on the host: ``stall``, the consumer blocked on a
#: group's allgather; ``hidden``, the rest of each gather's time from
#: dispatch to use, spent under the consumer's work (on the card the wait
#: ends when the runtime has queued the collective: the device's own wait
#: is a stream dependency the host does not see)
GATHER_SECONDS = {"stall": 0.0, "hidden": 0.0}


def stage_from_env() -> int:
    """``HOROVOD_ZERO_STAGE`` for the stock step wiring: 1 (optimizer state
    sharded, the default), 2 (+ gradient shards by reduce-scatter release),
    3 (+ parameters sharded at rest). Clamped to [1, 3]."""
    return max(1, min(3, env._get_int(env.HOROVOD_ZERO_STAGE, 1)))


# The autotuner's committed prefetch window (runtime._autotune_sync; 0:
# none; cleared when the runtime stops; horovod_tpu/parallel/zero.py:
# 161-190).
_autotuned_prefetch_buckets = 0


def set_autotuned_prefetch_buckets(n: int) -> None:
    """The autotuner's commit hook: the stage-3 prefetch window (0 clears
    it)."""
    global _autotuned_prefetch_buckets
    _autotuned_prefetch_buckets = max(0, int(n))


def prefetch_buckets_from_env() -> int:
    """``HOROVOD_ZERO_PREFETCH_BUCKETS`` (the autotuner's committed value
    wins while set): how many group allgathers a stage-3 gather keeps in
    flight ahead of its consumer (at least 1)."""
    if _autotuned_prefetch_buckets > 0:
        return _autotuned_prefetch_buckets
    return max(1, env._get_int(env.HOROVOD_ZERO_PREFETCH_BUCKETS,
                               env.DEFAULT_ZERO_PREFETCH_BUCKETS))


# ---------------------------------------------------------------------------
# Flat layout
# ---------------------------------------------------------------------------

class LeafMeta(NamedTuple):
    """Shape/dtype stand-in for a leaf: enough for :func:`build_spec`."""

    shape: tuple
    dtype: Any  # a torch.dtype


class GroupSpec(NamedTuple):
    """Flat layout of one same-dtype group of leaves."""

    dtype: str        # numpy-style name: "float32", "bfloat16", ...
    indices: tuple    # positions in the leaf list
    shapes: tuple     # per-leaf shapes
    sizes: tuple      # per-leaf element counts
    n: int            # total real elements
    shard_elems: int  # per-rank shard length (bucket-padded)
    padded: int       # shard_elems * world


class ZeroSpec(NamedTuple):
    """Static description of a sharded flat layout."""

    groups: tuple     # of GroupSpec
    world: int
    rank: int
    num_leaves: int


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``torch.bfloat16`` ->
    ``"bfloat16"``), the JAX package's group key."""
    return str(dtype).removeprefix("torch.")


def group_dtype(g: GroupSpec) -> torch.dtype:
    return getattr(torch, g.dtype)


def _quantum_bytes() -> int:
    return env._get_int(env.HOROVOD_FUSION_BUCKET_QUANTUM,
                        env.DEFAULT_FUSION_BUCKET_QUANTUM_BYTES)


def build_spec(leaves, world: int, rank: int, quantum_bytes: int, *,
               partition=None) -> ZeroSpec:
    """Group ``leaves`` (tensors or :class:`LeafMeta`) by dtype, sorted by
    dtype name, and lay each group out as one flat buffer whose per-rank
    shard is a size bucket (identity at or under ``quantum_bytes``, next
    power-of-two multiple above), so the padded total splits evenly into
    ``world`` shards (reference: zero.py:237-276).

    ``partition``: an ordered list of cells of leaf positions (a release
    plan's buckets). Each cell becomes its own groups, one a dtype, in
    cell order; leaves that no cell names form no group."""
    if partition is None:
        partition = [range(len(leaves))]
    cells = []
    for cell in partition:
        by_dtype: Dict[str, list] = {}
        for i in cell:
            by_dtype.setdefault(dtype_name(leaves[i].dtype), []).append(i)
        cells.extend((dts, by_dtype[dts]) for dts in sorted(by_dtype))
    groups = []
    for dts, idxs in cells:
        shapes = tuple(tuple(int(d) for d in leaves[i].shape) for i in idxs)
        sizes = tuple(int(torch.Size(s).numel()) for s in shapes)
        n = int(sum(sizes))
        per = -(-n // world)  # ceil
        shard = bucket_elems(per, getattr(torch, dts).itemsize, quantum_bytes)
        groups.append(GroupSpec(
            dtype=dts, indices=tuple(idxs), shapes=shapes, sizes=sizes,
            n=n, shard_elems=shard, padded=shard * world))
    return ZeroSpec(groups=tuple(groups), world=int(world), rank=int(rank),
                    num_leaves=len(leaves))


def _local_spec(leaves, partition=None) -> ZeroSpec:
    return build_spec(leaves, basics.size(), basics.rank(), _quantum_bytes(),
                      partition=partition)


def _leaves_of(tree):
    """``(keys, leaves)`` of a dict (keys in its order) or of a sequence
    (keys None)."""
    if isinstance(tree, dict):
        return tuple(tree), list(tree.values())
    return None, list(tree)


def _pack_group(leaves, g: GroupSpec) -> torch.Tensor:
    """Flatten the group's leaves (``leaves[i]`` for each of its indices)
    into one (padded,) vector; the pad holds zeros, the sum/average
    reduction identity."""
    parts = [leaves[i].reshape(-1) for i in g.indices]
    pad = g.padded - g.n
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _shard_of(flat: torch.Tensor, g: GroupSpec, rank: int) -> torch.Tensor:
    """This rank's slice of a packed group, in its own storage."""
    return flat[rank * g.shard_elems:(rank + 1) * g.shard_elems].clone()


def _views(flat: torch.Tensor, g: GroupSpec) -> Dict[int, torch.Tensor]:
    """``{leaf position: view of flat}`` for the group's leaves."""
    out, off = {}, 0
    for i, shape, size in zip(g.indices, g.shapes, g.sizes):
        out[i] = flat[off:off + size].view(shape)
        off += size
    return out


def _unpack_group(flat: torch.Tensor, g: GroupSpec, out: list) -> None:
    """Write the group's slices of ``flat`` into the tensors ``out[i]``."""
    for i, view in _views(flat, g).items():
        out[i].copy_(view)


def _check_dense(leaves) -> None:
    for leaf in leaves:
        if leaf.is_sparse:
            raise ValueError(
                "shard_optimizer_states does not support sparse gradient "
                "leaves; densify them before the flat pack or keep the "
                "replicated path for sparse models")


def _check_world(spec: ZeroSpec, what: str) -> None:
    if spec.world != basics.size():
        raise ValueError(
            f"{what} was built for world {spec.world} but the current "
            f"world is {basics.size()}")


def _check_count(leaves, spec: ZeroSpec, what: str = "gradient") -> None:
    if len(leaves) != spec.num_leaves:
        raise ValueError(
            f"{what} tree has {len(leaves)} leaves but the sharded state "
            f"was built for {spec.num_leaves}")


# the flight recorder's phase of each collective name prefix
_PHASES = {"zero2.grads": "grad_scatter",
           "sharded.grads": "sharded_grads",
           "sharded.adamw.grads": "sharded_grads",
           "sharded.params": "sharded_updates",
           "sharded.adamw.params": "sharded_params",
           "zero3.params": "param_gather"}


class _Phase:
    """One group's collective of a ZeRO phase, for the observability
    planes: ``op_dispatch`` now, and at :meth:`done` ``op_complete`` and
    the ``zero``-lane comms record. On the card (comms on) its seconds
    come from ``enable_timing`` CUDA events on the caller's stream, the
    one recorded here and one after the wait (which ordered the stream
    after the collective); on the CPU from the host's clock."""

    __slots__ = ("op", "phase", "shard", "group", "nbytes", "world",
                 "device", "t0", "start")

    def __init__(self, op: str, prefix: str, spec: ZeroSpec, gi: int,
                 nbytes: int, device: torch.device):
        self.op, self.phase = op, _PHASES[prefix]
        self.shard, self.group = int(spec.rank), gi
        self.nbytes, self.world = int(nbytes), spec.world
        self.device = device
        flight_recorder.emit("op_dispatch", op=op, phase=self.phase,
                             shard=self.shard, group=gi, bytes=self.nbytes)
        self.t0 = time.monotonic()
        self.start = _stamp(device)

    def done(self, after=None):
        """The collective's wait returned; returns the end stamp (None on
        the CPU), which bounds the next group's start."""
        seconds = time.monotonic() - self.t0
        flight_recorder.emit("op_complete", op=self.op, phase=self.phase,
                             shard=self.shard, group=self.group,
                             seconds=round(seconds, 6))
        if self.start is None:
            comms.record(self.op, "zero", self.nbytes, max(seconds, 1e-9),
                         world=self.world)
            return None
        end = _stamp(self.device)
        if end is not None:
            comms.record_span(self.op, "zero", self.nbytes,
                              comms.span(self.start, end, after),
                              world=self.world)
        return end


def _stamp(device: torch.device):
    """A timing stamp on ``device``'s current stream, recorded now; None on
    the CPU or with the comms plane off."""
    if device.type != "cuda":
        return None
    return comms.stamp(torch.cuda.current_stream(device))


def _scatter(leaves, spec: ZeroSpec, average: bool, compression,
             prefix: str) -> list:
    """Reduce-scatter each group's packed flat gradient (every group in
    flight before the first wait) under the names ``<prefix>.g<i>``; the
    local shards, decompressed, in each group's dtype."""
    op = collectives.Average if average else collectives.Sum
    pending = []
    for gi, g in enumerate(spec.groups):
        wire, ctx = compression.compress(_pack_group(leaves, g))
        ph = _Phase("reducescatter", prefix, spec, gi,
                    wire.numel() * wire.element_size(), wire.device)
        pending.append((ctx, ph, collectives.reducescatter_async(
            wire, op=op, name=f"{prefix}.g{gi}")))
    out, end = [], None
    for g, (ctx, ph, h) in zip(spec.groups, pending):
        shard = collectives.synchronize(h)
        end = ph.done(after=end)
        out.append(compression.decompress(shard, ctx).to(group_dtype(g)))
    return out


def _gather_into(shards, spec: ZeroSpec, out: list, prefix: str) -> None:
    """Allgather every group's shard (all in flight before the first wait)
    under ``<prefix>.g<i>`` and write the gathered leaves into ``out``."""
    handles = [(_Phase("allgather", prefix, spec, gi,
                       s.numel() * s.element_size() * spec.world, s.device),
                collectives.allgather_async(s, name=f"{prefix}.g{gi}"))
               for gi, s in enumerate(shards)]
    end = None
    for g, (ph, h) in zip(spec.groups, handles):
        full = collectives.synchronize(h)
        end = ph.done(after=end)
        _unpack_group(full, g, out)


def _note_optimizer_shards(state) -> None:
    """The memory ledger's ``optimizer_shards``: the flat AdamW master and
    moments, or the inner optimizer's state over the shards (each storage
    once); the tensors are adopted in place of the earlier ones."""
    t = memory.tracker()
    if not t.enabled:
        return
    if isinstance(state, FlatAdamState):
        tree = (state.master, state.mu, state.nu)
    else:
        tree = [dict(v) for v in state.inner.state.values()]
    t.note_tree_bytes("optimizer_shards", tree)
    t.adopt("optimizer_shards", tree, replace=True)


def _note_shards(subsystem: str, shards) -> None:
    """The memory ledger's ``grad_shards`` or ``param_shards``."""
    memory.tracker().note_tree_bytes(subsystem, list(shards))


# ---------------------------------------------------------------------------
# Stage 2: gradients as shards
# ---------------------------------------------------------------------------

class ShardedGrads(NamedTuple):
    """Gradients living only as the local 1/N shard (ZeRO-2): one flat
    ``(shard_elems,)`` tensor a group. Made by :func:`scatter_gradients`
    or a reduce-scatter ``GradReleasePlan``; consumed by
    ``sharded_adamw``'s ``apply`` and ``sharded_update``, which then skip
    their own reduce-scatter."""

    spec: ZeroSpec
    shards: tuple


def _check_shard_spec(got: ZeroSpec, want: ZeroSpec, what: str) -> None:
    if got.groups == want.groups and got.world == want.world:
        return
    raise ValueError(
        f"{what} layout does not match the sharded optimizer state — "
        "build both from the same partition (e.g. sharded_adamw(..., "
        "partition=plan.zero_partition(params)) next to a "
        "reduce-scatter GradReleasePlan), and re-init after the world "
        "changes")


@torch.no_grad()
def scatter_gradients(grads, *, spec: Optional[ZeroSpec] = None,
                      average: bool = True, compression=Compression.none,
                      partition=None) -> ShardedGrads:
    """Reduce-scatter whole gradients (a dict keyed like the params, or a
    list) into :class:`ShardedGrads`: stage 2 when the gradients arrive
    whole (``GradReleasePlan(reduce_scatter=True)`` releases them bucket
    by bucket during the backward instead).

    ``spec`` aligns the layout with an optimizer state (pass
    ``state.spec``); otherwise one is built, from ``partition`` if given.
    ``compression`` rides the wire as in stage 1."""
    _, leaves = _leaves_of(grads)
    _check_dense(leaves)
    if spec is None:
        spec = _local_spec(leaves, partition)
    _check_world(spec, "scatter_gradients spec")
    if len(leaves) != spec.num_leaves:
        raise ValueError(
            f"gradient tree has {len(leaves)} leaves but the spec was "
            f"built for {spec.num_leaves}")
    shards = tuple(_scatter(leaves, spec, average, compression,
                            "zero2.grads"))
    _note_shards("grad_shards", shards)
    return ShardedGrads(spec, shards)


# ---------------------------------------------------------------------------
# Stage 3: parameters sharded at rest, gathered on demand
# ---------------------------------------------------------------------------

class ShardedParams:
    """Parameters sharded at rest (ZeRO-3): one flat ``(shard_elems,)``
    tensor a group, plus the keys of the dict they came from (None for a
    list), which stand in for the JAX package's tree structure."""

    __slots__ = ("spec", "names", "shards")

    def __init__(self, spec: ZeroSpec, names, shards):
        self.spec = spec
        self.names = names
        self.shards = tuple(shards)

    def __repr__(self):
        return (f"ShardedParams(world={self.spec.world}, "
                f"rank={self.spec.rank}, groups={len(self.spec.groups)})")


@torch.no_grad()
def shard_params(params, *, partition=None) -> ShardedParams:
    """Keep only this rank's 1/N flat slice of each (padded) group of
    ``params`` (a dict keyed like ``named_parameters()``, or a list): the
    stage-3 entry. The caller drops the full tensors it no longer needs."""
    names, leaves = _leaves_of(params)
    _check_dense(leaves)
    spec = _local_spec(leaves, partition)
    sp = ShardedParams(spec, names, (
        _shard_of(_pack_group(leaves, g), g, spec.rank)
        for g in spec.groups))
    _note_shards("param_shards", sp.shards)
    flight_recorder.emit("zero_shard_params", rank=int(spec.rank),
                         world=int(spec.world), groups=len(spec.groups))
    return sp


def gather_hidden_fraction() -> float:
    """Share of the stage-3 gathers' time hidden under the consumer's
    work, over every gather so far: hidden / (hidden + stall); 0.0 before
    any gather."""
    total = GATHER_SECONDS["stall"] + GATHER_SECONDS["hidden"]
    return GATHER_SECONDS["hidden"] / total if total else 0.0


def _iter_group_gathers(sp: ShardedParams, prefetch=None):
    """Yield ``(group_index, full_flat_buffer)`` in group order, with up to
    ``prefetch`` group allgathers in flight ahead of the consumer: group
    k + window is dispatched when group k has been waited for. The names
    (``zero3.params.g<i>``) are the same every step. A consumer that stops
    early still has every dispatched gather waited for."""
    spec = sp.spec
    _check_world(spec, "ShardedParams")
    window = max(1, int(prefetch if prefetch is not None
                        else prefetch_buckets_from_env()))
    n = len(spec.groups)
    pending: dict = {}

    def dispatch(gi):
        s = sp.shards[gi]
        ph = _Phase("allgather", "zero3.params", spec, gi,
                    s.numel() * s.element_size() * spec.world, s.device)
        pending[gi] = (collectives.allgather_async(
            s, name=f"zero3.params.g{gi}"), time.monotonic(), ph)

    nxt = 0
    stall = hidden = 0.0
    end = None
    try:
        while nxt < min(window, n):
            dispatch(nxt)
            nxt += 1
        for gi in range(n):
            h, t_disp, ph = pending.pop(gi)
            t_wait = time.monotonic()
            full = collectives.synchronize(h)
            t_done = time.monotonic()
            end = ph.done(after=end)
            if nxt < n:
                dispatch(nxt)
                nxt += 1
            stall += t_done - t_wait
            hidden += max(0.0, t_wait - t_disp)
            yield gi, full
    finally:
        for h, _, _ in pending.values():
            collectives.synchronize(h)
        GATHER_SECONDS["stall"] += stall
        GATHER_SECONDS["hidden"] += hidden
        if stall > 0:
            # the step was ready and waited on the wire: exposed
            # communication, not input idleness
            goodput.record_span("exposed_comm", stall)


def gather_params(sp: ShardedParams, *, prefetch=None):
    """The full parameters from :class:`ShardedParams` (a dict keyed as
    they were, or a list), every group gathered under the prefetch
    window. For a bounded footprint consume :func:`iter_param_buckets`
    and drop each bucket after use."""
    out = [None] * sp.spec.num_leaves
    for gi, full in _iter_group_gathers(sp, prefetch):
        for i, view in _views(full, sp.spec.groups[gi]).items():
            out[i] = view
    return dict(zip(sp.names, out)) if sp.names is not None else out


def iter_param_buckets(sp: ShardedParams, *, prefetch=None):
    """Yield ``(group_index, {leaf_position: tensor})`` group by group in
    layout order, the next groups' allgathers already in flight
    (``prefetch``, default ``HOROVOD_ZERO_PREFETCH_BUCKETS``). The tensors
    are views of the group's gathered buffer: dropping the dict frees
    it."""
    for gi, full in _iter_group_gathers(sp, prefetch):
        yield gi, _views(full, sp.spec.groups[gi])


# ---------------------------------------------------------------------------
# Generic elementwise wrapper
# ---------------------------------------------------------------------------

class ShardedOptState(NamedTuple):
    """State of :func:`sharded_update`: the layout and the inner
    ``torch.optim`` optimizer over the flat shard tensors (one a group),
    whose state is 1/N of the replicated optimizer's."""

    spec: ZeroSpec
    inner: torch.optim.Optimizer


class ShardedOptimizer:
    """What :func:`sharded_update` returns.

    Functional, as the JAX package's transformation: ``init(params) ->
    ShardedOptState`` and ``update(grads, state, params) -> (params,
    state)``. As a ``torch.optim`` optimizer over the wrapped one's
    parameters: ``zero_grad()`` and ``step()``, which read each
    parameter's ``.grad`` (or take ``grads=``, a :class:`ShardedGrads`),
    with the state made at the first step (:attr:`state`)."""

    #: it reduce-scatters the gradients itself (``training.make_train_step``)
    exchanges_gradients = True

    def __init__(self, optimizer: torch.optim.Optimizer, named_parameters,
                 average: bool, compression, sparse_as_dense: bool,
                 partition):
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in optimizer.param_groups]
        if any(h != hyper[0] for h in hyper[1:]):
            raise ValueError(
                "sharded_update lays every parameter into flat per-dtype "
                "shards, so they must share one set of hyperparameters; "
                "got param groups that differ")
        self._cls, self._hyper = type(optimizer), hyper[0]
        params = [p for g in optimizer.param_groups for p in g["params"]]
        if named_parameters is None:
            named_parameters = [(f"sharded.noname.{i}", p)
                                for i, p in enumerate(params)]
        named_parameters = list(named_parameters)
        named = {id(p) for _, p in named_parameters}
        if any(id(p) not in named for p in params):
            raise ValueError("named_parameters was specified but one or more "
                             "optimizer parameters were not named")
        wanted = {id(p) for p in params}
        self._params = {n: p for n, p in named_parameters if id(p) in wanted}
        self._average = average
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense
        self._partition = partition
        self.state: Optional[ShardedOptState] = None

    def _inner(self, shards) -> torch.optim.Optimizer:
        return self._cls([{"params": list(shards), **self._hyper}])

    @torch.no_grad()
    def init(self, params) -> ShardedOptState:
        """The state over ``params``: a dict keyed like
        ``named_parameters()`` or a list (the inner optimizer steps copies
        of this rank's shards), or :class:`ShardedParams` (it steps their
        shard tensors themselves)."""
        if isinstance(params, ShardedParams):
            state = ShardedOptState(params.spec, self._inner(params.shards))
        else:
            _, leaves = _leaves_of(params)
            _check_dense(leaves)
            spec = _local_spec(leaves, self._partition)
            state = ShardedOptState(spec, self._inner(
                _shard_of(_pack_group(leaves, g), g, spec.rank)
                for g in spec.groups))
        _note_optimizer_shards(state)
        return state

    @torch.no_grad()
    def update(self, grads, state: ShardedOptState, params):
        """One step: each shard's ``.grad`` is its reduced gradient shard
        (from the reduce-scatter of ``grads``, or ``grads`` itself when it
        is :class:`ShardedGrads`), then the inner ``step()``; then the
        updated shards are allgathered into ``params`` in place, or, when
        ``params`` is the :class:`ShardedParams` the state was made over,
        they stay sharded. Returns ``(params, state)``."""
        if not isinstance(state, ShardedOptState):
            raise TypeError(
                "sharded_update state must be ShardedOptState (was this "
                "optimizer initialized with shard_optimizer_states?)")
        spec = state.spec
        _check_world(spec, "sharded state")
        if isinstance(grads, ShardedGrads):
            _check_shard_spec(grads.spec, spec,
                              "pre-scattered gradient (ShardedGrads)")
            gshards = list(grads.shards)
        else:
            _, gleaves = _leaves_of(grads)
            if self._sparse_as_dense:
                gleaves = [g.to_dense() if g.is_sparse else g
                           for g in gleaves]
            _check_dense(gleaves)
            _check_count(gleaves, spec)
            gshards = _scatter(gleaves, spec, self._average,
                               self._compression, "sharded.grads")
        shards = state.inner.param_groups[0]["params"]
        for s, g in zip(shards, gshards):
            s.grad = g
        first = not state.inner.state  # torch optimizers make it lazily
        state.inner.step()
        for s in shards:
            s.grad = None
        if first:
            _note_optimizer_shards(state)
        if isinstance(params, ShardedParams):
            _check_shard_spec(params.spec, spec,
                              "ShardedParams (stage-3 params)")
            if any(a is not b for a, b in zip(params.shards, shards)):
                raise ValueError("the sharded state steps other shard "
                                 "tensors: init it over these ShardedParams")
            return params, state
        _, leaves = _leaves_of(params)
        _check_count(leaves, spec, "parameter")
        _gather_into(shards, spec, leaves, "sharded.params")
        return params, state

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params.values():
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def step(self, closure=None, grads=None):
        """Update the wrapped optimizer's parameters from their ``.grad``
        (a parameter without one counts as a zero gradient, as the JAX
        package's gradients of unused leaves are), or from ``grads``."""
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        if self.state is None:
            self.state = self.init(self._params)
        if grads is None:
            grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                     for k, p in self._params.items()}
        self.update(grads, self.state, self._params)
        return loss


def sharded_update(optimizer: torch.optim.Optimizer, named_parameters=None,
                   *, average: bool = True, compression=Compression.none,
                   sparse_as_dense: bool = False,
                   partition=None) -> ShardedOptimizer:
    """Wrap an elementwise ``torch.optim`` optimizer with ZeRO sharding
    (reference: zero.py:830-1214): an optimizer of its class and
    hyperparameters steps this rank's flat shard of each dtype group, so
    its state is 1/N of the replicated one's. Each step reduce-scatters
    the packed gradients (``average`` divides by the world;
    ``compression`` on the wire), sets the shards' ``.grad``, steps, and
    allgathers the updated shards into the parameters: for an elementwise
    optimizer the same bits as the replicated ``DistributedOptimizer``.

    Stage 2: a :class:`ShardedGrads` (``step(grads=...)`` or ``update``)
    skips the reduce-scatter; ``partition`` lines the layout up with a
    release plan's buckets (``plan.zero_partition(params)``). Stage 3:
    ``init`` over :class:`ShardedParams` steps their shards in place and
    gathers nothing.

    Non-elementwise optimizers (a global-norm clip inside, LAMB's trust
    ratio) would see 1/N of the elements: clip before the wrapper. Wrap
    an optimizer before its first step: its state is not carried over."""
    return ShardedOptimizer(optimizer, named_parameters, average,
                            compression, sparse_as_dense, partition)


# ---------------------------------------------------------------------------
# Flat AdamW on the kernel
# ---------------------------------------------------------------------------

class FlatAdamState(NamedTuple):
    """State of :func:`sharded_adamw`: per dtype group, the local shard of
    the flat fp32 master weights and Adam moments (about 12 bytes per
    parameter / N on each card)."""

    spec: ZeroSpec
    count: int
    master: tuple  # per group, float32 (shard_elems,)
    mu: tuple
    nu: tuple


class ShardedAdamW(NamedTuple):
    """Step-level sharded fused AdamW: ``apply(params, state, grads) ->
    (params, new_state)``."""

    init: callable
    apply: callable
    #: ``apply`` reduce-scatters the gradients itself
    exchanges_gradients = True


def sharded_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, weight_decay: float = 1e-4, *,
                  average: bool = True, compression=Compression.none,
                  partition=None) -> ShardedAdamW:
    """ZeRO-1/2/3 fused AdamW: reduce-scatter the packed flat gradient of
    each group (``average`` divides the sum by the world), one flat AdamW
    kernel over the local fp32 master/moment shard, allgather the updated
    shards in the parameter dtype and write them into the params.

    ``params`` and ``grads`` are dicts of tensors keyed alike
    (``dict(model.named_parameters())``); the layout follows the params'
    order (and ``partition``, a release plan's buckets, if given).
    ``compression`` applies to the gradient on the wire.

    Stage 2: ``apply`` takes :class:`ShardedGrads` in place of ``grads``
    and skips its reduce-scatter. Stage 3: ``init`` and ``apply`` over
    :class:`ShardedParams`; ``apply`` returns new ``ShardedParams`` of the
    kernel's parameter shards and gathers nothing.

    A float32 group's parameter shard is its master shard itself
    (``flat_adamw_shard``): stage 1 and 2 allgather the master, and stage
    3's ``ShardedParams`` hold it, so the next ``apply`` updates them in
    place (``init`` copies the user's shards, which never alias it). Every
    reader of the master waits on its gather's handle, which orders the
    compute stream, where the next update runs, after the gather on the
    runtime's stream: ``_gather_into`` waits on all of them, and
    ``iter_param_buckets`` on every gather it dispatched, its prefetch
    window too, when it ends or is closed. A bfloat16 group's shard is a
    new tensor each step."""

    @torch.no_grad()
    def init(params) -> FlatAdamState:
        if isinstance(params, ShardedParams):
            spec = params.spec
            master = tuple(s.to(torch.float32, copy=True)
                           for s in params.shards)
        else:
            leaves = list(params.values())
            _check_dense(leaves)
            spec = _local_spec(leaves, partition)
            master = tuple(
                _shard_of(_pack_group(leaves, g), g, spec.rank)
                .to(torch.float32)
                for g in spec.groups)
        state = FlatAdamState(
            spec=spec, count=0, master=master,
            mu=tuple(torch.zeros_like(w) for w in master),
            nu=tuple(torch.zeros_like(w) for w in master))
        _note_optimizer_shards(state)
        return state

    @torch.no_grad()
    def apply(params, state: FlatAdamState, grads):
        spec = state.spec
        sharded_out = isinstance(params, ShardedParams)
        if sharded_out:
            _check_shard_spec(params.spec, spec,
                              "ShardedParams (stage-3 params)")
        if isinstance(grads, ShardedGrads):
            _check_shard_spec(grads.spec, spec,
                              "pre-scattered gradient (ShardedGrads)")
            gshards = list(grads.shards)
        else:
            if sharded_out:
                raise TypeError("stage-3 params take ShardedGrads "
                                "(scatter_gradients or a reduce-scatter "
                                "release plan)")
            _check_count(grads, spec)
            check_keys(params, grads)
            gleaves = [grads[k] for k in params]
            _check_dense(gleaves)
        _check_world(spec, "sharded state")
        count = min(state.count + 1, _INT32_MAX)
        scalars = adamw_scalars(count, b1, b2, learning_rate, weight_decay)
        if not isinstance(grads, ShardedGrads):
            # every group's reduce-scatter in flight before the first update
            gshards = _scatter(gleaves, spec, average, compression,
                               "sharded.adamw.grads")
        ps = []
        for g, w, m, v, shard in zip(spec.groups, state.master, state.mu,
                                     state.nu, gshards):
            p, _, _, _ = flat_adamw_shard(w, m, v, shard, scalars, eps=eps,
                                          out_dtype=group_dtype(g))
            ps.append(p)
        del gshards
        new_state = FlatAdamState(spec, count, state.master, state.mu,
                                  state.nu)
        if sharded_out:
            _note_shards("param_shards", ps)
            return ShardedParams(spec, params.names, ps), new_state
        _gather_into(ps, spec, list(params.values()),
                     "sharded.adamw.params")
        return params, new_state

    return ShardedAdamW(init=init, apply=apply)


# ---------------------------------------------------------------------------
# The checkpoint layer's view: layout, export, re-slice
# ---------------------------------------------------------------------------

def is_sharded_state(x) -> bool:
    """True for states that hold per-rank shards (optimizer states,
    stage-3 parameter shards, stage-2 gradient shards): a checkpoint
    stores each rank's own, and a restore re-slices them."""
    return isinstance(x, (ShardedOptState, FlatAdamState, ShardedParams,
                          ShardedGrads))


def _kind_of(state) -> str:
    if isinstance(state, FlatAdamState):
        return "flat_adamw"
    if isinstance(state, ShardedParams):
        return "sharded_params"
    if isinstance(state, ShardedGrads):
        return "sharded_grads"
    return "generic"


def _inner_shards(state: ShardedOptState) -> list:
    return list(state.inner.param_groups[0]["params"])


def _state_keys(state: ShardedOptState) -> list:
    """Per group, the names of the inner optimizer's state entries."""
    return [sorted(state.inner.state.get(s, {}))
            for s in _inner_shards(state)]


def layout_of(state) -> dict:
    """JSON-serializable shard layout of a sharded state, recorded in the
    checkpoint manifest so a restore can re-slice into another world size
    (:func:`from_full_buffers`). The generic kind adds ``state_keys``: the
    inner ``torch.optim`` state's entry names a group, which the JAX
    package's optax state carries in its tree instead."""
    spec = state.spec
    out = {
        "kind": _kind_of(state),
        "world": int(spec.world),
        "groups": [[g.dtype, int(g.n), int(g.shard_elems), int(g.padded)]
                   for g in spec.groups],
    }
    if isinstance(state, ShardedOptState):
        out["state_keys"] = _state_keys(state)
    return out


def _host(t, to_host: bool):
    if not isinstance(t, torch.Tensor):
        t = torch.tensor(t)
    return t.detach().to("cpu", copy=True) if to_host else t.detach()


def export_shard_arrays(state, to_host: bool = True) -> dict:
    """A sharded state's local arrays in a stable named layout: the unit
    the checkpoint writer stores and the neighbour-replica ring ships.
    ``to_host`` (default) copies each to the host; ``False`` gives the
    state's own tensors, which the writer copies into its pinned slabs.

    ``flat_adamw``: ``count`` (a 0-d int32, as the JAX package's) and
    ``master``/``mu``/``nu`` a group; ``sharded_params`` and
    ``sharded_grads``: ``leaves``, one shard a group; ``generic``:
    ``leaves``, per group its shard tensor and then the inner optimizer's
    state entries in :func:`layout_of`'s ``state_keys`` order."""
    if isinstance(state, FlatAdamState):
        return {"kind": "flat_adamw",
                "count": torch.tensor(int(state.count), dtype=torch.int32),
                "master": [_host(m, to_host) for m in state.master],
                "mu": [_host(m, to_host) for m in state.mu],
                "nu": [_host(m, to_host) for m in state.nu]}
    if isinstance(state, (ShardedParams, ShardedGrads)):
        return {"kind": _kind_of(state),
                "leaves": [_host(s, to_host) for s in state.shards]}
    leaves = []
    for shard, keys in zip(_inner_shards(state), _state_keys(state)):
        entries = state.inner.state.get(shard, {})
        leaves.append(_host(shard, to_host))
        leaves.extend(_host(entries[k], to_host) for k in keys)
    return {"kind": "generic", "leaves": leaves}


def _slice_new_shard(full_old: torch.Tensor, old_n: int, g_new: GroupSpec,
                     new_rank: int, dtype: torch.dtype,
                     device) -> torch.Tensor:
    """This rank's shard under ``g_new`` of the real elements of a full old
    flat buffer: the old pad dropped, the new pad zeros (the JAX package's
    ``_reshard``, without building the whole new flat buffer)."""
    if int(old_n) != g_new.n:
        raise ValueError(
            "checkpoint restore: parameter structure changed (a group "
            f"holds {old_n} elements in the checkpoint, {g_new.n} now)")
    real = torch.as_tensor(full_old).reshape(-1)[:g_new.n]
    lo = new_rank * g_new.shard_elems
    hi = lo + g_new.shard_elems
    out = torch.zeros(g_new.shard_elems, dtype=dtype)
    if lo < g_new.n:
        out[:min(hi, g_new.n) - lo] = real[lo:min(hi, g_new.n)]
    return out.to(device)


def _device_of(tensors):
    return next((t.device for t in tensors if isinstance(t, torch.Tensor)),
                torch.device("cpu"))


def from_full_buffers(target, full: dict, old_groups):
    """Rebuild a sharded state from FULL old flat buffers (one a group),
    slicing this rank's shard under ``target``'s layout: the restore of a
    checkpoint into any world size.

    ``target`` gives the new layout and the device (a state made afresh
    in the new world); ``full`` is :func:`export_shard_arrays`' dict with
    full ``(old_padded,)`` buffers (the generic kind also its
    ``state_keys``); ``old_groups`` is the manifest's ``groups``. Returns
    a new state; ``target`` is left as it was. The memory ledger takes the
    new state's shards in place of the old ones."""
    spec = target.spec
    if len(old_groups) != len(spec.groups):
        raise ValueError(
            "checkpoint restore: parameter structure changed (dtype "
            "group count mismatch between manifest and target)")
    old_n = [int(g[1]) for g in old_groups]
    if isinstance(target, FlatAdamState):
        dev = _device_of(target.master)
        comps = {c: tuple(_slice_new_shard(full[c][gi], old_n[gi], g,
                                           spec.rank, torch.float32, dev)
                          for gi, g in enumerate(spec.groups))
                 for c in ("master", "mu", "nu")}
        count = int(torch.as_tensor(full["count"]).reshape(-1)[0])
        state = FlatAdamState(spec=spec, count=count, **comps)
        _note_optimizer_shards(state)
        return state
    if isinstance(target, (ShardedParams, ShardedGrads)):
        dev = _device_of(target.shards)
        shards = tuple(_slice_new_shard(full["leaves"][gi], old_n[gi], g,
                                        spec.rank, group_dtype(g), dev)
                       for gi, g in enumerate(spec.groups))
        if isinstance(target, ShardedParams):
            _note_shards("param_shards", shards)
            return ShardedParams(spec, target.names, shards)
        _note_shards("grad_shards", shards)
        return ShardedGrads(spec, shards)
    keys = full.get("state_keys")
    if keys is None or len(keys) != len(spec.groups):
        raise ValueError("checkpoint restore of a generic sharded state "
                         "needs its layout's state_keys, one list a group")
    old = _inner_shards(target)
    dev = _device_of(old)
    stored = iter(full["leaves"])
    shards, state = [], {}
    for gi, g in enumerate(spec.groups):
        shards.append(_slice_new_shard(next(stored), old_n[gi], g, spec.rank,
                                       group_dtype(g), dev))
        state[gi] = {}
        for k in keys[gi]:
            v = torch.as_tensor(next(stored))
            state[gi][k] = v if v.ndim == 0 else _slice_new_shard(
                v, old_n[gi], g, spec.rank, v.dtype, dev)
    hyper = {k: v for k, v in target.inner.param_groups[0].items()
             if k != "params"}
    inner = type(target.inner)([{"params": shards, **hyper}])
    sd = inner.state_dict()
    inner.load_state_dict({"state": state,
                           "param_groups": sd["param_groups"]})
    state = ShardedOptState(spec=spec, inner=inner)
    _note_optimizer_shards(state)
    return state


# ---------------------------------------------------------------------------
# Elastic re-shard
# ---------------------------------------------------------------------------

def _gather_old_segments(local: torch.Tensor, old_rank: int, old_world: int,
                         old_shard: int, fill: torch.Tensor, name: str,
                         replica_rank: int = -1, replica_local=None):
    """Rebuild a full old flat buffer from the surviving shards
    (``horovod_tpu/parallel/zero.py:1736-1790``): allgather every current
    rank's (length, old rank, shard), place each surviving old rank's
    segment, and leave ``fill`` where the owner died; the first claim
    wins, so a fresh joiner never shadows a survivor. A second round
    offers the neighbour replicas (``ckpt.replica``): a survivor holding a
    dead rank's shard bytes restores that segment to its last commit's
    values. Every rank joins both rounds, one without a replica with a
    one-element stand-in tagged rank -1. Returns ``(full,
    replica_restored_old_ranks)``."""
    full = fill.clone()
    claimed: set = set()

    def place(seg_local, seg_rank, tag, restored):
        dev = seg_local.device
        lens = collectives.allgather(
            torch.tensor([seg_local.numel()], dtype=torch.int64, device=dev),
            name=f"{name}.{tag}.len").cpu()
        ranks = collectives.allgather(
            torch.tensor([seg_rank], dtype=torch.int64, device=dev),
            name=f"{name}.{tag}.rank").cpu()
        cat = collectives.allgather(seg_local.contiguous(),
                                    name=f"{name}.{tag}.cat")
        off = 0
        for ln, r in zip(lens.tolist(), ranks.tolist()):
            seg = cat[off:off + ln]
            off += ln
            if 0 <= r < old_world and ln == old_shard and r not in claimed:
                full[r * old_shard:(r + 1) * old_shard] = seg
                claimed.add(r)
                if restored is not None:
                    restored.add(r)

    place(local.reshape(-1), old_rank, "own", None)
    rep = (local.new_zeros(1) if replica_local is None
           else torch.as_tensor(replica_local).reshape(-1).to(
               device=local.device, dtype=local.dtype))
    from_replica: set = set()
    place(rep, replica_rank if replica_local is not None else -1, "replica",
          from_replica)
    return full, from_replica


def _resync_needed(spec: ZeroSpec, st) -> bool:
    """A decision every rank takes alike: a layout that no longer matches
    on any rank re-shards on all (a survivor that kept its rank still joins
    a renumbered peer's gathers)."""
    local = int(spec.world != st.size or spec.rank != st.rank)
    if st.size <= 1:
        return bool(local)
    total = collectives.allreduce(
        torch.tensor([local], dtype=torch.int32, device=st.device),
        op=collectives.Sum, name="zero.resync.needed")
    return int(total.reshape(-1)[0]) > 0


def _meta_leaves_from_spec(spec: ZeroSpec) -> list:
    """Shape and dtype stand-ins of every leaf of ``spec``: stage-2 and -3
    shards lay themselves out again with no full tree anywhere."""
    metas = [None] * spec.num_leaves
    for g in spec.groups:
        for i, shape in zip(g.indices, g.shapes):
            metas[i] = LeafMeta(shape=tuple(shape), dtype=group_dtype(g))
    return metas


def resync(state, params=None, root_rank: int = 0, replica=None):
    """Re-shard a sharded state after an elastic re-form (port of
    ``horovod_tpu/parallel/zero.py:1827-1850``): allgather the surviving
    old shards into full flat buffers, the dead ranks' segments taking the
    neutral fill (zeros for moments and gradient or parameter shards, the
    synced parameters for the f32 master and a generic state's shard)
    unless a neighbour replica offers their bytes, then slice the new
    world's shard with :func:`from_full_buffers`.

    ``replica``: ``(src_old_rank, exported_arrays)`` from
    ``ckpt.replica.lookup`` when this rank holds a neighbour's copy, else
    None (the rank still joins the replica round). ``params`` must be
    synced already (``ArrayState.sync`` does params first): a dict or list
    of full tensors, or :class:`ShardedParams` (stage 3, gathered for the
    fill); None for :class:`ShardedParams` and :class:`ShardedGrads`
    states, which carry their own layout. Covers all four kinds; a no-op
    when the layout still matches on every rank. Collective."""
    st = basics._ensure_init()
    spec = state.spec
    if not _resync_needed(spec, st):
        return state
    part = [list(g.indices) for g in spec.groups]
    if isinstance(state, (ShardedParams, ShardedGrads)):
        pleaves = _meta_leaves_from_spec(spec)
    elif isinstance(params, ShardedParams):
        gathered = gather_params(params)
        pleaves = (list(gathered.values()) if isinstance(gathered, dict)
                   else list(gathered))
    else:
        _, pleaves = _leaves_of(params)
    new_spec = build_spec(pleaves, st.size, st.rank, _quantum_bytes(),
                          partition=part)
    # the survivors share the old layout; the root's is authoritative
    old_world, old_groups, count = collectives.broadcast_object(
        (int(spec.world),
         [[g.dtype, int(g.n), int(g.shard_elems), int(g.padded)]
          for g in spec.groups],
         int(state.count) if isinstance(state, FlatAdamState) else 0),
        root_rank)
    if len(old_groups) != len(new_spec.groups):
        raise ValueError(
            "elastic resync: parameter structure changed across the "
            "re-form (dtype group count mismatch)")
    flight_recorder.emit("sharded_resync", old_world=int(old_world),
                         new_world=int(st.size), rank=int(st.rank))
    rep_rank, rep_entries = -1, None
    if replica is not None:
        rep_rank, rep_entries = replica
        if not isinstance(rep_entries, dict) \
                or rep_entries.get("kind") != _kind_of(state):
            rep_rank, rep_entries = -1, None
    restored: set = set()

    def rep(component, idx):
        try:
            return rep_entries[component][idx]
        except (KeyError, IndexError, TypeError):
            return None

    def regroup(local, gi, fill, rep_arr, tag):
        _, _, old_shard, _ = old_groups[gi]
        full, got = _gather_old_segments(
            local, spec.rank, old_world, old_shard, fill,
            f"zero.resync.{tag}",
            replica_rank=rep_rank if rep_arr is not None else -1,
            replica_local=rep_arr)
        restored.update((tag, r) for r in got)
        return full

    def zeros(gi, dtype, device):
        return torch.zeros(old_groups[gi][3], dtype=dtype, device=device)

    def param_fill(gi, dtype, device):
        _, old_n, old_shard, old_padded = old_groups[gi]
        g = new_spec.groups[gi]
        return _pack_group(pleaves, g._replace(
            n=old_n, shard_elems=old_shard, padded=old_padded)).to(
                device=device, dtype=dtype)

    if isinstance(state, (ShardedParams, ShardedGrads)):
        tag0 = "param" if isinstance(state, ShardedParams) else "grad"
        full = {"kind": _kind_of(state), "leaves": [
            regroup(s, gi, zeros(gi, s.dtype, s.device), rep("leaves", gi),
                    f"{tag0}.{gi}")
            for gi, s in enumerate(state.shards)]}
        target = (ShardedParams(new_spec, state.names, state.shards)
                  if isinstance(state, ShardedParams)
                  else ShardedGrads(new_spec, state.shards))
    elif isinstance(state, FlatAdamState):
        full = {"kind": "flat_adamw", "count": torch.tensor(count),
                "master": [], "mu": [], "nu": []}
        for gi, m in enumerate(state.master):
            full["master"].append(regroup(
                m, gi, param_fill(gi, m.dtype, m.device), rep("master", gi),
                f"master.{gi}"))
            for c in ("mu", "nu"):
                t = getattr(state, c)[gi]
                full[c].append(regroup(t, gi, zeros(gi, t.dtype, t.device),
                                       rep(c, gi), f"{c}.{gi}"))
        target = state._replace(spec=new_spec)
    else:
        keys = _state_keys(state)
        leaves = []
        li = 0
        for gi, (shard, gkeys) in enumerate(zip(_inner_shards(state), keys)):
            entries = state.inner.state.get(shard, {})
            leaves.append(regroup(
                shard, gi, param_fill(gi, shard.dtype, shard.device),
                rep("leaves", li), f"shard.{gi}"))
            li += 1
            for k in gkeys:
                v = entries[k]
                if v.ndim == 0:  # a step count: the root's
                    leaves.append(torch.as_tensor(collectives.broadcast_object(
                        v.item(), root_rank), dtype=v.dtype))
                else:
                    leaves.append(regroup(v, gi, zeros(gi, v.dtype, v.device),
                                          rep("leaves", li), f"{k}.{gi}"))
                li += 1
        full = {"kind": "generic", "leaves": leaves, "state_keys": keys}
        target = ShardedOptState(new_spec, state.inner)
    new_state = from_full_buffers(target, full, old_groups)
    if isinstance(state, ShardedOptState) and isinstance(params, ShardedParams):
        # the inner optimizer steps the stage-3 shards themselves
        inner = new_state.inner
        old = inner.param_groups[0]["params"]
        for new, p in zip(params.shards, old):
            inner.state[new] = inner.state.pop(p, {})
        inner.param_groups[0]["params"] = list(params.shards)
    if restored:
        from horovod_tpu_torch.ckpt import stats as ckpt_stats

        ckpt_stats.REPLICA_RESTORES.inc(len(restored))
        flight_recorder.emit(
            "sharded_resync_replica",
            restored_old_ranks=sorted({r for _t, r in restored}),
            segments=len(restored), rank=int(st.rank))
    return new_state
