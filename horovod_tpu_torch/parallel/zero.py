"""ZeRO-1: AdamW with its fp32 master weights and moments sharded 1/N.

Port of the stage-1 subset of ``horovod_tpu/parallel/zero.py``. The
gradient allreduce is decomposed as

    reduce-scatter  ->  update on the local shard  ->  allgather

so each rank holds and updates only 1/N of the optimizer state, with the
same bytes on the wire as an allreduce. The parameters are flattened into
one flat buffer per dtype group, laid out exactly as the JAX package lays
it out (:func:`build_spec`): each per-rank shard is padded to a size bucket
of ``HOROVOD_FUSION_BUCKET_QUANTUM`` (``runtime/fusion_buffer.py``), and the
pad holds zeros, the identity of sum and average, so the padded result
bit-matches the unpadded one. The update is one launch of the flat AdamW
kernel per group (:mod:`horovod_tpu_torch.ops.fused_optimizer`).

One process per rank, as the reference Horovod runs (the JAX package's
"local" mode, ``zero.py:1491-1559``): the collectives are those of
:mod:`horovod_tpu_torch.ops.collectives` on ``torch.distributed``, issued
at every world size. ``apply`` takes and returns dicts keyed like
``named_parameters()`` and writes the gathered values into the given
parameter tensors in place: the port's departure from the JAX package's
pure function, which saves a copy of the model.

Not ported yet (ROADMAP A6): stages 2 and 3 (``ShardedGrads``,
``ShardedParams``, the prefetching gathers), ``sharded_update``,
``resync`` / ``from_full_buffers``, a ``partition`` of the layout, and the
metrics and flight-recorder hooks.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.fused_adamw import adamw_scalars, check_keys
from horovod_tpu_torch.ops.fused_optimizer import flat_adamw_shard
from horovod_tpu_torch.runtime.fusion_buffer import bucket_elems
from horovod_tpu_torch.utils import env

_INT32_MAX = 2**31 - 1


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


def build_spec(leaves, world: int, rank: int, quantum_bytes: int) -> ZeroSpec:
    """Group ``leaves`` (tensors or :class:`LeafMeta`) by dtype, sorted by
    dtype name, and lay each group out as one flat buffer whose per-rank
    shard is a size bucket (identity at or under ``quantum_bytes``, next
    power-of-two multiple above), so the padded total splits evenly into
    ``world`` shards (reference: zero.py:237-276)."""
    by_dtype: Dict[str, list] = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(dtype_name(leaf.dtype), []).append(i)
    groups = []
    for dts in sorted(by_dtype):
        idxs = by_dtype[dts]
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


def _pack_group(leaves, g: GroupSpec) -> torch.Tensor:
    """Flatten the group's leaves into one (padded,) vector; the pad holds
    zeros, the sum/average reduction identity."""
    parts = [leaves[i].reshape(-1) for i in g.indices]
    pad = g.padded - g.n
    if pad:
        parts.append(parts[0].new_zeros(pad))
    return torch.cat(parts)


def _unpack_group(flat: torch.Tensor, g: GroupSpec, out: list) -> None:
    """Write the group's slices of ``flat`` into the tensors ``out[i]``."""
    off = 0
    for i, shape, size in zip(g.indices, g.shapes, g.sizes):
        out[i].copy_(flat[off:off + size].view(shape))
        off += size


def _check_dense(leaves) -> None:
    for leaf in leaves:
        if leaf.is_sparse:
            raise ValueError(
                "shard_optimizer_states does not support sparse gradient "
                "leaves; densify them before the flat pack or keep the "
                "replicated path for sparse models")


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


def sharded_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8, weight_decay: float = 1e-4, *,
                  average: bool = True,
                  compression=Compression.none) -> ShardedAdamW:
    """ZeRO-1 fused AdamW: reduce-scatter the packed flat gradient of each
    dtype group (``average`` divides the sum by the world), one flat AdamW
    kernel over the local fp32 master/moment shard, allgather the updated
    shards in the parameter dtype and write them into the params.

    ``params`` and ``grads`` are dicts of tensors keyed alike
    (``dict(model.named_parameters())``); the layout follows the params'
    order. ``compression`` applies to the gradient on the wire."""

    @torch.no_grad()
    def init(params: Dict[str, torch.Tensor]) -> FlatAdamState:
        leaves = list(params.values())
        _check_dense(leaves)
        world, rank = basics.size(), basics.rank()
        spec = build_spec(leaves, world, rank, _quantum_bytes())
        master = tuple(
            _pack_group(leaves, g)[rank * g.shard_elems:
                                   (rank + 1) * g.shard_elems]
            .to(torch.float32, copy=True)
            for g in spec.groups)
        return FlatAdamState(
            spec=spec, count=0, master=master,
            mu=tuple(torch.zeros_like(w) for w in master),
            nu=tuple(torch.zeros_like(w) for w in master))

    @torch.no_grad()
    def apply(params, state: FlatAdamState, grads):
        spec = state.spec
        if len(grads) != spec.num_leaves:
            raise ValueError(
                f"gradient tree has {len(grads)} leaves but the sharded "
                f"state was built for {spec.num_leaves}")
        check_keys(params, grads)
        keys = list(params)
        gleaves = [grads[k] for k in keys]
        _check_dense(gleaves)
        if spec.world != basics.size():
            raise ValueError(
                f"sharded state was built for world {spec.world} but the "
                f"current world is {basics.size()}")
        count = min(state.count + 1, _INT32_MAX)
        scalars = adamw_scalars(count, b1, b2, learning_rate, weight_decay)
        op = collectives.Average if average else collectives.Sum
        # every group's reduce-scatter in flight before the first update
        pending = []
        for g in spec.groups:
            wire, ctx = compression.compress(_pack_group(gleaves, g))
            pending.append((ctx, collectives.reducescatter_async(wire, op=op)))
        gathers = []
        for g, w, m, v, (ctx, handle) in zip(spec.groups, state.master,
                                             state.mu, state.nu, pending):
            dtype = group_dtype(g)
            shard = compression.decompress(collectives.synchronize(handle),
                                           ctx).to(dtype)
            p, _, _, _ = flat_adamw_shard(w, m, v, shard, scalars, eps=eps,
                                          out_dtype=dtype)
            gathers.append(collectives.allgather_equal_async(p))
        del pending
        out = [params[k] for k in keys]
        for g, handle in zip(spec.groups, gathers):
            _unpack_group(collectives.synchronize(handle), g, out)
        return params, FlatAdamState(spec, count, state.master, state.mu,
                                     state.nu)

    return ShardedAdamW(init=init, apply=apply)
