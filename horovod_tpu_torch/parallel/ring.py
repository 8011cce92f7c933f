"""Ring attention: exact attention over a sequence sharded on the ranks of
a process group (port of ``horovod_tpu/parallel/ring.py:70-167``).

Each rank holds one query/key/value shard of the sequence. Key/value
shards travel around the ring (send to the rank before, receive from the
rank after, ``dist.batch_isend_irecv`` on the axis group) while each rank
runs the flash forward kernel on its queries against the shard it holds,
with the global positions ``q_offset = rank * S_local`` and ``k_offset =
src * S_local``, and merges the partials exactly in float32
(``merge_partials``). The full ``(seq, seq)`` scores never exist; a rank
holds O(seq/N * d) of keys and values at a time.

The backward is a second sweep with the final log-sum-exp and one
``compute_delta``: with the final normaliser each (query shard, key shard)
pair's gradient is independent, so each pair runs the backward kernels
under the one rule of every flash backward (``flash_backward``: the fused
kernel under ``FLASH_FUSED_BWD`` and extents within ``FUSED_MAX_SEQ``,
else dq and dk/dv), and float32 dk/dv accumulators travel with their
chunks, home after n rotations.

Overlap: a rotation is issued before the step's kernel and waited after
it. On NCCL the transfer runs on the process group's own stream while the
kernel runs on the caller's, and the wait orders the caller's stream after
the transfer without blocking the host; on gloo it runs on gloo's threads.
In the backward the keys and values of the next step rotate under this
step's kernels, and the accumulators, which this step's kernels fill,
under the next step's. No rotation follows the forward's last step.

Causal masking follows global positions. A key shard wholly in a query
shard's future goes through the kernel like any other: the kernel skips
its blocks, and its fully masked rows come back with ``lse = -inf``, to
which the merge gives weight 0.

The collectives run on the axis group from the caller's thread, never on
the runtime's data group. The forward and the backward first check that
the runtime holds no named collective in flight
(``ops/collectives.assert_collective_lane_clear``): on NCCL the two
groups' kernels could reach the card in another order on each rank and
deadlock, so a step's gradients are exchanged after its backward
(``allreduce_gradients``), not by ``DistributedOptimizer``'s hooks during
it.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.flash_attention import (
    NEG_INF,
    compute_delta,
    flash_attention_partial,
    flash_backward,
    merge_partials,
)
from horovod_tpu_torch.parallel._util import (
    axis_group,
    group_peer,
    group_rank_size,
)


class _Rotation:
    """One ring step's transfer in flight: ``tensors`` sent to the rank
    before, as many received from the rank after; :meth:`wait` returns the
    received ones."""

    def __init__(self, tensors: List[torch.Tensor], group, tag: int = 0):
        me, n = group_rank_size(group)
        self.received = [torch.empty_like(t) for t in tensors]
        ops = []
        for i, (t, r) in enumerate(zip(tensors, self.received)):
            ops.append(dist.P2POp(dist.isend, t, group_peer(group, me - 1),
                                  group, tag + i))
            ops.append(dist.P2POp(dist.irecv, r, group_peer(group, me + 1),
                                  group, tag + i))
        self.works = dist.batch_isend_irecv(ops)

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        return self.received


def forward_step(q, k, v, o, lse, *, causal, sm_scale, q_offset, k_offset):
    """One ring step's forward: the flash partial of ``q`` against the key
    shard held now (kernel B1 on the card), merged into the float32
    running ``(o, lse)``."""
    o_p, lse_p = flash_attention_partial(
        q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
        k_offset=k_offset)
    return merge_partials(o, lse, o_p, lse_p)


def backward_step(q, k, v, do, lse, delta, dq, acc, *, causal, sm_scale,
                  q_offset, k_offset) -> List[torch.Tensor]:
    """One ring step's backward: the (query shard, key shard) pair's
    gradients under the final ``lse`` (``flash_backward``'s kernels), added
    into the float32 ``dq`` and the travelling float32 ``[dk, dv]``. ``acc``
    is that pair, or the :class:`_Rotation` bringing it, waited for once
    the kernels are issued. Returns the pair."""
    dq_p, dk_p, dv_p = flash_backward(
        q, k, v, do, lse, delta, causal=causal, sm_scale=sm_scale,
        q_offset=q_offset, k_offset=k_offset)
    dq += dq_p.float()
    if isinstance(acc, _Rotation):
        acc = acc.wait()
    acc[0] += dk_p.float()
    acc[1] += dv_p.float()
    return acc


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        collectives.assert_collective_lane_clear()
        me, n = group_rank_size(group)
        s_local = k.shape[2]
        q_off = me * q.shape[2]
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32,
                         device=q.device)
        k_cur, v_cur = k, v
        for s in range(n):
            ahead = _Rotation([k_cur, v_cur], group) if s < n - 1 else None
            o, lse = forward_step(q, k_cur, v_cur, o, lse, causal=causal,
                                  sm_scale=sm_scale, q_offset=q_off,
                                  k_offset=((me + s) % n) * s_local)
            if ahead is not None:
                k_cur, v_cur = ahead.wait()
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        collectives.assert_collective_lane_clear()
        q, k, v, o, lse = ctx.saved_tensors
        group = ctx.group
        me, n = group_rank_size(group)
        s_local = k.shape[2]
        q_off = me * q.shape[2]
        do = do.contiguous()
        # delta depends only on (o, do): once, not once a ring step
        delta = compute_delta(o, do)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        k_cur, v_cur = k, v
        homeward = None  # the accumulators' rotation of the step before
        for s in range(n):
            ahead = _Rotation([k_cur, v_cur], group) if s < n - 1 else None
            acc = backward_step(
                q, k_cur, v_cur, do, lse, delta, dq, homeward or acc,
                causal=ctx.causal, sm_scale=ctx.sm_scale, q_offset=q_off,
                k_offset=((me + s) % n) * s_local)
            # the accumulators follow their chunk; after n rotations each
            # is back on its owner (none travels in a one-rank ring)
            homeward = _Rotation(acc, group, tag=2) if n > 1 else None
            if ahead is not None:
                k_cur, v_cur = ahead.wait()
        if homeward is not None:
            acc = homeward.wait()
        return (dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis=None, causal: bool = False,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact flash attention over a sequence sharded on ``axis``'s ranks.

    ``q``/``k``/``v`` are this rank's shards, ``(batch, heads, seq_local,
    head_dim)``, shard ``i`` on the axis' rank ``i``; returns this rank's
    output shard, differentiable in all three. ``axis`` is a process group,
    ``"local"``, ``"cross"``, ``"world"`` or ``None`` (the world; see
    ``parallel/_util.axis_group``), so ``ring_attention`` itself serves as
    a model's ``attention_fn``. ``sm_scale`` defaults to
    ``1/sqrt(head_dim)``. On CUDA tensors every step launches the flash
    kernels, or raises."""
    if q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"ring attention takes equal q, k, v shards, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None \
        else float(sm_scale)
    return _RingAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), axis_group(axis),
                                bool(causal), scale)
