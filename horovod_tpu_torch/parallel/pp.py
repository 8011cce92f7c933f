"""Pipeline parallelism: the GPipe microbatch schedule over the ranks of a
process group (port of ``horovod_tpu/parallel/pp.py:37-100``).

One stage a rank, in the axis' rank order. The schedule is GPipe's
fill-drain: ``n_micro + n_stages - 1`` ticks; stage 0 feeds microbatch
``t`` at tick ``t``, stage ``i`` works on microbatch ``t - i``, and the last
stage emits microbatch ``t - (n_stages - 1)``. Between two ticks each stage
hands its output to the next (``dist.batch_isend_irecv`` on the axis group,
send and receive in one batch). The hand-off is an autograd function whose
backward is the reverse hand-off, which is what the JAX package gets from
``ppermute``'s transpose: ``loss.backward()`` runs the reversed schedule.

Where the JAX scan runs every stage at every tick and discards the
bubble's results, a stage here computes only at the ticks where it holds a
microbatch, and only those hand-offs happen. A stage that sends and
receives nothing more returns a zero-length marker from its last send,
joined to its outputs, so that its backward still receives the next
stage's gradient. Every rank must therefore backpropagate through what
:func:`pipeline_apply` returned (``last_stage_value`` of a loss of it, as
below), or its peers wait for a gradient that never comes.

The hand-offs, their backward and ``last_stage_value`` first check that
the runtime holds no named collective in flight
(``ops/collectives.assert_collective_lane_clear``; exchange a step's
gradients after its backward).

The stage function keeps its input's shape and dtype ``(stage_params, x)
-> y`` (true of transformer blocks); the hand-off buffers take the
microbatch's. Embedding and head layers run outside the pipelined trunk.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel._util import (
    axis_group,
    group_peer,
    group_rank_size,
)


class _Handoff(torch.autograd.Function):
    """Send ``payload`` to the next stage and/or receive the previous
    stage's output into a buffer of ``like``'s shape and dtype. Returns the
    received tensor, or a zero-length marker when nothing is received. Its
    backward sends the received tensor's gradient back and receives the
    payload's."""

    @staticmethod
    def forward(ctx, anchor, payload, group, receive: bool, like):
        me, _ = group_rank_size(group)
        ctx.group, ctx.me = group, me
        ctx.sent, ctx.received = payload is not None, receive
        ctx.shape = like.shape
        buf = torch.empty_like(like) if receive else None
        ops = []
        if payload is not None:
            ops.append(dist.P2POp(dist.isend, payload.contiguous(),
                                  group_peer(group, me + 1), group))
        if receive:
            ops.append(dist.P2POp(dist.irecv, buf, group_peer(group, me - 1),
                                  group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return buf if receive else anchor.new_zeros(0)

    @staticmethod
    def backward(ctx, grad):
        collectives.assert_collective_lane_clear()
        group, me = ctx.group, ctx.me
        ops, got = [], None
        if ctx.received:
            ops.append(dist.P2POp(dist.isend, grad.contiguous(),
                                  group_peer(group, me - 1), group))
        if ctx.sent:
            got = grad.new_empty(ctx.shape)
            ops.append(dist.P2POp(dist.irecv, got, group_peer(group, me + 1),
                                  group))
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return None, got, None, None, None


class _Join(torch.autograd.Function):
    """``outputs`` unchanged, with the send-only markers as inputs, so that
    the backward of ``outputs`` reaches their hand-offs."""

    @staticmethod
    def forward(ctx, outputs, *markers):
        ctx.n = len(markers)
        return outputs.view_as(outputs)

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + tuple(grad.new_zeros(0) for _ in range(ctx.n))


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor,
                   axis=None) -> torch.Tensor:
    """Run the GPipe schedule with this rank as stage ``rank in axis``.

    ``stage_params``: this rank's stage (any object ``stage_fn`` takes);
    ``x``: ``(n_micro, microbatch, ...)``, the same on every rank (only
    stage 0 reads it). ``axis`` is one process group or axis name
    (``parallel/_util.axis_group``; ``None``: the world). Returns
    ``(n_micro, microbatch, ...)`` outputs, valid on the LAST stage and
    zeros elsewhere: combine with :func:`last_stage_value`, or compute the
    loss on every rank and select."""
    if isinstance(axis, (tuple, list)):
        raise ValueError(
            "pipeline_apply takes ONE axis (the hand-offs are a line over "
            f"one group); got {axis!r}")
    collectives.assert_collective_lane_clear()
    group = axis_group(axis)
    me, n = group_rank_size(group)
    n_micro = x.shape[0]
    first, last = me == 0, me == n - 1
    like = x[0]
    anchor = x.new_zeros((), requires_grad=torch.is_grad_enabled())
    if n > 1:
        # NCCL forms a group's communicator at its first call, with every
        # member; the first hand-offs involve two stages only
        dist.all_reduce(x.new_zeros(1), group=group)
    outs, markers, state = [], [], None
    for t in range(n_micro + n - 1):
        mb = t - me  # the microbatch this stage holds at tick t
        out = None
        if 0 <= mb < n_micro:
            out = stage_fn(stage_params, x[mb] if first else state)
            if out.shape != like.shape or out.dtype != like.dtype:
                raise ValueError(
                    f"stage_fn must keep the microbatch's shape and dtype "
                    f"{tuple(like.shape)} {like.dtype}; got "
                    f"{tuple(out.shape)} {out.dtype}")
            if last:
                outs.append(out)
        send = None if last else out
        receive = not first and 0 <= mb + 1 < n_micro
        if send is None and not receive:
            continue
        got = _Handoff.apply(anchor, send, group, receive, like)
        if receive:
            state = got
        else:
            markers.append(got)
    if last:
        outputs = torch.stack(outs)
    else:
        outputs = x.new_zeros((n_micro,) + tuple(like.shape))
    return _Join.apply(outputs, *markers) if markers else outputs


class _FromLast(torch.autograd.Function):
    """Broadcast from the group's last rank; the gradient stays on it."""

    @staticmethod
    def forward(ctx, value, group):
        collectives.assert_collective_lane_clear()
        me, n = group_rank_size(group)
        ctx.root = me == n - 1
        out = value.detach().clone().contiguous()
        dist.broadcast(out, group_peer(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.root else torch.zeros_like(grad)), None


def last_stage_value(value: torch.Tensor, axis=None) -> torch.Tensor:
    """The last stage's ``value`` on every rank of ``axis``: a broadcast
    with the last stage as root, differentiable (the JAX package's masked
    ``psum``, ``pp.py:91-100``). Every rank holds the same result, so each
    backpropagates the same cotangent: the root takes its own, the others'
    stay with them (zero), and no gradient is summed over the ranks."""
    return _FromLast.apply(value, axis_group(axis))

