"""Ulysses sequence parallelism: attention over a sequence sharded on the
ranks of a process group, by an all-to-all head/sequence exchange (port of
``horovod_tpu/parallel/ulysses.py:30-66``).

The sequence is sharded on the axis everywhere but in attention. There, a
tiled all-to-all turns ``(batch, heads, seq/N, dim)`` into ``(batch,
heads/N, seq, dim)``, each rank runs full-sequence flash attention on its
heads, and a second all-to-all turns the output back. Each exchange is one
``dist.all_to_all_single`` on the axis group from the caller's thread (not
the runtime's data group, and with none of the runtime's collectives in
flight: ``ops/collectives.assert_collective_lane_clear``), and its
backward is the inverse exchange of the gradient. Two all-to-alls a call
(O(activations/N) bytes) against ring attention's N steps: cheaper when
the heads divide among the ranks.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel._util import axis_group, group_rank_size


def _exchange(x: torch.Tensor, group, to_seq: bool) -> torch.Tensor:
    """``to_seq``: (b, h, s/N, d) -> (b, h/N, s, d), the head chunk i to
    rank i, the sequence chunks concatenated in rank order; else the
    inverse."""
    collectives.assert_collective_lane_clear()
    n = group_rank_size(group)[1]
    if to_seq:
        b, h, sl, d = x.shape
        chunks = x.reshape(b, n, h // n, sl, d).transpose(0, 1)
    else:
        b, hl, s, d = x.shape
        chunks = x.reshape(b, hl, n, s // n, d).permute(2, 0, 1, 3, 4)
    chunks = chunks.contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    if to_seq:  # (N = sequence chunk, b, h/N, s/N, d)
        return out.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * sl, d)
    # (N = head chunk, b, h/N, s/N, d)
    return out.transpose(0, 1).reshape(b, n * hl, s // n, d)


class _Exchange(torch.autograd.Function):
    """The tiled all-to-all; its backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, group, to_seq):
        ctx.group, ctx.to_seq = group, to_seq
        return _exchange(x, group, to_seq)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, not ctx.to_seq), None, None


def _axis_label(axis) -> str:
    return axis if isinstance(axis, str) else "world" if axis is None \
        else "group"


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis=None, *, causal: bool = False,
                      sm_scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis``'s ranks via
    all-to-all.

    ``q``/``k``/``v`` are this rank's sequence shards, ``(batch, heads,
    seq/N, dim)`` with ``heads`` divisible by the axis' size N; returns
    this rank's output shard, shaped like ``q``. ``axis`` as in
    ``ring_attention`` (``None``: the world). ``attn_fn(q, k, v,
    causal=..., sm_scale=...)`` defaults to ``flash_attention``; it sees
    full-sequence inputs with ``heads/N`` heads."""
    group = axis_group(axis)
    n = group_rank_size(group)[1]
    heads = q.shape[1]
    if heads % n:
        raise ValueError(
            f"ulysses_attention needs heads ({heads}) divisible by the "
            f"'{_axis_label(axis)}' axis size ({n}); use ring attention "
            "otherwise")
    qs, ks, vs = (_Exchange.apply(t, group, True) for t in (q, k, v))
    attn = attn_fn or flash_attention
    o = attn(qs, ks, vs, causal=causal, sm_scale=sm_scale)
    return _Exchange.apply(o, group, False)
