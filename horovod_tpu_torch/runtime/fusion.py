"""Tensor fusion: bin-packing responses under the fusion threshold (port of
``fuse_responses_py`` in ``horovod_tpu/runtime/fusion.py``; reference:
horovod/common/controller.cc:551-672, docs/tensor-fusion.rst:9-17).

This module owns the batching decision: which allreduce responses fuse
into one collective, bounded by ``HOROVOD_FUSION_THRESHOLD`` bytes, with
look-ahead past dtype or op mismatches. The buffer they are packed into is
``fusion_buffer.py``'s. The JAX package's native bin-packer (``cpp/
cycle.cc``) and its fusion metrics are not ported yet (ROADMAP A3, A11).
"""

from __future__ import annotations

import collections
from typing import Dict, List

import torch

from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime import types


def _dtype_size(dtype: str) -> int:
    """Bytes per element of a wire dtype name ("float32", "bfloat16", ...)."""
    return getattr(torch, dtype).itemsize


def response_bytes(response: msg.Response,
                   request_by_name: Dict[str, msg.Request]) -> int:
    total = 0
    for name in response.tensor_names:
        req = request_by_name[name]
        n = 1
        for d in req.shape:
            n *= int(d)
        total += n * _dtype_size(req.dtype)
    return total


def fuse_responses_py(responses: List[msg.Response],
                      request_by_name: Dict[str, msg.Request],
                      threshold_bytes: int) -> List[msg.Response]:
    """Greedy bin-packing with look-ahead (reference: controller.cc:551-672).

    Walk the responses; add each joinable one to the current bin while the
    byte total stays at or under ``threshold_bytes``. A response that cannot
    join is skipped over (not a reason to close the bin), so a stray f32
    tensor between bf16 gradients does not break the bf16 bin; the skipped
    ones then form the later bins. At threshold 0 every bin holds one
    tensor.

    The bins are the JAX package's. Its walk scans every remaining response
    for each bin, O(n^2) at threshold 0; here each response's bytes and
    join key are computed once, and a bin's scan stops once not even the
    smallest response of its key would fit, after which the JAX walk would
    only skip."""
    # the join key (reference: controller.cc:560-585): only allreduces
    # fuse, and only with the same dtype and reduction (the reference never
    # fuses broadcasts; gathers and scatters run one call an entry)
    keys, sizes = [], []
    for r in responses:
        if r.response_type == types.ALLREDUCE:
            req = request_by_name[r.tensor_names[0]]
            keys.append((req.dtype, req.reduce_op))
            sizes.append(response_bytes(r, request_by_name))
        else:
            keys.append(None)
            sizes.append(0)
    smallest: Dict[tuple, int] = {}
    for key, n in zip(keys, sizes):
        if key is not None:
            smallest[key] = min(smallest.get(key, n), n)
    remaining = collections.deque(range(len(responses)))
    fused: List[msg.Response] = []
    while remaining:
        head = remaining.popleft()
        key = keys[head]
        if key is None:
            fused.append(responses[head])
            continue
        acc_names = list(responses[head].tensor_names)
        acc_bytes = sizes[head]
        skipped: "collections.deque" = collections.deque()
        while remaining and acc_bytes + smallest[key] <= threshold_bytes:
            cand = remaining.popleft()
            if keys[cand] == key \
                    and acc_bytes + sizes[cand] <= threshold_bytes:
                acc_names.extend(responses[cand].tensor_names)
                acc_bytes += sizes[cand]
            else:
                skipped.append(cand)
        remaining.extendleft(reversed(skipped))
        fused.append(msg.Response(types.ALLREDUCE, acc_names))
    return fused
