"""Tensor fusion: bin-packing responses under the fusion threshold (port of
``fuse_responses_py``, ``fuse_responses_native`` and ``fuse_responses`` in
``horovod_tpu/runtime/fusion.py``; reference:
horovod/common/controller.cc:551-672, docs/tensor-fusion.rst:9-17).

This module owns the batching decision: which allreduce responses fuse
into one collective, bounded by ``HOROVOD_FUSION_THRESHOLD`` bytes, with
look-ahead past dtype or op mismatches. The buffer they are packed into is
``fusion_buffer.py``'s. Two engines give the same bins: the C++ one
(``cpp/cycle.cc`` ``hvc_fuse``) and the Python one; :func:`fuse_responses`
picks by ``HOROVOD_NATIVE_CYCLE`` (default on, the C++ one) and records the
fusion metrics.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, Optional

import torch

from horovod_tpu_torch.metrics import RATIO_BUCKETS, registry as _metrics
from horovod_tpu_torch.runtime import message as msg
from horovod_tpu_torch.runtime import native
from horovod_tpu_torch.runtime import types
from horovod_tpu_torch.utils import env

_FUSED_BATCHES = _metrics().counter(
    "horovod_fusion_batches_total",
    "Fused allreduce responses carrying more than one tensor.")
_FUSED_TENSORS = _metrics().counter(
    "horovod_fusion_tensors_total",
    "Tensors that left fusion inside a multi-tensor batch.")
_FUSED_BYTES = _metrics().counter(
    "horovod_fusion_bytes_total",
    "Payload bytes across all allreduce responses after bin-packing.")
_BUFFER_UTILIZATION = _metrics().histogram(
    "horovod_fusion_buffer_utilization_ratio",
    "Per-bin fill ratio: fused bytes / HOROVOD_FUSION_THRESHOLD.",
    buckets=RATIO_BUCKETS)


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


def _join_keys(responses: List[msg.Response],
               request_by_name: Dict[str, msg.Request]) -> tuple:
    """Each response's join key and bytes (reference: controller.cc:560-585):
    only allreduces fuse, and only with the same dtype and reduction (the
    reference never fuses broadcasts; gathers and scatters run one call an
    entry); others get key None and 0 bytes."""
    keys, sizes = [], []
    for r in responses:
        if r.response_type == types.ALLREDUCE:
            req = request_by_name[r.tensor_names[0]]
            keys.append((req.dtype, req.reduce_op))
            sizes.append(response_bytes(r, request_by_name))
        else:
            keys.append(None)
            sizes.append(0)
    return keys, sizes


def _bins_py(keys: list, sizes: list, threshold_bytes: int) -> List[list]:
    """Greedy bin-packing with look-ahead over the indices of the
    responses. A bin's scan stops once not even the smallest response of
    its key would fit, after which the JAX package's walk would only skip:
    O(n) at threshold 0 where that walk is O(n^2)."""
    smallest: Dict[tuple, int] = {}
    for key, n in zip(keys, sizes):
        if key is not None:
            smallest[key] = min(smallest.get(key, n), n)
    remaining = collections.deque(range(len(keys)))
    bins: List[list] = []
    while remaining:
        head = remaining.popleft()
        key = keys[head]
        if key is None:
            bins.append([head])
            continue
        members, acc_bytes = [head], sizes[head]
        skipped: "collections.deque" = collections.deque()
        while remaining and acc_bytes + smallest[key] <= threshold_bytes:
            cand = remaining.popleft()
            if keys[cand] == key \
                    and acc_bytes + sizes[cand] <= threshold_bytes:
                members.append(cand)
                acc_bytes += sizes[cand]
            else:
                skipped.append(cand)
        remaining.extendleft(reversed(skipped))
        bins.append(members)
    return bins


def _bins_native(keys: list, sizes: list, threshold_bytes: int
                 ) -> List[list]:
    """The same bins from the C++ engine (``hvc_fuse``): the join keys go
    in as small integers, the bins come back as ``[count, idx...]`` runs."""
    lib = native.load()
    n = len(keys)
    ids: Dict[tuple, int] = {}
    is_ar = (ctypes.c_uint8 * n)(*(k is not None for k in keys))
    key_id = (ctypes.c_int64 * n)(
        *(-1 if k is None else ids.setdefault(k, len(ids)) for k in keys))
    nbytes = (ctypes.c_int64 * n)(*sizes)
    cap = 2 * n
    out = (ctypes.c_int32 * cap)()
    w = lib.hvc_fuse(n, is_ar, key_id, nbytes, threshold_bytes, out, cap)
    if w < 0:
        raise RuntimeError(f"hvc_fuse needed more than {cap} slots")
    flat, bins, pos = out[:w], [], 0
    while pos < w:
        count = flat[pos]
        bins.append(flat[pos + 1:pos + 1 + count])
        pos += 1 + count
    return bins


def _assemble(responses: List[msg.Response], bins: List[list]
              ) -> List[msg.Response]:
    fused = []
    for members in bins:
        head = responses[members[0]]
        if head.response_type != types.ALLREDUCE:
            fused.append(head)
            continue
        names = list(head.tensor_names)
        for i in members[1:]:
            names.extend(responses[i].tensor_names)
        fused.append(msg.Response(types.ALLREDUCE, names))
    return fused


def fuse_responses_py(responses: List[msg.Response],
                      request_by_name: Dict[str, msg.Request],
                      threshold_bytes: int) -> List[msg.Response]:
    """Greedy bin-packing with look-ahead (reference: controller.cc:551-672).

    Walk the responses; add each joinable one to the current bin while the
    byte total stays at or under ``threshold_bytes``. A response that cannot
    join is skipped over (not a reason to close the bin), so a stray f32
    tensor between bf16 gradients does not break the bf16 bin; the skipped
    ones then form the later bins. At threshold 0 every bin holds one
    tensor. The bins are the JAX package's."""
    keys, sizes = _join_keys(responses, request_by_name)
    return _assemble(responses, _bins_py(keys, sizes, threshold_bytes))


def fuse_responses_native(responses: List[msg.Response],
                          request_by_name: Dict[str, msg.Request],
                          threshold_bytes: int) -> List[msg.Response]:
    """:func:`fuse_responses_py`'s bins from the C++ engine. Raises
    :class:`native.NativeBuildError` when the library cannot be built or
    loaded (the JAX package's returns None and falls back)."""
    if not responses:
        return []
    keys, sizes = _join_keys(responses, request_by_name)
    return _assemble(responses, _bins_native(keys, sizes, threshold_bytes))


def fuse_responses(responses: List[msg.Response],
                   request_by_name: Dict[str, msg.Request],
                   threshold_bytes: int,
                   native_engine: Optional[bool] = None
                   ) -> List[msg.Response]:
    """The bins of the engine ``native_engine`` names (default:
    ``HOROVOD_NATIVE_CYCLE``), with the fusion metrics recorded."""
    if not responses:
        return []
    if native_engine is None:
        native_engine = env.native_cycle()
    keys, sizes = _join_keys(responses, request_by_name)
    bins = (_bins_native if native_engine else _bins_py)(
        keys, sizes, threshold_bytes)
    fused = _assemble(responses, bins)
    for members, resp in zip(bins, fused):
        if keys[members[0]] is None:
            continue
        nbytes = sum(sizes[i] for i in members)
        _FUSED_BYTES.inc(nbytes)
        if threshold_bytes > 0:
            _BUFFER_UTILIZATION.observe(nbytes / threshold_bytes)
        if len(resp.tensor_names) > 1:
            _FUSED_BATCHES.inc()
            _FUSED_TENSORS.inc(len(resp.tensor_names))
    return fused
