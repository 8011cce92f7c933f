"""Environment knobs the port reads (port of ``horovod_tpu/utils/env.py``:
the parsing helpers, the launcher's identity contract, the enqueue
runtime's knobs, the fusion bucket quantum, the ZeRO stage and gradient
release knobs, and the flash attention's ``FLASH_FUSED_BWD`` switch)."""

from __future__ import annotations

import os

# Identity / wiring the launcher sets before init (reference:
# horovod_tpu/core/basics.py:76-129, gloo_context.cc HOROVOD_RANK/SIZE/...).
HOROVOD_RANK = "HOROVOD_RANK"
HOROVOD_SIZE = "HOROVOD_SIZE"
HOROVOD_LOCAL_RANK = "HOROVOD_LOCAL_RANK"
HOROVOD_LOCAL_SIZE = "HOROVOD_LOCAL_SIZE"
HOROVOD_CROSS_RANK = "HOROVOD_CROSS_RANK"
HOROVOD_CROSS_SIZE = "HOROVOD_CROSS_SIZE"
HOROVOD_COORDINATOR_ADDR = "HOROVOD_COORDINATOR_ADDR"
HOROVOD_LOG_LEVEL = "HOROVOD_LOG_LEVEL"
HOROVOD_LOG_HIDE_TIME = "HOROVOD_LOG_HIDE_TIME"

# The enqueue runtime (reference: horovod/common/common.h:61-85,
# operations.cc:363-454; the JAX package's defaults,
# horovod_tpu/utils/env.py:15-55, 152-156).
# Bytes one fused allreduce may carry; 0 gives one collective a tensor.
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
# Least ms from the start of one cycle to the start of the next.
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
DEFAULT_CYCLE_TIME_MS = 5.0
# Responses the negotiation cache keeps; 0 turns the cache off.
HOROVOD_CACHE_CAPACITY = "HOROVOD_CACHE_CAPACITY"
DEFAULT_CACHE_CAPACITY = 1024
# Fused responses in flight before the oldest is drained.
HOROVOD_CYCLE_PIPELINE_DEPTH = "HOROVOD_CYCLE_PIPELINE_DEPTH"
DEFAULT_CYCLE_PIPELINE_DEPTH = 2
# Path of the Chrome-trace timeline rank 0 writes; unset: none.
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
DEFAULT_STALL_CHECK_TIME_SECONDS = 60.0

# Size-bucket quantum of flat fused payloads, in bytes (reference:
# horovod_tpu/utils/env.py:55,156); ZeRO pads each per-rank shard to it.
HOROVOD_FUSION_BUCKET_QUANTUM = "HOROVOD_FUSION_BUCKET_QUANTUM"
DEFAULT_FUSION_BUCKET_QUANTUM_BYTES = 64 * 1024

# ZeRO stage of the stock training-step wiring (1-3, clamped) and the
# stage-3 prefetch window, in group allgathers in flight (reference:
# horovod_tpu/utils/env.py:149, horovod_tpu/parallel/zero.py:157-190).
HOROVOD_ZERO_STAGE = "HOROVOD_ZERO_STAGE"
HOROVOD_ZERO_PREFETCH_BUCKETS = "HOROVOD_ZERO_PREFETCH_BUCKETS"
DEFAULT_ZERO_PREFETCH_BUCKETS = 2

# Bucket-wise gradient release (reference: horovod_tpu/utils/env.py:132-133,
# horovod_tpu/parallel/buckets.py:93-146): the target payload of one
# release bucket (rounded up to the fusion quantum), and the switch that
# makes ``training.make_train_step`` build a release plan of its own.
HOROVOD_GRAD_BUCKET_BYTES = "HOROVOD_GRAD_BUCKET_BYTES"
DEFAULT_GRAD_BUCKET_BYTES = 4 * 1024 * 1024
HOROVOD_GRAD_BUCKET_RELEASE = "HOROVOD_GRAD_BUCKET_RELEASE"

# Fused attention backward (reference: horovod_tpu/ops/pallas/
# flash_attention.py:741-742): "1" sends a backward whose query and key
# extents both fit one 1024 block to the one kernel that writes dq, dk and
# dv together; unset or "0" keeps the dq and dk/dv kernels.
FLASH_FUSED_BWD = "FLASH_FUSED_BWD"


def _get_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return int(value)
    except ValueError:
        return default


def _get_float(name: str, default: float) -> float:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return float(value)
    except ValueError:
        return default


def _get_bool(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    return value.strip().lower() not in ("0", "false", "no", "off", "")


def flash_fused_bwd() -> bool:
    """``FLASH_FUSED_BWD``, default off. The JAX package reads it when it
    traces the backward; the port runs eagerly and reads it at each
    backward call, so a change takes effect at the next backward."""
    return _get_bool(FLASH_FUSED_BWD, False)
