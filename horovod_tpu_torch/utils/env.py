"""Environment knobs the port reads (port of ``horovod_tpu/utils/env.py``:
the parsing helpers, the launcher's identity contract and the fusion
bucket quantum)."""

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

# Size-bucket quantum of flat fused payloads, in bytes (reference:
# horovod_tpu/utils/env.py:55,156); ZeRO pads each per-rank shard to it.
HOROVOD_FUSION_BUCKET_QUANTUM = "HOROVOD_FUSION_BUCKET_QUANTUM"
DEFAULT_FUSION_BUCKET_QUANTUM_BYTES = 64 * 1024


def _get_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    try:
        return int(value)
    except ValueError:
        return default


def _get_bool(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value is None or value == "":
        return default
    return value.strip().lower() not in ("0", "false", "no", "off", "")
