"""Environment knobs the port reads (port of ``horovod_tpu/utils/env.py``:
the parsing helpers, the launcher's identity contract, the fusion bucket
quantum, and the flash attention's ``FLASH_FUSED_BWD`` switch)."""

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
