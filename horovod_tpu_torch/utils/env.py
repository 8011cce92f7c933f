"""Environment knobs the port reads (port of ``horovod_tpu/utils/env.py``:
the parsing helpers, the launcher's identity contract, the enqueue
runtime's knobs and :class:`Config`, the fusion bucket quantum, the metrics
endpoint and dump, the ZeRO stage and gradient release knobs, the step
profiler's and the integrity guard's knobs, and the flash attention's
``FLASH_FUSED_BWD`` switch).

``hvd.init()`` parses the runtime's knobs once into :class:`Config`
(``horovod_tpu/utils/env.py:224-350``); the runtime reads that. The knobs
in :data:`ENV_DIRECT_KNOBS` are read where they are used instead."""

from __future__ import annotations

import dataclasses
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
# Path of the Chrome-trace timeline rank 0 writes; unset: none. With
# HOROVOD_TIMELINE_MARK_CYCLES an instant CYCLE_<n> marks each cycle's
# start (reference: operations.cc:363-375).
HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_TIMELINE_MARK_CYCLES = "HOROVOD_TIMELINE_MARK_CYCLES"
# The stall inspector: the warning's age, and the age past which a stall
# shuts the job down (0: never); the straggler report's interval (0: no
# report; the lag gauge and skew histogram stay on).
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME_SECONDS = "HOROVOD_STALL_CHECK_TIME_SECONDS"
DEFAULT_STALL_CHECK_TIME_SECONDS = 60.0
HOROVOD_STALL_SHUTDOWN_TIME_SECONDS = "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS"
HOROVOD_STRAGGLER_REPORT_SECONDS = "HOROVOD_STRAGGLER_REPORT_SECONDS"
DEFAULT_STRAGGLER_REPORT_SECONDS = 60.0
# The metrics registry (metrics.py): the Prometheus endpoint's port, served
# from init() (0: any free port; unset: no thread, no socket), and where
# shutdown() writes this rank's snapshot (unset: nowhere).
HOROVOD_METRICS_PORT = "HOROVOD_METRICS_PORT"
HOROVOD_METRICS_DUMP = "HOROVOD_METRICS_DUMP"
# The native cycle engine (cpp/cycle.cc, cpp/timeline.cc): on unless "0",
# "false", "no" or "off"; off runs the Python cache, bin-packer and trace
# writer.
HOROVOD_NATIVE_CYCLE = "HOROVOD_NATIVE_CYCLE"

# The step profiler (profiler.py): on, the directory each rank dumps its
# profile into (which also turns profiling on), the step ring's size, and a
# torch.profiler trace of the device into that directory (the JAX
# package's name, where it captures a jax.profiler trace).
HOROVOD_PROFILE = "HOROVOD_PROFILE"
HOROVOD_PROFILE_DIR = "HOROVOD_PROFILE_DIR"
HOROVOD_PROFILE_HISTORY = "HOROVOD_PROFILE_HISTORY"
HOROVOD_PROFILE_JAX = "HOROVOD_PROFILE_JAX"
DEFAULT_PROFILE_HISTORY = 64

# The integrity step guard (integrity/): armed, its spike threshold in
# EWMA standard deviations, and the consecutive skips before it raises.
HOROVOD_INTEGRITY = "HOROVOD_INTEGRITY"
HOROVOD_INTEGRITY_SPIKE_SIGMA = "HOROVOD_INTEGRITY_SPIKE_SIGMA"
HOROVOD_INTEGRITY_SKIP_STEPS = "HOROVOD_INTEGRITY_SKIP_STEPS"

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


def native_cycle() -> bool:
    """``HOROVOD_NATIVE_CYCLE``, default on."""
    return _get_bool(HOROVOD_NATIVE_CYCLE, True)


# Knobs read where they are used rather than parsed into Config: the
# launcher's identity and wiring (read by init() before a Config exists),
# the ZeRO and release-plan knobs (read when a plan or a training step is
# built), the attention backward's switch (read at each backward) and the
# integrity knobs (read when a guard is made or a step is taken).
ENV_DIRECT_KNOBS = (
    HOROVOD_RANK, HOROVOD_SIZE, HOROVOD_LOCAL_RANK, HOROVOD_LOCAL_SIZE,
    HOROVOD_CROSS_RANK, HOROVOD_CROSS_SIZE, HOROVOD_COORDINATOR_ADDR,
    HOROVOD_LOG_LEVEL, HOROVOD_LOG_HIDE_TIME, HOROVOD_ZERO_STAGE,
    HOROVOD_ZERO_PREFETCH_BUCKETS, HOROVOD_GRAD_BUCKET_BYTES,
    HOROVOD_GRAD_BUCKET_RELEASE, FLASH_FUSED_BWD, HOROVOD_INTEGRITY,
    HOROVOD_INTEGRITY_SPIKE_SIGMA, HOROVOD_INTEGRITY_SKIP_STEPS,
)


@dataclasses.dataclass
class Config:
    """The runtime's knobs, parsed once at ``hvd.init()`` (the JAX
    package's ``Config``, ``horovod_tpu/utils/env.py:224-350``, holding only
    the knobs of what the port has; reference: operations.cc:363-454)."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    timeline_file: str = ""
    timeline_mark_cycles: bool = False
    # None: no endpoint (no thread, no socket); 0: any free port
    metrics_port: "int | None" = None
    metrics_dump: str = ""
    stall_check_disable: bool = False
    stall_check_time_seconds: float = DEFAULT_STALL_CHECK_TIME_SECONDS
    stall_shutdown_time_seconds: float = 0.0
    straggler_report_seconds: float = DEFAULT_STRAGGLER_REPORT_SECONDS
    # responses in flight per cycle (1: serial)
    cycle_pipeline_depth: int = DEFAULT_CYCLE_PIPELINE_DEPTH
    fusion_bucket_quantum: int = DEFAULT_FUSION_BUCKET_QUANTUM_BYTES
    native_cycle: bool = True
    # step profiler (profiler.py): a profile dir also turns profiling on
    profile: bool = False
    profile_dir: str = ""
    profile_history: int = DEFAULT_PROFILE_HISTORY
    # also capture a torch.profiler trace of the device into the dir
    profile_jax: bool = False

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            fusion_threshold_bytes=_get_int(HOROVOD_FUSION_THRESHOLD,
                                            DEFAULT_FUSION_THRESHOLD_BYTES),
            cycle_time_ms=_get_float(HOROVOD_CYCLE_TIME,
                                     DEFAULT_CYCLE_TIME_MS),
            cache_capacity=_get_int(HOROVOD_CACHE_CAPACITY,
                                    DEFAULT_CACHE_CAPACITY),
            timeline_file=os.environ.get(HOROVOD_TIMELINE, ""),
            timeline_mark_cycles=_get_bool(HOROVOD_TIMELINE_MARK_CYCLES),
            metrics_port=(_get_int(HOROVOD_METRICS_PORT, 0)
                          if os.environ.get(HOROVOD_METRICS_PORT, "") != ""
                          else None),
            metrics_dump=os.environ.get(HOROVOD_METRICS_DUMP, ""),
            stall_check_disable=_get_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_check_time_seconds=_get_float(
                HOROVOD_STALL_CHECK_TIME_SECONDS,
                DEFAULT_STALL_CHECK_TIME_SECONDS),
            stall_shutdown_time_seconds=_get_float(
                HOROVOD_STALL_SHUTDOWN_TIME_SECONDS, 0.0),
            straggler_report_seconds=_get_float(
                HOROVOD_STRAGGLER_REPORT_SECONDS,
                DEFAULT_STRAGGLER_REPORT_SECONDS),
            cycle_pipeline_depth=_get_int(HOROVOD_CYCLE_PIPELINE_DEPTH,
                                          DEFAULT_CYCLE_PIPELINE_DEPTH),
            fusion_bucket_quantum=_get_int(
                HOROVOD_FUSION_BUCKET_QUANTUM,
                DEFAULT_FUSION_BUCKET_QUANTUM_BYTES),
            native_cycle=native_cycle(),
            profile=(_get_bool(HOROVOD_PROFILE)
                     or os.environ.get(HOROVOD_PROFILE_DIR, "") != ""),
            profile_dir=os.environ.get(HOROVOD_PROFILE_DIR, ""),
            profile_history=_get_int(HOROVOD_PROFILE_HISTORY,
                                     DEFAULT_PROFILE_HISTORY),
            profile_jax=_get_bool(HOROVOD_PROFILE_JAX),
        )


def flash_fused_bwd() -> bool:
    """``FLASH_FUSED_BWD``, default off. The JAX package reads it when it
    traces the backward; the port runs eagerly and reads it at each
    backward call, so a change takes effect at the next backward."""
    return _get_bool(FLASH_FUSED_BWD, False)
