"""Environment knobs the port reads (port of ``horovod_tpu/utils/env.py``:
the parsing helpers, the launcher's identity contract, the enqueue
runtime's knobs and :class:`Config`, the fusion bucket quantum, the metrics
endpoint and dump, the ZeRO stage and gradient release knobs, the step
profiler's and the integrity plane's knobs, the checkpoint writer's, its
restore's and its replica ring's knobs, the elastic layer's, the
rendezvous store's and the control plane's resilience knobs, the four
observability planes' knobs, the autotuner's and the two-level
hierarchy's knobs and the probe cache, the tracing and SLO plane's and
the serving plane's knobs, and the flash attention's ``FLASH_FUSED_BWD``
switch).

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

# The integrity plane (integrity/): armed, the step guard's spike
# threshold in EWMA standard deviations and the consecutive skips before
# it raises, the collective digests' cadence in eligible dispatches (0: no
# digest), whether a rank the digest vote names exits (quarantine), and
# the in-place rollbacks a process may take (horovod_tpu/utils/env.py:
# 112-114, horovod_tpu/integrity/).
HOROVOD_INTEGRITY = "HOROVOD_INTEGRITY"
HOROVOD_INTEGRITY_SPIKE_SIGMA = "HOROVOD_INTEGRITY_SPIKE_SIGMA"
HOROVOD_INTEGRITY_SKIP_STEPS = "HOROVOD_INTEGRITY_SKIP_STEPS"
HOROVOD_INTEGRITY_INTERVAL = "HOROVOD_INTEGRITY_INTERVAL"
HOROVOD_INTEGRITY_QUARANTINE = "HOROVOD_INTEGRITY_QUARANTINE"
HOROVOD_ROLLBACK_BUDGET = "HOROVOD_ROLLBACK_BUDGET"

# The elastic layer (elastic/; horovod_tpu/utils/env.py:97-106): on
# (Config.elastic: a stall past the shutdown time and a peer's shutdown bit
# raise WorkersDownError), the least workers a re-form accepts, its
# retries and their backoff, the seconds a membership scan must stay
# unchanged, the re-form's deadline, the heartbeat's period, the driver's
# discovery period, the State's disk spill, and the sharded checkpoint
# directory a State commits to and rolls back from.
HOROVOD_ELASTIC = "HOROVOD_ELASTIC"
HOROVOD_ELASTIC_MIN_WORKERS = "HOROVOD_ELASTIC_MIN_WORKERS"
HOROVOD_ELASTIC_MAX_RETRIES = "HOROVOD_ELASTIC_MAX_RETRIES"
HOROVOD_ELASTIC_BACKOFF_BASE_SECONDS = "HOROVOD_ELASTIC_BACKOFF_BASE_SECONDS"
HOROVOD_ELASTIC_BACKOFF_MAX_SECONDS = "HOROVOD_ELASTIC_BACKOFF_MAX_SECONDS"
HOROVOD_ELASTIC_SETTLE_SECONDS = "HOROVOD_ELASTIC_SETTLE_SECONDS"
HOROVOD_ELASTIC_REJOIN_TIMEOUT_SECONDS = \
    "HOROVOD_ELASTIC_REJOIN_TIMEOUT_SECONDS"
HOROVOD_ELASTIC_HEARTBEAT_SECONDS = "HOROVOD_ELASTIC_HEARTBEAT_SECONDS"
HOROVOD_ELASTIC_DISCOVERY_INTERVAL_SECONDS = \
    "HOROVOD_ELASTIC_DISCOVERY_INTERVAL_SECONDS"
HOROVOD_ELASTIC_SPILL_DIR = "HOROVOD_ELASTIC_SPILL_DIR"
HOROVOD_ELASTIC_SPILL_SYNC = "HOROVOD_ELASTIC_SPILL_SYNC"
HOROVOD_CKPT_DIR = "HOROVOD_CKPT_DIR"

# The launcher's rendezvous store (run/rendezvous.py): its address and
# port, the heartbeat scope's TTL and the long-poll window of a get; the
# gloo control group's timeout in seconds, which bounds how long a dead
# peer can hold a survivor (default 30).
HOROVOD_RENDEZVOUS_HTTP_ADDR = "HOROVOD_RENDEZVOUS_HTTP_ADDR"
HOROVOD_RENDEZVOUS_HTTP_PORT = "HOROVOD_RENDEZVOUS_HTTP_PORT"
HOROVOD_RENDEZVOUS_HEARTBEAT_TTL = "HOROVOD_RENDEZVOUS_HEARTBEAT_TTL"
HOROVOD_RENDEZVOUS_LONG_POLL_SECONDS = "HOROVOD_RENDEZVOUS_LONG_POLL_SECONDS"
HOROVOD_GLOO_TIMEOUT_SECONDS = "HOROVOD_GLOO_TIMEOUT_SECONDS"
DEFAULT_GLOO_TIMEOUT_SECONDS = 30.0

# Control-plane resilience (utils/resilience.py): the retry policy of the
# store's client, the deadline of a negotiation round (0: none), and the
# fault harness's clauses (process, network and data-corruption faults).
HOROVOD_NET_MAX_RETRIES = "HOROVOD_NET_MAX_RETRIES"
HOROVOD_NET_BACKOFF_BASE_SECONDS = "HOROVOD_NET_BACKOFF_BASE_SECONDS"
HOROVOD_NET_BACKOFF_MAX_SECONDS = "HOROVOD_NET_BACKOFF_MAX_SECONDS"
HOROVOD_NET_DEADLINE_SECONDS = "HOROVOD_NET_DEADLINE_SECONDS"
HOROVOD_NET_ATTEMPT_TIMEOUT_SECONDS = "HOROVOD_NET_ATTEMPT_TIMEOUT_SECONDS"
HOROVOD_COLLECTIVE_TIMEOUT = "HOROVOD_COLLECTIVE_TIMEOUT"
HOROVOD_FAULT_INJECT = "HOROVOD_FAULT_INJECT"

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

# The sharded checkpoint (ckpt/; horovod_tpu/ckpt/writer.py:66-70,
# restore.py:41, replica.py:38): async writes (default on), the cuts kept (default 2), the commit barrier's
# timeout in seconds (default 30), the commit-phase fault
# (``kill:rank=<r>:phase=<stage|barrier|publish>[:step=<s>][:code=<c>]``),
# per-leaf CRC checks on restore (default on) and the neighbour-replica ring
# (default on at world >= 2). Each is read where it is used.
HOROVOD_CKPT_ASYNC = "HOROVOD_CKPT_ASYNC"
HOROVOD_CKPT_KEEP = "HOROVOD_CKPT_KEEP"
HOROVOD_CKPT_BARRIER_TIMEOUT_SECONDS = "HOROVOD_CKPT_BARRIER_TIMEOUT_SECONDS"
HOROVOD_CKPT_FAULT = "HOROVOD_CKPT_FAULT"
HOROVOD_CKPT_VERIFY = "HOROVOD_CKPT_VERIFY"
HOROVOD_CKPT_REPLICATION = "HOROVOD_CKPT_REPLICATION"

# The observability planes (horovod_tpu/utils/env.py:56-57, 157,
# 208-221; memory.py:61-63, comms.py:71-74, goodput.py:68-70): the flight
# recorder (on by default; an integer > 1 is the ring's capacity) and its
# dump directory; the memory ledger (on), its sampler's cadence in seconds
# and the live tensors an OOM record lists; the comms observatory (on),
# its window of records a key, its EWMA weight and its degradation
# threshold; the goodput ledger (on), its incident capacity and the
# cadence of its log report (0: none). Each is read by its module's
# ``configure``, which ``init()`` calls.
HOROVOD_FLIGHT_RECORDER = "HOROVOD_FLIGHT_RECORDER"
HOROVOD_FLIGHT_RECORDER_DIR = "HOROVOD_FLIGHT_RECORDER_DIR"
DEFAULT_FLIGHT_RECORDER_CAPACITY = 2048
HOROVOD_MEMORY = "HOROVOD_MEMORY"
HOROVOD_MEMORY_SAMPLE_SECONDS = "HOROVOD_MEMORY_SAMPLE_SECONDS"
HOROVOD_MEMORY_TOPK = "HOROVOD_MEMORY_TOPK"
HOROVOD_COMMS = "HOROVOD_COMMS"
HOROVOD_COMMS_WINDOW = "HOROVOD_COMMS_WINDOW"
HOROVOD_COMMS_EWMA_ALPHA = "HOROVOD_COMMS_EWMA_ALPHA"
HOROVOD_COMMS_DEGRADED_FRACTION = "HOROVOD_COMMS_DEGRADED_FRACTION"
HOROVOD_GOODPUT = "HOROVOD_GOODPUT"
HOROVOD_GOODPUT_INCIDENTS = "HOROVOD_GOODPUT_INCIDENTS"
HOROVOD_GOODPUT_REPORT_SECONDS = "HOROVOD_GOODPUT_REPORT_SECONDS"

# The autotuner (autotune/; horovod_tpu/utils/env.py:20-26, 240-246): on,
# the hardware probes at the runtime's start, the coordinator's CSV log,
# the samples discarded first, the busy cycles a sample, the Bayesian
# samples before the tuner freezes, and the Gaussian process's noise.
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_PROBE = "HOROVOD_AUTOTUNE_PROBE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE = "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE"
HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES = \
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES"
HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE = \
    "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE"
# The two-level collectives (runtime/hierarchy.py; horovod_tpu/utils/
# env.py:32-39): the hierarchical allreduce (and reduce-scatter) and
# allgather, the ranks a group (0: groups from the hosts' names) and the
# wire type of the cross hop (none | fp16 (bf16) | ieee_fp16).
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_HIERARCHICAL_ALLGATHER = "HOROVOD_HIERARCHICAL_ALLGATHER"
HOROVOD_HIERARCHY_GROUP_SIZE = "HOROVOD_HIERARCHY_GROUP_SIZE"
HOROVOD_HIERARCHY_COMPRESSION = "HOROVOD_HIERARCHY_COMPRESSION"
# The probe cache (autotune/probe.py): the JSON file the probes' rooflines
# are kept in and read back from; unset: none.
HOROVOD_PROBE_CACHE = "HOROVOD_PROBE_CACHE"

# Request tracing and the SLO plane (tracing.py; horovod_tpu/utils/env.py:
# 69-74, 162): tracing on (default; "0" turns it off, an integer > 1 is
# the span ring's capacity), the latency objectives in ms, the compliance
# target of all three objectives, the rolling window in requests and the
# burn rate whose upward crossing emits an ``slo_burn_rate`` event.
HOROVOD_TRACE = "HOROVOD_TRACE"
HOROVOD_SLO_TTFT_MS = "HOROVOD_SLO_TTFT_MS"
HOROVOD_SLO_LATENCY_MS = "HOROVOD_SLO_LATENCY_MS"
HOROVOD_SLO_AVAILABILITY = "HOROVOD_SLO_AVAILABILITY"
HOROVOD_SLO_WINDOW = "HOROVOD_SLO_WINDOW"
HOROVOD_SLO_BURN_ALERT = "HOROVOD_SLO_BURN_ALERT"
DEFAULT_TRACE_CAPACITY = 4096
DEFAULT_SLO_WINDOW = 512

# The serving plane (serve/; horovod_tpu/utils/env.py:123-129, the JAX
# package's serve/api.py, queue.py and paging.py): the committed-token
# budget of a replica's batch, the admission deadline in ms, the request
# queue's capacity, the decode steps between admission checks, the KV
# slots a replica, the default generation length, whether the step guard
# quarantines a replica, the seconds a finished result is held, the paged
# KV cache, its page size in tokens, its pool in pages (0: half the dense
# capacity) and the prefix cache's entries (0: no prefix reuse).
HOROVOD_SERVE_MAX_BATCH_TOKENS = "HOROVOD_SERVE_MAX_BATCH_TOKENS"
HOROVOD_SERVE_ADMISSION_MS = "HOROVOD_SERVE_ADMISSION_MS"
HOROVOD_SERVE_QUEUE_CAPACITY = "HOROVOD_SERVE_QUEUE_CAPACITY"
HOROVOD_SERVE_DECODE_BLOCK = "HOROVOD_SERVE_DECODE_BLOCK"
HOROVOD_SERVE_SLOTS = "HOROVOD_SERVE_SLOTS"
HOROVOD_SERVE_MAX_NEW_TOKENS = "HOROVOD_SERVE_MAX_NEW_TOKENS"
HOROVOD_SERVE_QUARANTINE = "HOROVOD_SERVE_QUARANTINE"
HOROVOD_SERVE_RESULT_TTL_S = "HOROVOD_SERVE_RESULT_TTL_S"
HOROVOD_SERVE_PAGED = "HOROVOD_SERVE_PAGED"
HOROVOD_SERVE_PAGE_TOKENS = "HOROVOD_SERVE_PAGE_TOKENS"
HOROVOD_SERVE_PAGE_POOL = "HOROVOD_SERVE_PAGE_POOL"
HOROVOD_SERVE_PREFIX_CACHE = "HOROVOD_SERVE_PREFIX_CACHE"

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


def parse_flight_recorder(value: "str | None") -> "tuple[bool, int]":
    """``HOROVOD_FLIGHT_RECORDER`` -> (enabled, ring capacity). Unset or
    truthy = on at the default capacity; an integer > 1 is the capacity;
    0/false/no/off disables."""
    if value is None or value.strip() == "":
        return True, DEFAULT_FLIGHT_RECORDER_CAPACITY
    v = value.strip().lower()
    if v in ("0", "false", "no", "off"):
        return False, DEFAULT_FLIGHT_RECORDER_CAPACITY
    try:
        n = int(v)
    except ValueError:
        return True, DEFAULT_FLIGHT_RECORDER_CAPACITY
    return True, (n if n > 1 else DEFAULT_FLIGHT_RECORDER_CAPACITY)


def parse_trace(value: "str | None") -> "tuple[bool, int]":
    """``HOROVOD_TRACE`` -> (enabled, span ring capacity), the grammar of
    ``HOROVOD_FLIGHT_RECORDER``: unset or truthy = on at the default
    capacity; an integer > 1 is the capacity; 0/false/no/off disables."""
    if value is None or value.strip() == "":
        return True, DEFAULT_TRACE_CAPACITY
    v = value.strip().lower()
    if v in ("0", "false", "no", "off"):
        return False, DEFAULT_TRACE_CAPACITY
    try:
        n = int(v)
    except ValueError:
        return True, DEFAULT_TRACE_CAPACITY
    return True, (n if n > 1 else DEFAULT_TRACE_CAPACITY)


def native_cycle() -> bool:
    """``HOROVOD_NATIVE_CYCLE``, default on."""
    return _get_bool(HOROVOD_NATIVE_CYCLE, True)


# Knobs read where they are used rather than parsed into Config: the
# launcher's identity and wiring (read by init() before a Config exists),
# the ZeRO and release-plan knobs (read when a plan or a training step is
# built), the attention backward's switch (read at each backward), the
# integrity knobs (read when a guard is made or a step is taken) and the
# checkpoint knobs (read when a manager is made or a commit or a restore
# runs), the elastic, rendezvous and resilience knobs (read when a
# re-form, a commit, a store client or a transport needs them), the
# observability planes' knobs (read by each plane's ``configure``), and the
# tracing, SLO and serving knobs (read by ``tracing.configure`` and when a
# policy, queue or engine is made).
ENV_DIRECT_KNOBS = (
    HOROVOD_RANK, HOROVOD_SIZE, HOROVOD_LOCAL_RANK, HOROVOD_LOCAL_SIZE,
    HOROVOD_CROSS_RANK, HOROVOD_CROSS_SIZE, HOROVOD_COORDINATOR_ADDR,
    HOROVOD_LOG_LEVEL, HOROVOD_LOG_HIDE_TIME, HOROVOD_ZERO_STAGE,
    HOROVOD_ZERO_PREFETCH_BUCKETS, HOROVOD_GRAD_BUCKET_BYTES,
    HOROVOD_GRAD_BUCKET_RELEASE, FLASH_FUSED_BWD, HOROVOD_INTEGRITY,
    HOROVOD_INTEGRITY_SPIKE_SIGMA, HOROVOD_INTEGRITY_SKIP_STEPS,
    HOROVOD_CKPT_ASYNC, HOROVOD_CKPT_KEEP,
    HOROVOD_CKPT_BARRIER_TIMEOUT_SECONDS, HOROVOD_CKPT_FAULT,
    HOROVOD_CKPT_VERIFY, HOROVOD_CKPT_REPLICATION,
    HOROVOD_INTEGRITY_INTERVAL, HOROVOD_INTEGRITY_QUARANTINE,
    HOROVOD_ROLLBACK_BUDGET, HOROVOD_ELASTIC_MIN_WORKERS,
    HOROVOD_ELASTIC_MAX_RETRIES, HOROVOD_ELASTIC_BACKOFF_BASE_SECONDS,
    HOROVOD_ELASTIC_BACKOFF_MAX_SECONDS, HOROVOD_ELASTIC_SETTLE_SECONDS,
    HOROVOD_ELASTIC_REJOIN_TIMEOUT_SECONDS,
    HOROVOD_ELASTIC_HEARTBEAT_SECONDS,
    HOROVOD_ELASTIC_DISCOVERY_INTERVAL_SECONDS, HOROVOD_ELASTIC_SPILL_DIR,
    HOROVOD_ELASTIC_SPILL_SYNC, HOROVOD_CKPT_DIR,
    HOROVOD_RENDEZVOUS_HTTP_ADDR, HOROVOD_RENDEZVOUS_HTTP_PORT,
    HOROVOD_RENDEZVOUS_HEARTBEAT_TTL, HOROVOD_RENDEZVOUS_LONG_POLL_SECONDS,
    HOROVOD_GLOO_TIMEOUT_SECONDS, HOROVOD_NET_MAX_RETRIES,
    HOROVOD_NET_BACKOFF_BASE_SECONDS, HOROVOD_NET_BACKOFF_MAX_SECONDS,
    HOROVOD_NET_DEADLINE_SECONDS, HOROVOD_NET_ATTEMPT_TIMEOUT_SECONDS,
    HOROVOD_COLLECTIVE_TIMEOUT, HOROVOD_FAULT_INJECT,
    HOROVOD_FLIGHT_RECORDER, HOROVOD_FLIGHT_RECORDER_DIR, HOROVOD_MEMORY,
    HOROVOD_MEMORY_SAMPLE_SECONDS, HOROVOD_MEMORY_TOPK, HOROVOD_COMMS,
    HOROVOD_COMMS_WINDOW, HOROVOD_COMMS_EWMA_ALPHA,
    HOROVOD_COMMS_DEGRADED_FRACTION, HOROVOD_GOODPUT,
    HOROVOD_GOODPUT_INCIDENTS, HOROVOD_GOODPUT_REPORT_SECONDS,
    HOROVOD_PROBE_CACHE, HOROVOD_TRACE, HOROVOD_SLO_TTFT_MS,
    HOROVOD_SLO_LATENCY_MS, HOROVOD_SLO_AVAILABILITY, HOROVOD_SLO_WINDOW,
    HOROVOD_SLO_BURN_ALERT, HOROVOD_SERVE_MAX_BATCH_TOKENS,
    HOROVOD_SERVE_ADMISSION_MS, HOROVOD_SERVE_QUEUE_CAPACITY,
    HOROVOD_SERVE_DECODE_BLOCK, HOROVOD_SERVE_SLOTS,
    HOROVOD_SERVE_MAX_NEW_TOKENS, HOROVOD_SERVE_QUARANTINE,
    HOROVOD_SERVE_RESULT_TTL_S, HOROVOD_SERVE_PAGED,
    HOROVOD_SERVE_PAGE_TOKENS, HOROVOD_SERVE_PAGE_POOL,
    HOROVOD_SERVE_PREFIX_CACHE,
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
    # elastic mode: a stall past the shutdown time and a peer's shutdown
    # bit raise WorkersDownError, which @elastic.run answers with a re-form
    elastic: bool = False
    # the autotuner (autotune/): the coordinator tunes, every rank applies
    autotune: bool = False
    autotune_probe: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8
    # the two-level collectives (runtime/hierarchy.py); the autotuner
    # writes these through its synchronized blob
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    hierarchy_group_size: int = 0
    hierarchy_compression: str = "none"

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
            elastic=_get_bool(HOROVOD_ELASTIC),
            autotune=_get_bool(HOROVOD_AUTOTUNE),
            autotune_probe=_get_bool(HOROVOD_AUTOTUNE_PROBE),
            autotune_log=os.environ.get(HOROVOD_AUTOTUNE_LOG, ""),
            autotune_warmup_samples=_get_int(
                HOROVOD_AUTOTUNE_WARMUP_SAMPLES, 3),
            autotune_steps_per_sample=_get_int(
                HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE, 10),
            autotune_bayes_opt_max_samples=_get_int(
                HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES, 20),
            autotune_gaussian_process_noise=_get_float(
                HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE, 0.8),
            hierarchical_allreduce=_get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
            hierarchical_allgather=_get_bool(HOROVOD_HIERARCHICAL_ALLGATHER),
            hierarchy_group_size=_get_int(HOROVOD_HIERARCHY_GROUP_SIZE, 0),
            hierarchy_compression=os.environ.get(
                HOROVOD_HIERARCHY_COMPRESSION, "none"),
        )


def gloo_timeout_seconds() -> float:
    """``HOROVOD_GLOO_TIMEOUT_SECONDS``: the control group's timeout."""
    return _get_float(HOROVOD_GLOO_TIMEOUT_SECONDS,
                      DEFAULT_GLOO_TIMEOUT_SECONDS)


def flash_fused_bwd() -> bool:
    """``FLASH_FUSED_BWD``, default off. The JAX package reads it when it
    traces the backward; the port runs eagerly and reads it at each
    backward call, so a change takes effect at the next backward."""
    return _get_bool(FLASH_FUSED_BWD, False)
