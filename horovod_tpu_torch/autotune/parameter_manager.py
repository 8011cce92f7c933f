"""Autotuning parameter manager (a copy of
``horovod_tpu/autotune/parameter_manager.py``: numpy only, so the port
keeps its own; the same score sequence gives byte-equal packed blobs and
the same frozen point).

The reference's ``ParameterManager`` (reference:
horovod/common/parameter_manager.cc/.h:225-251): while training runs, try
different runtime knob settings, score each by negotiation+collective
throughput (bytes/µs — reference: parameter_manager.cc:142-176), and
converge on the best.

Tuned knobs (reference: parameter_manager.h:225-228):
* categorical — ``cache_enabled``, ``hierarchical_allreduce``,
  ``hierarchical_allgather``;
* continuous, jointly via Bayesian optimization —
  ``fusion_threshold_mb`` and ``cycle_time_ms``.

Tuning schedule (a simplification of the reference's nested tunable-param
chain, same spirit): warmup discard → one-at-a-time sweep of each
categorical value → Bayesian optimization over the continuous box →
freeze at the best configuration seen. Scores are medians over
``SAMPLES_PER_POINT`` samples of ``steps_per_sample`` update calls each
(reference: 5-sample medians, 10 steps per sample).

Only the coordinator tunes; every cycle it broadcasts the current
parameter blob and all workers apply it (reference: SynchronizeParameters,
controller.cc:32-46).
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import List, Optional

import numpy as np

from horovod_tpu_torch.autotune.bayesian_optimization import BayesianOptimization

SAMPLES_PER_POINT = 5  # reference: parameter_manager.cc five-sample medians

# continuous search box: fusion threshold (MB), cycle time (ms),
# grad-bucket payload (MB), cycle pipeline depth
FUSION_MB_BOUNDS = (0.0, 64.0)
CYCLE_MS_BOUNDS = (1.0, 25.0)
BUCKET_MB_BOUNDS = (1.0, 64.0)
DEPTH_BOUNDS = (1.0, 4.0)
# ZeRO-3 gather prefetch window (buckets in flight ahead of consumption);
# deeper hides more gather latency, shallower bounds transient HBM
PREFETCH_BOUNDS = (1.0, 8.0)

# Slow-hop wire codecs for the hierarchical cross-group exchange, in
# packed-byte order (index = the byte in the sync blob). Must stay
# append-only: renumbering would desynchronize mixed-commit workers
# mid-rolling-restart.
COMPRESSION_CODECS = ("none", "fp16", "ieee_fp16")


@dataclasses.dataclass
class Params:
    """The synchronized knob set (reference: the POD Params struct bcast by
    SynchronizeParameters)."""

    fusion_threshold_bytes: int
    cycle_time_ms: float
    cache_enabled: bool
    hierarchical_allreduce: bool
    hierarchical_allgather: bool
    active: bool = True  # still tuning?
    # hierarchy split + slow-hop codec + the throughput knobs the rebooted
    # tuner drives; defaulted so pre-reboot call sites construct unchanged
    hierarchy_group_size: int = 0        # 0 = host-derived grouping
    hierarchy_compression: str = "none"  # cross-group wire codec
    grad_bucket_bytes: int = 0           # 0 = keep the configured value
    cycle_pipeline_depth: int = 0        # 0 = keep the configured value
    zero_prefetch_buckets: int = 0       # 0 = keep the configured value

    _FMT = "<qdBBBBBBqBB"

    def pack(self) -> bytes:
        codec = COMPRESSION_CODECS.index(
            normalize_codec(self.hierarchy_compression))
        return struct.pack(
            self._FMT, self.fusion_threshold_bytes, self.cycle_time_ms,
            int(self.cache_enabled), int(self.hierarchical_allreduce),
            int(self.hierarchical_allgather), int(self.active),
            min(255, max(0, int(self.hierarchy_group_size))), codec,
            int(self.grad_bucket_bytes),
            min(255, max(0, int(self.cycle_pipeline_depth))),
            min(255, max(0, int(self.zero_prefetch_buckets))))

    @classmethod
    def unpack(cls, blob: bytes) -> "Params":
        (f, c, ce, ha, hg, act, gsz, codec, bkt,
         depth, prefetch) = struct.unpack(cls._FMT, blob)
        codec_name = (COMPRESSION_CODECS[codec]
                      if codec < len(COMPRESSION_CODECS) else "none")
        return cls(f, c, bool(ce), bool(ha), bool(hg), bool(act),
                   hierarchy_group_size=gsz,
                   hierarchy_compression=codec_name,
                   grad_bucket_bytes=bkt, cycle_pipeline_depth=depth,
                   zero_prefetch_buckets=prefetch)


# Default swept categorical knobs. The hierarchical flags join the sweep
# only when the runtime's data plane actually consults them (a world
# wide enough to split into >= 2 groups of >= 2) —
# sweeping a no-op knob would just burn sample windows on noise.
_CATEGORICAL = ("cache_enabled",)

# env.py accepts spelling variants for the codec knob; the packed blob
# and the sweep work over the canonical names only
_CODEC_ALIASES = {"": "none", "off": "none", "bf16": "fp16",
                  "bfloat16": "fp16", "float16": "ieee_fp16",
                  "f16": "ieee_fp16"}


def normalize_codec(name) -> str:
    """Canonical ``COMPRESSION_CODECS`` member for any accepted codec
    spelling; unknown names fail open to ``"none"``."""
    name = str(name or "none").strip().lower()
    name = _CODEC_ALIASES.get(name, name)
    return name if name in COMPRESSION_CODECS else "none"


# Value pairs per categorical knob; knobs not listed sweep (False, True).
# The codec sweep tries the bf16-wire codec only: ieee_fp16 has the same
# wire width, so on throughput it is indistinguishable and scoring it
# separately would double the sample cost of the phase for nothing.
_CATEGORICAL_VALUES = {"hierarchy_compression": ("none", "fp16")}


def search_box_from_roofline(roofline) -> list:
    """Seed the Bayesian search box from a probe-cache artifact.

    With measured hop bandwidth the payload-sized boxes shrink to what
    the slowest lane can actually move in one maximum-length cycle
    (GB/s x ms = MB), so early BO samples don't burn cycles probing
    bucket/fusion sizes the wire provably cannot drain in time. Without
    an artifact (or a pre-hierarchy schema) the static defaults stand.
    """
    box = [FUSION_MB_BOUNDS, CYCLE_MS_BOUNDS, BUCKET_MB_BOUNDS,
           DEPTH_BOUNDS, PREFETCH_BOUNDS]
    if not roofline:
        return box
    bw = (roofline.get("hier_cross_busbw_gbps")
          or roofline.get("allreduce_busbw_gbps"))
    if not bw or bw <= 0:
        return box
    cap_mb = bw * CYCLE_MS_BOUNDS[1]
    cap_mb = max(BUCKET_MB_BOUNDS[0] * 2.0,
                 min(BUCKET_MB_BOUNDS[1], cap_mb))
    box[0] = (FUSION_MB_BOUNDS[0], min(FUSION_MB_BOUNDS[1], cap_mb))
    box[2] = (BUCKET_MB_BOUNDS[0], cap_mb)
    return box


class ParameterManager:
    """Coordinator-side tuner; workers just apply broadcast params."""

    def __init__(self, initial: Params, warmup_samples: int = 3,
                 steps_per_sample: int = 10, bayes_opt_max_samples: int = 20,
                 gp_noise: float = 0.8, log_path: str = "",
                 rank: int = 0, sweep: tuple = _CATEGORICAL,
                 bounds: Optional[list] = None):
        # an empty sweep (e.g. cache disabled via capacity 0 and no
        # hierarchy) skips the categorical phase entirely
        self._sweep = tuple(sweep)
        self.current = dataclasses.replace(initial)
        self.best = dataclasses.replace(initial)
        self.best_score = -np.inf
        self.active = True
        self._warmup_remaining = warmup_samples
        self._steps_per_sample = max(steps_per_sample, 1)
        self._log_path = log_path
        self._rank = rank

        # accumulation state
        self._step_count = 0
        self._bytes = 0
        self._seconds = 0.0
        self._busbw: List[float] = []  # per-step comms busbw hints (GB/s)
        self._scores: List[float] = []

        # tuning schedule state
        self._phase = "categorical"
        self._cat_index = 0       # which categorical knob
        self._cat_pos = 0         # which of the knob's values is scored
        self._cat_scores: dict = {}
        if self._sweep:
            # the first scored point must actually RUN the value it is
            # labeled with — apply it now rather than scoring the default
            # under a mismatched label
            knob = self._sweep[0]
            setattr(self.current, knob, self._values_of(knob)[0])
        else:
            self._phase = "bayesian"
        # search box: caller-seeded (probe-cache rooflines via
        # search_box_from_roofline) or the static defaults
        self._bounds = list(bounds) if bounds else [
            FUSION_MB_BOUNDS, CYCLE_MS_BOUNDS, BUCKET_MB_BOUNDS,
            DEPTH_BOUNDS, PREFETCH_BOUNDS]
        if len(self._bounds) < 5:
            # pre-ZeRO-3 caller-seeded box — extend rather than crash
            self._bounds.append(PREFETCH_BOUNDS)
        self._bo = BayesianOptimization(
            bounds=self._bounds,
            alpha=max(gp_noise, 1e-6) * 1e-2)
        self._bo_remaining = bayes_opt_max_samples

        # Every artifact names the knobs actually IN the sweep (the
        # hierarchical knobs leave it where no hierarchy can form; the
        # reference logs each trial's full param vector,
        # parameter_manager.cc:256-307). Continuous knobs are always swept
        # by the Bayesian phase; categoricals only when the data plane
        # consults them.
        self.swept_knobs = ("fusion_threshold_mb", "cycle_time_ms",
                            "grad_bucket_mb", "pipeline_depth",
                            "zero_prefetch_buckets") + self._sweep
        if self._rank == 0:  # coordinator only, like the CSV below
            from horovod_tpu_torch.utils.logging import get_logger
            get_logger().info(
                "autotune: sweeping %s (categorical knobs not listed are "
                "frozen at their configured values on this data plane)",
                ",".join(self.swept_knobs))
        if self._log_path and self._rank == 0:
            with open(self._log_path, "w") as f:
                f.write("# swept: " + ",".join(self.swept_knobs) + "\n")
                f.write("timestamp,fusion_threshold_mb,cycle_time_ms,"
                        "cache_enabled,hierarchical_allreduce,"
                        "hierarchical_allgather,hierarchy_group_size,"
                        "hierarchy_compression,grad_bucket_mb,"
                        "pipeline_depth,zero_prefetch_buckets,"
                        "score_bytes_per_us\n")

    @staticmethod
    def _values_of(knob: str) -> tuple:
        return _CATEGORICAL_VALUES.get(knob, (False, True))

    # ------------------------------------------------------------------
    def update(self, nbytes: int, seconds: float,
               busbw_gbs: Optional[float] = None) -> bool:
        """Record one cycle's traffic; returns True when params changed
        (reference: ParameterManager::Update, parameter_manager.cc:142-176).

        ``busbw_gbs`` is the comms plane's smoothed bus bandwidth for the
        cycle (GB/s). When provided, the sample score blends end-to-end
        throughput with wire utilization equally — both are
        bytes-per-microsecond-dimensioned (1 GB/s = 1000 B/us), and a
        knob change that genuinely helps moves both the same direction,
        while one that merely shifts cost between negotiation and the
        wire shows up as the two components disagreeing.
        """
        if not self.active:
            return False
        if nbytes <= 0:
            # idle cycle — the socket controllers sync every cycle even
            # with nothing enqueued; scoring those would measure the cycle
            # cadence, not the knobs (reference advances only on tensor
            # traffic, parameter_manager.cc:142-160)
            return False
        self._bytes += int(nbytes)
        self._seconds += float(seconds)
        if busbw_gbs is not None and busbw_gbs > 0:
            self._busbw.append(float(busbw_gbs))
        self._step_count += 1
        if self._step_count < self._steps_per_sample:
            return False
        # one sample
        score = (self._bytes / (self._seconds * 1e6)
                 if self._seconds > 0 else 0.0)
        if self._busbw:
            score = 0.5 * score + 0.5 * float(np.mean(self._busbw)) * 1000.0
        self._step_count = 0
        self._bytes = 0
        self._seconds = 0.0
        self._busbw.clear()

        if self._warmup_remaining > 0:
            self._warmup_remaining -= 1
            return False
        self._scores.append(score)
        if len(self._scores) < SAMPLES_PER_POINT:
            return False
        point_score = float(np.median(self._scores))
        self._scores.clear()
        return self._tune(point_score)

    # ------------------------------------------------------------------
    def _log(self, score: float) -> None:
        if not self._log_path or self._rank != 0:
            return
        with open(self._log_path, "a") as f:
            c = self.current
            f.write(f"{time.time():.3f},"
                    f"{c.fusion_threshold_bytes / (1024 * 1024):.3f},"
                    f"{c.cycle_time_ms:.3f},{int(c.cache_enabled)},"
                    f"{int(c.hierarchical_allreduce)},"
                    f"{int(c.hierarchical_allgather)},"
                    f"{int(c.hierarchy_group_size)},"
                    f"{c.hierarchy_compression},"
                    f"{c.grad_bucket_bytes / (1024 * 1024):.3f},"
                    f"{int(c.cycle_pipeline_depth)},"
                    f"{int(c.zero_prefetch_buckets)},{score:.3f}\n")

    def _record(self, score: float) -> None:
        self._log(score)
        if score > self.best_score:
            self.best_score = score
            self.best = dataclasses.replace(self.current)

    def _tune(self, score: float) -> bool:
        """Advance the schedule; returns True when current params changed
        (reference: ParameterManager::Tune)."""
        self._record(score)

        if self._phase == "categorical":
            knob = self._sweep[self._cat_index]
            values = self._values_of(knob)
            self._cat_scores[(knob, values[self._cat_pos])] = score
            if self._cat_pos + 1 < len(values):
                # score the next value
                self._cat_pos += 1
                setattr(self.current, knob, values[self._cat_pos])
                return True
            # all values scored — keep the best, move to next knob
            best_val = max(values,
                           key=lambda v: self._cat_scores[(knob, v)])
            setattr(self.current, knob, best_val)
            self._cat_index += 1
            self._cat_pos = 0
            if self._cat_index >= len(self._sweep):
                self._phase = "bayesian"
                nxt = self._bo.next_sample()
                self._apply_continuous(nxt)
            else:
                nxt_knob = self._sweep[self._cat_index]
                setattr(self.current, nxt_knob,
                        self._values_of(nxt_knob)[0])
            return True

        if self._phase == "bayesian":
            x = np.array([
                self.current.fusion_threshold_bytes / (1024.0 * 1024.0),
                self.current.cycle_time_ms,
                max(self._bounds[2][0],
                    self.current.grad_bucket_bytes / (1024.0 * 1024.0)),
                max(self._bounds[3][0],
                    float(self.current.cycle_pipeline_depth)),
                max(self._bounds[4][0],
                    float(self.current.zero_prefetch_buckets))])
            self._bo.add_sample(x, score)
            self._bo_remaining -= 1
            if self._bo_remaining <= 0:
                self._finish()
                return True
            self._apply_continuous(self._bo.next_sample())
            return True

        return False

    def _apply_continuous(self, x) -> None:
        self.current.fusion_threshold_bytes = int(
            max(0.0, float(x[0])) * 1024 * 1024)
        self.current.cycle_time_ms = float(np.clip(
            x[1], CYCLE_MS_BOUNDS[0], CYCLE_MS_BOUNDS[1]))
        self.current.grad_bucket_bytes = int(float(np.clip(
            x[2], self._bounds[2][0],
            self._bounds[2][1])) * 1024 * 1024)
        self.current.cycle_pipeline_depth = int(round(float(np.clip(
            x[3], DEPTH_BOUNDS[0], DEPTH_BOUNDS[1]))))
        self.current.zero_prefetch_buckets = int(round(float(np.clip(
            x[4], PREFETCH_BOUNDS[0], PREFETCH_BOUNDS[1]))))

    def _finish(self) -> None:
        """Freeze at the best configuration seen (reference: tuning ends and
        best params stick; logged for resume-with-tuned-flags,
        docs/autotune.rst:30-37)."""
        self.current = dataclasses.replace(self.best)
        self.current.active = False
        self.active = False
        self._log(self.best_score)

    # ------------------------------------------------------------------
    def params(self) -> Params:
        p = dataclasses.replace(self.current)
        p.active = self.active
        return p
