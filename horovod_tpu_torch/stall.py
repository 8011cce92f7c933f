"""Stall inspector and straggler attribution: find workers that stopped
submitting tensors, and the ranks that announce late (port of
``StragglerTracker`` and ``StallInspector`` in ``horovod_tpu/stall.py``;
reference: horovod/common/stall_inspector.cc/.h).

On the coordinator, scan the negotiation table for tensors announced by
some but not all workers; log a warning naming the ready and missing ranks
and, when a :class:`StragglerTracker` is given, their lateness
(stall_inspector.cc:26-110); past the shutdown time, ask for a global
shutdown so the job fails instead of hanging (controller.cc:98-107).

Knobs (reference: common.h:78-80), read into ``utils.env.Config`` at
``hvd.init()``: ``HOROVOD_STALL_CHECK_DISABLE``,
``HOROVOD_STALL_CHECK_TIME_SECONDS`` (default 60),
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` (default 0: never shut down) and
``HOROVOD_STRAGGLER_REPORT_SECONDS`` (the tracker's report interval,
default 60; 0: no report).

Under ``HOROVOD_ELASTIC`` (``Config.elastic``) a stall past the shutdown
time raises :class:`~horovod_tpu_torch.exceptions.WorkerStallError`
naming the missing ranks, in place of the shutdown's True: the controller
keeps it as its typed verdict and still sends the shutdown bit, and
``@hvd.elastic.run`` re-forms without the stalled ranks.

The flight recorder gets ``stall_warning``, ``stall_shutdown`` (with a
failure dump) and ``straggler_report``; the coordinator's arrival skew of
each negotiation is the goodput ledger's ``straggler_wait``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch.exceptions import WorkerStallError
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log

_STALL_WARNINGS = _metrics().counter(
    "horovod_stall_warnings_total",
    "Tensors reported stalled by the stall inspector (one per tensor per "
    "warning scan).")
_STALL_SHUTDOWNS = _metrics().counter(
    "horovod_stall_shutdowns_total",
    "Stall scans that exceeded HOROVOD_STALL_SHUTDOWN_TIME_SECONDS and "
    "triggered a global shutdown.")
_STRAGGLER_LAG = _metrics().gauge(
    "horovod_straggler_lag_seconds",
    "Per-rank negotiation lateness EWMA on the coordinator: how long "
    "after the first announcing rank this rank's request arrives, "
    "smoothed across negotiations.", labelnames=("rank",))
_NEGOTIATE_SKEW = _metrics().histogram(
    "horovod_negotiate_skew_seconds",
    "Cross-rank arrival skew (last minus first announcement) per "
    "completed negotiation on the coordinator.")


class StragglerTracker:
    """Straggler attribution on the coordinator, from each rank's arrival
    time in the negotiation table.

    Every completed negotiation gives one arrival map ``{rank:
    monotonic_time}``; from it the tracker feeds the skew histogram, each
    rank's lateness EWMA (``horovod_straggler_lag_seconds{rank=...}``) and
    a periodic log report naming the ranks that arrive last. An arrival's
    resolution is one cycle: ranks that announce in the same cycle read as
    simultaneous, while a real straggler lags by many cycles and dominates
    the EWMA."""

    def __init__(self, world: int, alpha: float = 0.2,
                 report_seconds: float = 60.0):
        self.world = world
        self.alpha = alpha
        self.report_seconds = report_seconds
        self.lag_ewma: Dict[int, float] = {}
        self.last_counts: Dict[int, int] = {}
        self.samples = 0
        self._last_report = time.monotonic()

    def observe(self, name: str, arrivals: Dict[int, float]) -> None:
        if not arrivals:
            return
        t_first = min(arrivals.values())
        skew = max(arrivals.values()) - t_first
        _NEGOTIATE_SKEW.observe(skew)
        if skew > 0:
            # how long the first rank's tensor waited for the last one:
            # straggler badput on the coordinator's ledger
            goodput.record_span("straggler_wait", skew)
        for rank, t in arrivals.items():
            lag = t - t_first
            prev = self.lag_ewma.get(rank)
            ewma = lag if prev is None else prev + self.alpha * (lag - prev)
            self.lag_ewma[rank] = ewma
            _STRAGGLER_LAG.labels(rank=rank).set(ewma)
        if skew > 0:
            last_rank = max(arrivals, key=lambda r: arrivals[r])
            self.last_counts[last_rank] = \
                self.last_counts.get(last_rank, 0) + 1
        self.samples += 1
        self.maybe_report()

    def ranking(self) -> List[Tuple[int, float]]:
        return sorted(self.lag_ewma.items(), key=lambda kv: -kv[1])

    def lag_summary(self, ranks=None) -> str:
        items = self.ranking()
        if ranks:
            wanted = [kv for kv in items if kv[0] in set(ranks)]
            items = wanted or items
        return ", ".join("rank %d=%.3fs" % kv for kv in items[:8])

    def maybe_report(self) -> None:
        if self.report_seconds <= 0 or not self.samples:
            return
        now = time.monotonic()
        if now - self._last_report < self.report_seconds:
            return
        self._last_report = now
        leader, _ = self.ranking()[0]
        last_frac = self.last_counts.get(leader, 0) / self.samples
        log.info(
            "straggler report: over %d negotiations the lateness EWMA is "
            "%s; rank %d arrived last in %.0f%% of them",
            self.samples, self.lag_summary(), leader, 100.0 * last_frac)
        flight_recorder.emit("straggler_report", leader=leader,
                             lag=round(self.lag_ewma.get(leader, 0.0), 6),
                             samples=self.samples)


class StallInspector:
    def __init__(self, warning_time_seconds: float = 60.0,
                 shutdown_time_seconds: float = 0.0, enabled: bool = True,
                 elastic: bool = False):
        self.warning_time = warning_time_seconds
        self.shutdown_time = shutdown_time_seconds
        self.enabled = enabled
        # a stall past the shutdown time raises WorkerStallError instead
        self.elastic = elastic
        self._last_check = time.monotonic()
        # fallback age baseline for tables that carry no arrival stamp
        self._first_seen: Dict[str, float] = {}

    def check(self, message_table, world: Optional[int] = None,
              straggler: Optional[StragglerTracker] = None) -> bool:
        """Scan for stalled tensors; True when one stalled past the
        shutdown time (reference: CheckForStalledTensors,
        stall_inspector.cc:26-110)."""
        if not self.enabled:
            return False
        now = time.monotonic()
        if now - self._last_check < self.warning_time:
            return False
        self._last_check = now

        stalled, shutdown, warn_missing = [], False, set()
        missing_ranks: set = set()
        arrival_time = getattr(message_table, "first_request_time", None)
        pending = message_table.pending()
        for name, requests in pending.items():
            first = arrival_time(name) if arrival_time is not None else None
            if first is None:
                first = self._first_seen.setdefault(name, now)
            age = now - first
            if age < self.warning_time:
                continue
            ready = sorted(r.rank for r in requests)
            missing = ([] if world is None else
                       sorted(set(range(world)) - set(ready)))
            stalled.append(
                f"{name} [ready ranks: {ready}"
                + (f", missing ranks: {missing}]" if missing else "]"))
            warn_missing.update(missing)
            if self.shutdown_time > 0 and age > self.shutdown_time:
                shutdown = True
                missing_ranks.update(missing)
        self._first_seen = {k: v for k, v in self._first_seen.items()
                            if k in pending}
        if stalled:
            _STALL_WARNINGS.inc(len(stalled))
            lag_note = ""
            if straggler is not None:
                summary = straggler.lag_summary(warn_missing or None)
                if summary:
                    lag_note = (" Straggler lag EWMA (seconds since first "
                                "announcing rank): %s." % summary)
            log.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for "
                "remainder of ranks for more than %.0f seconds. This may "
                "indicate that different ranks are trying to submit "
                "different tensors or that only subset of ranks is "
                "submitting tensors. Stalled ops: %s%s",
                self.warning_time, "; ".join(stalled), lag_note)
            flight_recorder.emit("stall_warning", tensors=len(stalled),
                                 missing=sorted(warn_missing))
        if shutdown:
            _STALL_SHUTDOWNS.inc()
            log.error(
                "Stalled tensors exceeded "
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS (%.0fs); "
                "shutting down.", self.shutdown_time)
            flight_recorder.emit("stall_shutdown",
                                 ranks=sorted(missing_ranks))
            flight_recorder.dump_on_failure("stall_shutdown")
            if self.elastic:
                raise WorkerStallError(
                    f"stalled ranks exceeded the shutdown threshold "
                    f"({self.shutdown_time:.0f}s): {'; '.join(stalled)}",
                    ranks=sorted(missing_ranks))
        return shutdown
