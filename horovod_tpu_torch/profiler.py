"""Step-level performance introspection: phase attribution, comm-overlap
accounting, rolling MFU and the merged cross-rank trace (port of
``horovod_tpu/profiler.py``).

``hvd.profiler.step()`` brackets one training step. At its boundaries the
profiler diffs cheap cumulative accumulators rather than tracing anything:

* **exposed_comm**: the ``horovod_handle_wait_seconds`` sum (caller time
  blocked in ``RuntimeHandle.wait()``) diffed across the step, clamped to
  the step's wall time;
* **host** / **optimizer**: accumulated by ``annotate("host")`` /
  ``annotate("optimizer")`` (``DistributedOptimizer`` annotates its inner
  update);
* **compute**: the remainder, so the four phases sum to the step's wall
  time by construction.

The executor's comm clock (``runtime.executor.comm_totals()``) splits every
collective's lifetime into dispatch-busy, a pipeline overlap window and
drain-busy; the **comm-hidden fraction** is ``1 - exposed / total`` over
the step (and a bytes-weighted variant). ``set_flops_per_step()`` turns the
step's wall time into a rolling MFU.

What the phases mean on the card. The port keeps the JAX package's
definitions, so the two packages' numbers compare, but on a GPU:

* ``exposed_comm`` is host time: ``RuntimeHandle.wait()`` blocks only until
  the runtime has *queued* the collective on its comm stream, then orders
  the caller's stream after it. NCCL time that the device does not hide
  behind other kernels falls into ``compute``;
* the comm clock's totals are the runtime thread's host times of queueing
  each collective, not the device's;
* ``wall_seconds`` is the device's: with profiling on, the profiler
  synchronizes the card (``torch.cuda.synchronize``) where a step opens
  and where it closes, so a step's wall ends when its last kernel has
  run. One synchronize at the boundary is exact and costs one drain of
  the launch queue a step; an event read one step later would keep the
  host ahead but date the close by the next step's host work. With
  profiling off nothing synchronizes;
* ``peak_hbm_bytes`` is ``torch.cuda.max_memory_allocated`` (``None`` on
  the CPU).

Every rank with profiling on dumps ``profile-rank-N.json`` (the last
``HOROVOD_PROFILE_HISTORY`` breakdowns and the Chrome-trace step markers)
into ``HOROVOD_PROFILE_DIR`` at ``shutdown()``; :func:`merge_profile_dir`
merges the dumps, the runtimes' ``timeline-rank-N.json`` and any device
traces below the directory into one Chrome trace, and
:func:`format_step_report` names the slowest rank and phase.
``HOROVOD_PROFILE_JAX`` (the JAX package's name) records a
``torch.profiler`` trace of the CPU and, on the card, CUDA activity from
``init()`` to ``shutdown()`` into ``jax-rank-N/device.trace.json`` under
the directory. Where the JAX package only warns when its trace cannot
start, the port raises: a trace that was asked for and is missing would
pass unseen.

The observability planes ride along as in the JAX package: each step
emits a ``profiler_step`` flight event and gives its wall time to the
goodput ledger (``goodput.record_step``, its exposed-comm phase as badput;
the ledger's frontier guard keeps it from counting a step that
``elastic.State.commit`` counted too); the recent breakdowns are the
flight recorder's ``profiler`` state; and the dump carries the memory
sampler's, the comms tracker's and the goodput ledger's trails, the
incidents and the last flight events, which :func:`merge_profile_dir`
lays out as counter tracks and instant lanes. ``peak_hbm_bytes`` is the
memory ledger's device peak on the card (the same allocator figure). The
dump's ``request_spans`` are the tracing ring's spans (``tracing.py``):
the merge lays them out as per-rank request lanes and joins one
``trace_id`` across the ranks with flow arrows (``tracing.flow_events``).

A dump also ships a copy to the launcher's rendezvous store (its
``profile`` scope, when ``HOROVOD_RENDEZVOUS_HTTP_ADDR``/``_PORT`` are
set), which the port's launcher collects for ``--profile-dir``
(``run/launcher.py``).
"""

from __future__ import annotations

import glob
import json
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from horovod_tpu_torch import comms
from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch import memory
from horovod_tpu_torch import timeline as timeline_mod
from horovod_tpu_torch import tracing
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.runtime import executor
from horovod_tpu_torch.runtime import runtime as runtime_mod
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log

SCHEMA = "horovod-profiler-v1"
# the last flight events a dump carries for the merged trace
_FLIGHT_TRACE_EVENTS = 200
DUMP_PREFIX = "profile-rank-"
RENDEZVOUS_SCOPE = "profile"
MERGED_TRACE = "merged-trace.json"
DEVICE_TRACE = "device.trace.json"
PHASES = ("host", "compute", "exposed_comm", "optimizer")

_STEP_SECONDS = _metrics().histogram(
    "horovod_step_seconds",
    "Wall time of one profiled training step (hvd.profiler.step()).")
_HIDDEN_FRACTION = _metrics().gauge(
    "horovod_comm_hidden_fraction",
    "Fraction of collective time hidden behind other in-flight work over "
    "the last profiled step (1 - exposed/total; 0 when the step ran no "
    "collectives).")
_MFU = _metrics().gauge(
    "horovod_mfu",
    "Rolling model-FLOPs utilization over the profiled step history "
    "(needs hvd.profiler.set_flops_per_step with a peak-FLOPs hint).")


def _handle_wait_seconds() -> float:
    return runtime_mod._HANDLE_WAIT.labels().sum


def _to_merge_form(path: str) -> None:
    """Rewrite a ``torch.profiler`` Chrome trace in the form the merge
    reads: timestamps in epoch microseconds, the profiler's and the
    runtime timeline's clock (torch writes them relative to
    ``baseTimeNanoseconds``), and integer pids (torch names some lanes,
    "Spans" or "Traces", by strings, which a pid range cannot offset)."""
    with open(path) as f:
        doc = json.load(f)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    events = doc.get("traceEvents", [])
    named = sorted({str(e["pid"]) for e in events
                    if "pid" in e and not isinstance(e["pid"], int)})
    first = 1 + max((e["pid"] for e in events
                     if isinstance(e.get("pid"), int)), default=0)
    pids = {name: first + i for i, name in enumerate(named)}
    for e in events:
        if "pid" in e and not isinstance(e["pid"], int):
            e["pid"] = pids[str(e["pid"])]
        if isinstance(e.get("ts"), (int, float)):
            e["ts"] += base_us
    doc["baseTimeNanoseconds"] = 0
    with open(path, "w") as f:
        json.dump(doc, f)


class _StepRecord:
    """Open bookkeeping for one in-flight step."""

    __slots__ = ("index", "name", "auto", "t0", "t0_epoch", "comm0",
                 "wait0", "phase_seconds", "breakdown")

    def __init__(self, index: int, name: Optional[str], auto: bool):
        self.index = index
        self.name = name or f"step {index}"
        self.auto = auto
        self.t0 = time.perf_counter()
        self.t0_epoch = time.time()
        self.comm0 = executor.comm_totals()
        self.wait0 = _handle_wait_seconds()
        self.phase_seconds = {"host": 0.0, "optimizer": 0.0}
        self.breakdown: Optional[dict] = None  # filled at close


class StepProfiler:
    """Process-wide step profiler (one instance, see ``profiler()``)."""

    def __init__(self) -> None:
        self.enabled = False
        self.dir = ""
        self.history_cap = env.DEFAULT_PROFILE_HISTORY
        self.launch_rank = env._get_int(env.HOROVOD_RANK, 0)
        self.rank = self.launch_rank
        self.device: Optional[torch.device] = None
        self._steps: deque = deque(maxlen=self.history_cap)
        self._trace_events: deque = deque(maxlen=4 * self.history_cap)
        self._mfu_window: deque = deque(maxlen=self.history_cap)
        self._flops_per_step: Optional[float] = None
        self._peak_flops: Optional[float] = None
        self._step_index = 0
        self._active: Optional[_StepRecord] = None  # explicit step() CM
        self._auto_rec: Optional[_StepRecord] = None
        self._nested = 0  # depth of nested(): auto_step is a no-op
        self._dump_lock = threading.Lock()
        self._device_trace = None  # torch.profiler.profile while tracing
        self._profile_state_cache: Optional[Tuple[float, dict]] = None

    # -- configuration ------------------------------------------------------
    def configure(self, rank: Optional[int] = None,
                  device: Optional[torch.device] = None,
                  config: Optional[env.Config] = None) -> None:
        """Re-read the knobs (``init()`` passes its parsed ``Config``, its
        rank and its device). With ``HOROVOD_PROFILE_JAX`` and a profile
        dir this starts the device trace, and raises if it cannot."""
        cfg = config if config is not None else env.Config.from_env()
        self.dir = cfg.profile_dir
        self.enabled = cfg.profile
        cap = max(1, cfg.profile_history)
        if cap != self.history_cap:
            self.history_cap = cap
            self._steps = deque(self._steps, maxlen=cap)
            self._trace_events = deque(self._trace_events, maxlen=4 * cap)
            self._mfu_window = deque(self._mfu_window, maxlen=cap)
        self.launch_rank = env._get_int(env.HOROVOD_RANK, self.launch_rank)
        if rank is not None:
            self.rank = rank
        if device is not None:
            self.device = torch.device(device)
        flight_recorder.set_state_provider(
            "profiler", self._debug_state if self.enabled else None)
        if self.enabled and self.dir and cfg.profile_jax:
            self._start_device_trace()

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _start_device_trace(self) -> None:
        if self._device_trace is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self._on_card():
            acts.append(ProfilerActivity.CUDA)
        trace = profile(activities=acts)
        trace.start()
        self._device_trace = trace

    def _stop_device_trace(self) -> None:
        trace, self._device_trace = self._device_trace, None
        if trace is None:
            return
        try:
            trace.stop()
            out = os.path.join(self.dir, f"jax-rank-{self.launch_rank}",
                               DEVICE_TRACE)
            os.makedirs(os.path.dirname(out), exist_ok=True)
            trace.export_chrome_trace(out)
            _to_merge_form(out)
        except (OSError, RuntimeError, ValueError) as exc:
            log.warning("profiler: device trace not written: %s", exc)

    def set_flops_per_step(self, flops: Optional[float],
                           peak_flops_per_chip: Optional[float] = None
                           ) -> None:
        """Model-FLOPs hint: per-card FLOPs executed by one profiled step
        (forward + backward + update). With a per-card peak the profiler
        keeps the rolling ``horovod_mfu`` gauge; without one MFU stays
        unset."""
        self._flops_per_step = flops
        if peak_flops_per_chip is not None:
            self._peak_flops = peak_flops_per_chip

    # -- step bracketing ----------------------------------------------------
    def _sync(self) -> None:
        """Wait for the card, so a step's boundary is the device's."""
        if self._on_card():
            torch.cuda.synchronize(self.device)

    def auto_step(self) -> None:
        """Implicit step boundary (hooked into ``DistributedOptimizer`` and
        ``training.make_train_step`` / ``make_train_round``): each call
        closes the previous implicit step and opens the next. No-op while
        an explicit step is open, inside :meth:`nested`, or when profiling
        is off."""
        if not self.enabled or self._active is not None or self._nested:
            return
        if self._auto_rec is not None:
            self._finish(self._auto_rec)
        else:
            self._sync()
        self._auto_rec = _StepRecord(self._next_index(), None, auto=True)

    @contextmanager
    def nested(self):
        """The enclosed calls belong to the step already open: their
        ``auto_step()`` calls are no-ops. The training wrappers run their
        callable inside it, so one call of a step or a round is one record,
        as one jitted program is one record in the JAX package (where the
        optimizer's hook is traced and never fires)."""
        self._nested += 1
        try:
            yield
        finally:
            self._nested -= 1

    @contextmanager
    def step(self, name: Optional[str] = None):
        """Bracket one training step; yields the record whose
        ``breakdown`` is filled on exit. Nested use is a no-op on the inner
        level."""
        if not self.enabled or self._active is not None:
            yield None
            return
        if self._auto_rec is not None:  # explicit bracketing wins
            self._finish(self._auto_rec)
            self._auto_rec = None
        else:
            self._sync()
        rec = _StepRecord(self._next_index(), name, auto=False)
        self._active = rec
        tl = self._timeline()
        if tl is not None:
            tl.start("step", f"STEP_{rec.index}")
        try:
            yield rec
        finally:
            self._active = None
            if tl is not None:
                tl.end("step")
            self._finish(rec)

    @contextmanager
    def annotate(self, phase: str):
        """Attribute the enclosed wall time to ``phase`` ("host"/"input"
        for the data pipeline, "optimizer" for the update) within the
        current step. Host time: nothing synchronizes here."""
        key = {"input": "host", "host": "host",
               "optimizer": "optimizer"}.get(phase)
        if key is None:
            raise ValueError(f"unknown profiler phase {phase!r}; expected "
                             "'host', 'input' or 'optimizer'")
        rec = self._active or self._auto_rec
        if not self.enabled or rec is None:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec.phase_seconds[key] += time.perf_counter() - t0

    def _next_index(self) -> int:
        self._step_index += 1
        return self._step_index

    @staticmethod
    def _timeline():
        rt = state_mod.global_state().runtime
        return getattr(rt, "timeline", None)

    # -- attribution --------------------------------------------------------
    def _finish(self, rec: _StepRecord) -> None:
        self._sync()
        wall = max(time.perf_counter() - rec.t0, 1e-9)
        comm1 = executor.comm_totals()
        comm_total = max(0.0, comm1["total_seconds"]
                         - rec.comm0["total_seconds"])
        comm_exposed = max(0.0, comm1["exposed_seconds"]
                           - rec.comm0["exposed_seconds"])
        comm_bytes = max(0, comm1["total_bytes"] - rec.comm0["total_bytes"])
        hidden_bytes = max(0.0, comm1["hidden_bytes"]
                           - rec.comm0["hidden_bytes"])
        comm_ops = max(0, comm1["ops"] - rec.comm0["ops"])
        hidden_fraction = 0.0
        if comm_total > 0.0:
            hidden_fraction = min(1.0, max(0.0,
                                           1.0 - comm_exposed / comm_total))
        hidden_fraction_bytes = 0.0
        if comm_bytes > 0:
            hidden_fraction_bytes = min(1.0, max(0.0,
                                                 hidden_bytes / comm_bytes))

        # annotated host/optimizer + caller-blocked collective time; compute
        # is the remainder, so the four phases sum to the wall time exactly
        # (scaled down proportionally where annotations overlap the wait)
        host = max(0.0, rec.phase_seconds["host"])
        optimizer = max(0.0, rec.phase_seconds["optimizer"])
        exposed_phase = max(0.0, _handle_wait_seconds() - rec.wait0)
        accounted = host + optimizer + exposed_phase
        if accounted > wall and accounted > 0.0:
            scale = wall / accounted
            host *= scale
            optimizer *= scale
            exposed_phase *= scale
            accounted = wall
        phases = {"host": host,
                  "compute": wall - accounted,
                  "exposed_comm": exposed_phase,
                  "optimizer": optimizer}

        mfu = None
        if self._flops_per_step and self._peak_flops:
            mfu = self._flops_per_step / wall / self._peak_flops
            self._mfu_window.append(mfu)
            _MFU.set(sum(self._mfu_window) / len(self._mfu_window))
        _STEP_SECONDS.observe(wall)
        _HIDDEN_FRACTION.set(hidden_fraction)

        # the allocator's high watermark by the end of this step (cumulative:
        # it is not reset per step)
        peak_hbm = (torch.cuda.max_memory_allocated(self.device)
                    if self._on_card() else None)

        rec.breakdown = {
            "step": rec.index,
            "name": rec.name,
            "auto": rec.auto,
            "t_start": rec.t0_epoch,
            "wall_seconds": wall,
            "peak_hbm_bytes": peak_hbm,
            "phases": phases,
            "comm": {"total_seconds": comm_total,
                     "exposed_seconds": comm_exposed,
                     "bytes": comm_bytes,
                     # fused executor dispatches this step
                     "dispatches": comm_ops,
                     "hidden_fraction": hidden_fraction,
                     "hidden_fraction_bytes": hidden_fraction_bytes},
            "mfu": mfu,
        }
        self._steps.append(rec.breakdown)
        # Chrome step marker on the profiler's own lane (epoch us, the
        # runtime timeline's clock domain)
        self._trace_events.append({
            "ph": "X", "pid": 0, "tid": 0, "ts": rec.t0_epoch * 1e6,
            "dur": wall * 1e6, "name": rec.name,
            "args": {"phases_ms": {k: round(v * 1e3, 3)
                                   for k, v in phases.items()},
                     "comm_hidden_fraction": round(hidden_fraction, 4)}})
        flight_recorder.emit(
            "profiler_step", step=rec.index,
            wall_ms=round(wall * 1e3, 3),
            hidden_fraction=round(hidden_fraction, 4))
        # the measured wall is productive time, the exposed-comm phase
        # badput; the ledger's frontier guard dedups against State.commit
        goodput.record_step(wall, exposed_comm=exposed_phase,
                            step=rec.index)

    def _debug_state(self) -> dict:
        """The flight recorder's ``profiler`` state: the recent
        breakdowns ride in every postmortem dump."""
        return {"flops_per_step": self._flops_per_step,
                "peak_flops_per_chip": self._peak_flops,
                "steps": list(self._steps)}

    # -- introspection ------------------------------------------------------
    def history(self) -> List[dict]:
        """The last N completed step breakdowns, oldest first."""
        return list(self._steps)

    def summary(self) -> dict:
        """Aggregate over the step history: mean wall/phase seconds and
        comm-hidden fractions (what the bench embeds per headline)."""
        steps = list(self._steps)
        if not steps:
            return {"steps": 0, "wall_seconds": 0.0,
                    "step_breakdown": {k: 0.0 for k in PHASES},
                    "comm_hidden_fraction": 0.0,
                    "comm_hidden_fraction_bytes": 0.0, "mfu": None}
        n = len(steps)
        breakdown = {k: sum(s["phases"][k] for s in steps) / n
                     for k in PHASES}
        comm_total = sum(s["comm"]["total_seconds"] for s in steps)
        comm_exposed = sum(s["comm"]["exposed_seconds"] for s in steps)
        comm_bytes = sum(s["comm"]["bytes"] for s in steps)
        hidden_bytes = sum(s["comm"]["bytes"]
                           * s["comm"]["hidden_fraction_bytes"]
                           for s in steps)
        mfus = [s["mfu"] for s in steps if s.get("mfu") is not None]
        return {
            "steps": n,
            "wall_seconds": sum(s["wall_seconds"] for s in steps) / n,
            "step_breakdown": breakdown,
            "comm_hidden_fraction": (
                min(1.0, max(0.0, 1.0 - comm_exposed / comm_total))
                if comm_total > 0 else 0.0),
            "comm_hidden_fraction_bytes": (
                min(1.0, max(0.0, hidden_bytes / comm_bytes))
                if comm_bytes > 0 else 0.0),
            "mfu": (sum(mfus) / len(mfus)) if mfus else None,
        }

    def profile_state(self) -> dict:
        """Document for the metrics endpoint's ``GET /profile``. At most
        one fresh snapshot a second, cached in between, so a scrape loop
        cannot contend with the training loop."""
        now = time.monotonic()
        cached = self._profile_state_cache
        if cached is not None and now - cached[0] < 1.0:
            return cached[1]
        state = {"schema": SCHEMA, "rank": self.rank,
                 "launch_rank": self.launch_rank, "enabled": self.enabled,
                 "summary": self.summary(), "steps": self.history()}
        self._profile_state_cache = (now, state)
        return state

    # -- dump ---------------------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "schema": SCHEMA,
            "rank": self.rank,
            "launch_rank": self.launch_rank,
            "pid": os.getpid(),
            "host": socket.gethostname(),
            "wall_time": time.time(),
            "clock_offset_seconds": flight_recorder.recorder().clock_offset(),
            "flops_per_step": self._flops_per_step,
            "peak_flops_per_chip": self._peak_flops,
            "steps": list(self._steps),
            "trace_events": list(self._trace_events),
            "memory_samples": memory.tracker().samples(),
            "request_spans": tracing.spans(),
            "comms_samples": comms.tracker().samples(),
            "goodput_samples": goodput.tracker().samples(),
            "goodput_incidents": goodput.tracker().incidents(),
            "flight_events": flight_recorder.recorder().events()
            [-_FLIGHT_TRACE_EVENTS:],
        }

    def dump(self, path: Optional[str] = None) -> dict:
        """Write ``profile-rank-N.json`` (to ``path`` or the configured
        dir), after closing an open implicit step and writing the device
        trace. Never raises on a write: it runs from ``shutdown()``."""
        with self._dump_lock:
            if self._auto_rec is not None:
                self._finish(self._auto_rec)
                self._auto_rec = None
            self._stop_device_trace()
            snap = self.snapshot()
            target = path or self.dir
            if target:
                try:
                    out = target if target.endswith(".json") else \
                        os.path.join(target,
                                     f"{DUMP_PREFIX}{self.launch_rank}.json")
                    parent = os.path.dirname(out)
                    if parent:
                        os.makedirs(parent, exist_ok=True)
                    with open(out, "w") as f:
                        json.dump(snap, f)
                    log.debug("profiler: wrote %s", out)
                except OSError as exc:
                    log.warning("profiler: dump to %r failed: %s",
                                target, exc)
            try:
                self._ship(json.dumps(snap))
            except Exception as exc:  # a dump never raises
                log.debug("profiler: ship failed: %s", exc)
            return snap

    def _ship(self, payload: str) -> None:
        dest = flight_recorder._rendezvous_addr()
        if dest is None:
            return
        from horovod_tpu_torch.run.rendezvous import KVStoreClient
        from horovod_tpu_torch.utils import resilience

        client = KVStoreClient(
            dest[0], dest[1], scope=RENDEZVOUS_SCOPE, timeout=5.0,
            retry=resilience.RetryPolicy.from_env("profile", deadline=5.0))
        client.set("rank.%d" % self.launch_rank, payload.encode())

    def finalize(self) -> None:
        """Shutdown hook (``core/basics.py``): dump when enabled."""
        if self.enabled:
            self.dump()


_profiler = StepProfiler()


def profiler() -> StepProfiler:
    return _profiler


def configure(rank: Optional[int] = None,
              device: Optional[torch.device] = None,
              config: Optional[env.Config] = None) -> None:
    _profiler.configure(rank=rank, device=device, config=config)


def enabled() -> bool:
    return _profiler.enabled


def step(name: Optional[str] = None):
    """``with hvd.profiler.step(): ...``: bracket one training step."""
    return _profiler.step(name)


def annotate(phase: str):
    """``with hvd.profiler.annotate("host"): ...``: attribute wall time."""
    return _profiler.annotate(phase)


def auto_step() -> None:
    _profiler.auto_step()


def nested():
    """``with hvd.profiler.nested(): ...``: the enclosed ``auto_step()``
    calls are no-ops (the caller's step is open)."""
    return _profiler.nested()


def set_flops_per_step(flops: Optional[float],
                       peak_flops_per_chip: Optional[float] = None) -> None:
    _profiler.set_flops_per_step(flops,
                                 peak_flops_per_chip=peak_flops_per_chip)


def history() -> List[dict]:
    return _profiler.history()


def summary() -> dict:
    return _profiler.summary()


def profile_state() -> dict:
    return _profiler.profile_state()


def dump(path: Optional[str] = None) -> dict:
    return _profiler.dump(path=path)


def finalize() -> None:
    _profiler.finalize()


# ---------------------------------------------------------------------------
# Harvest, merge, report
# ---------------------------------------------------------------------------

def load_dumps(directory: str) -> List[dict]:
    """Read every ``profile-rank-*.json`` in ``directory`` (unreadable
    files are skipped: a killed worker may have cut one short)."""
    dumps = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return dumps
    for name in names:
        if not (name.startswith(DUMP_PREFIX) and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                dumps.append(json.load(f))
        except (OSError, ValueError) as exc:
            log.warning("profiler: skipping unreadable dump %s: %s",
                        path, exc)
    return dumps


def _flight_trace_events(dump: dict) -> List[dict]:
    """Flight-recorder events as Chrome instants on their own lane (tid
    1), epoch-us clock."""
    out = []
    for ev in dump.get("flight_events", ()):
        t = ev.get("t")
        if not isinstance(t, (int, float)):
            continue
        args = {k: v for k, v in ev.items() if k not in ("t", "kind")}
        out.append({"ph": "i", "pid": 0, "tid": 1, "ts": t * 1e6,
                    "name": str(ev.get("kind", "event")), "s": "t",
                    "args": args or None})
    return out


def _memory_trace_events(dump: dict) -> List[dict]:
    """The memory sampler's trail as a Chrome counter ("C") track."""
    out = []
    for row in dump.get("memory_samples", ()):
        try:
            t, claimed, actual = row[0], int(row[1]), int(row[2])
        except (TypeError, ValueError, IndexError):
            continue
        if not isinstance(t, (int, float)):
            continue
        out.append({"ph": "C", "pid": 0, "tid": 0, "ts": t * 1e6,
                    "name": "device memory (bytes)",
                    "args": {"claimed": claimed, "actual": actual}})
    return out


def _comms_trace_events(dump: dict) -> List[dict]:
    """The comms tracker's bus-bandwidth samples as a Chrome counter
    track."""
    out = []
    for row in dump.get("comms_samples", ()):
        try:
            t, busbw, lane = row[0], float(row[1]), str(row[2])
        except (TypeError, ValueError, IndexError):
            continue
        if not isinstance(t, (int, float)):
            continue
        out.append({"ph": "C", "pid": 0, "tid": 0, "ts": t * 1e6,
                    "name": "bus bandwidth (GB/s)",
                    "args": {lane: round(busbw, 4)}})
    return out


def _goodput_trace_events(dump: dict) -> List[dict]:
    """The goodput fraction as a counter track and its incidents as an
    instant lane."""
    out = []
    for row in dump.get("goodput_samples", ()):
        try:
            t, frac = row[0], float(row[1])
        except (TypeError, ValueError, IndexError):
            continue
        if not isinstance(t, (int, float)):
            continue
        out.append({"ph": "C", "pid": 0, "tid": 0, "ts": t * 1e6,
                    "name": "goodput fraction",
                    "args": {"productive": round(frac, 4)}})
    for inc in dump.get("goodput_incidents", ()):
        if not isinstance(inc, dict):
            continue
        t = inc.get("wall_time")
        if not isinstance(t, (int, float)):
            continue
        out.append({"ph": "i", "pid": 0, "tid": 1, "ts": t * 1e6,
                    "s": "t",
                    "name": "incident: %s" % inc.get("cause", "?"),
                    "args": {k: inc.get(k) for k in
                             ("duration_s", "generation", "culprit_rank",
                              "steps_replayed")}})
    return out


def _device_trace_files(directory: str) -> List[str]:
    """Device traces below the profile dir (the port's
    ``jax-rank-N/device.trace.json``; the JAX package's TensorBoard
    ``*.trace.json.gz``)."""
    hits = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json"):
        hits.extend(glob.glob(os.path.join(directory, pat), recursive=True))
    return sorted(set(hits))


def _rank_of_path(path: str) -> Optional[int]:
    base = os.path.basename(path)
    for token in (os.sep.join(path.split(os.sep)[-3:]).split(os.sep)
                  + [base]):
        for prefix in ("timeline-rank-", "jax-rank-"):
            if token.startswith(prefix):
                digits = token[len(prefix):].split(".")[0]
                try:
                    return int(digits)
                except ValueError:
                    continue
    return None


def merge_profile_dir(directory: str,
                      out_path: Optional[str] = None) -> Tuple[str, int]:
    """Build ONE Chrome trace from everything profiling left in
    ``directory``: each rank's step markers (and the other planes' events)
    from its dump, the runtimes' ``timeline-rank-N.json`` and any device
    traces below it. Each rank's events are shifted by its dump's clock
    offset; each source gets a private pid range labeled ``rank N
    <kind>``; one request's spans across lanes are joined by flow arrows.
    Returns (path, event count)."""
    dumps = load_dumps(directory)
    offsets: Dict[int, float] = {}
    lanes: List[Tuple[str, List[dict], float]] = []  # (label, events, off_s)
    for d in dumps:
        rank = d.get("launch_rank", d.get("rank", 0))
        offset = d.get("clock_offset_seconds") or 0.0
        offsets[rank] = offset
        events = [e for e in d.get("trace_events", ())
                  if isinstance(e, dict)]
        events += _flight_trace_events(d)
        events += _memory_trace_events(d)
        events += _comms_trace_events(d)
        events += _goodput_trace_events(d)
        if events:
            lanes.append((f"rank {rank} steps", events, offset))
        spans = [s for s in d.get("request_spans", ())
                 if isinstance(s, dict)]
        if spans:
            lanes.append((f"rank {rank} requests",
                          tracing.spans_to_chrome(spans), offset))
    for path in sorted(glob.glob(os.path.join(directory,
                                              "timeline-rank-*.json"))):
        rank = _rank_of_path(path)
        try:
            events = timeline_mod._load_trace_events(path)
        except (OSError, ValueError) as exc:
            log.warning("profiler: skipping unreadable trace %s: %s",
                        path, exc)
            continue
        lanes.append((f"rank {rank} timeline", events,
                      offsets.get(rank, 0.0)))
    for path in _device_trace_files(directory):
        rank = _rank_of_path(path)
        try:
            events = timeline_mod._load_trace_events(path)
        except (OSError, ValueError) as exc:
            log.warning("profiler: skipping unreadable trace %s: %s",
                        path, exc)
            continue
        lanes.append((f"rank {rank} device" if rank is not None
                      else os.path.basename(path), events,
                      offsets.get(rank, 0.0)))

    merged: List[dict] = []
    anchors: List[dict] = []   # corrected-clock request-span coordinates
    pid_base = 0
    for label, events, offset_s in lanes:
        pids = [e.get("pid", 0) for e in events]
        for orig_pid in sorted(set(pids)):
            merged.append({"ph": "M", "pid": orig_pid + pid_base, "ts": 0,
                           "name": "process_labels",
                           "args": {"labels": label}})
        off_us = offset_s * 1e6
        for e in events:
            e = dict(e)
            e["pid"] = e.get("pid", 0) + pid_base
            if isinstance(e.get("ts"), (int, float)) and e.get("ph") != "M":
                e["ts"] = e["ts"] + off_us
            merged.append(e)
            if e.get("ph") == "X" and e.get("cat") == "request":
                trace_id = (e.get("args") or {}).get("trace_id")
                if trace_id:
                    anchors.append({"trace_id": trace_id, "pid": e["pid"],
                                    "tid": e.get("tid", 0), "ts": e["ts"],
                                    "dur": e.get("dur", 0.0)})
        pid_base += max(pids, default=0) + 2
    # flow arrows bind to their enclosing slices by exact (pid, tid, ts),
    # which exist only once every lane has its pid range and clock
    merged.extend(tracing.flow_events(anchors))
    merged.sort(key=lambda e: (e.get("ts") or 0))
    out = out_path or os.path.join(directory, MERGED_TRACE)
    with open(out, "w") as f:
        json.dump({"traceEvents": merged}, f)
    return out, len(merged)


def format_step_report(dumps: List[dict]) -> str:
    """Cross-rank step-time report: per-rank mean wall + phase means, and
    a verdict naming the slowest rank and its dominant phase."""
    lines = ["=== step-time report (%d rank%s) ==="
             % (len(dumps), "" if len(dumps) == 1 else "s")]
    slowest: Optional[Tuple[Any, float, dict]] = None
    for d in sorted(dumps, key=lambda d: d.get("launch_rank", 0)):
        rank = d.get("launch_rank", d.get("rank", "?"))
        steps = d.get("steps", ())
        if not steps:
            lines.append(f"rank {rank}: no profiled steps")
            continue
        n = len(steps)
        wall = sum(s["wall_seconds"] for s in steps) / n
        phases = {k: sum(s["phases"].get(k, 0.0) for s in steps) / n
                  for k in PHASES}
        hidden = [s["comm"]["hidden_fraction"] for s in steps
                  if s.get("comm")]
        mfus = [s["mfu"] for s in steps if s.get("mfu") is not None]
        lines.append(
            "rank %s: %d steps, mean %.3f ms/step  "
            "(host %.3f, compute %.3f, exposed_comm %.3f, optimizer %.3f)"
            "  comm_hidden=%.1f%%%s" % (
                rank, n, wall * 1e3, phases["host"] * 1e3,
                phases["compute"] * 1e3, phases["exposed_comm"] * 1e3,
                phases["optimizer"] * 1e3,
                100.0 * (sum(hidden) / len(hidden) if hidden else 0.0),
                ("  mfu=%.3f" % (sum(mfus) / len(mfus))) if mfus else ""))
        if slowest is None or wall > slowest[1]:
            slowest = (rank, wall, phases)
    if slowest is not None:
        rank, wall, phases = slowest
        phase = max(phases, key=lambda k: phases[k])
        lines.append(
            "slowest: rank %s at %.3f ms/step, dominant phase: %s "
            "(%.3f ms, %.1f%% of step)" % (
                rank, wall * 1e3, phase, phases[phase] * 1e3,
                100.0 * phases[phase] / wall if wall else 0.0))
    return "\n".join(lines)
