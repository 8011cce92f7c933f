"""Process-wide runtime metrics: counters, gauges and fixed-bucket
histograms with Prometheus exposition (port of ``horovod_tpu/metrics.py``:
the same families, text, dumps and summary, byte for byte).

The quantitative view of the runtime beside the Chrome-trace timeline
(``timeline.py``) and the stall inspector (``stall.py``): where the
timeline answers "what happened to tensor X at time T", this answers "what
is the cache hit rate, the fusion buffers' fill, the cycle latency
distribution, the bytes each collective moved".

Design constraints:

* **No lock on the hot path.** An observation is a plain int, float or
  list update (a counter's ``inc`` is one add; a histogram's ``observe`` a
  bisect and two adds). Under CPython a rare lost increment is acceptable
  for monitoring data; a lock on every enqueued tensor is not. Locks guard
  only the creation of a family or child and a snapshot's iteration.
* **No cost when idle.** No thread, socket or file exists unless
  ``HOROVOD_METRICS_PORT`` or ``HOROVOD_METRICS_DUMP`` asks for one.

Consumers (wired in ``core/basics.py`` and ``runtime/runtime.py``):

* ``hvd.metrics()``: the snapshot, a JSON-serializable nested dict;
* ``HOROVOD_METRICS_PORT``: Prometheus text over the standard library's
  ``http.server`` on a daemon thread, ``GET /metrics`` (and ``/``,
  ``/debug/routes``, ``/profile``, ``/healthz``);
* the timeline's ``"C"`` counter events, one set each cycle;
* ``HOROVOD_METRICS_DUMP``: this rank's snapshot as JSON at
  ``hvd.shutdown()``; :func:`summarize_dumps` and :func:`format_summary`
  make the cross-rank min/median/max table of several ranks' dumps.

The instruments, each with the JAX package's name, help text and buckets:
``runtime/runtime.py`` (cycles, cycle duration, tensors a cycle, handle
wait, pipeline depth), ``runtime/tensor_queue.py`` (depth, enqueued),
``runtime/response_cache.py`` (hits, misses, invalidations),
``runtime/fusion.py`` (batches, tensors, bytes, buffer utilization),
``runtime/fusion_buffer.py`` (slab allocations and reuses, bytes, live
bytes and leases out, purpose ``fusion``), ``runtime/executor.py`` (op
duration, bytes and errors by op, comm exposed seconds), ``stall.py``
(warnings, shutdowns, straggler lag, negotiation skew) and ``timeline.py``
(dropped events), ``profiler.py`` (step seconds, comm hidden fraction,
MFU) and ``integrity/guards.py`` (skipped steps).

Not ported: ``horovod_autotune_param`` and ``horovod_autotune_commits_
total`` wait for the autotuner (ROADMAP A8);
``horovod_executor_program_compiles_total`` and ``_program_cache_hits_
total`` count compiled XLA programs and ``horovod_executor_pad_bytes_total``
their bucket padding, none of which the port has (NCCL compiles nothing
and the port sends no pad). The families of the flight recorder, tracing,
comms, memory, goodput, serving and elastic planes come with those planes
(A10-A12).
"""

from __future__ import annotations

import json
import os
import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

# Default latency buckets (seconds): 100us .. 10s, roughly log-spaced.
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 10.0)
# Count buckets (tensors per cycle and similar small cardinalities).
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0)
# Ratio buckets (utilization in [0, 1]; >1 spills to +Inf).
RATIO_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

# Every route the HTTP endpoint serves, with a one-line description: the
# payload of GET / and GET /debug/routes. The JAX package's other routes
# (/debug, /serve, /memory, /comms, /slo, /goodput) come with the planes
# that back them.
HTTP_ROUTES: Dict[str, str] = {
    "/metrics": "Prometheus text exposition of every registered family",
    "/debug/routes": "this route index",
    "/profile": "step-profiler phase breakdowns and summary",
    "/healthz": "readiness gate (200 once init ran)",
}


def route_index() -> dict:
    """The JSON document served at ``GET /`` and ``/debug/routes``."""
    return {"routes": dict(HTTP_ROUTES)}


class Counter:
    """Monotonic counter; ``inc`` is the whole hot path."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: float = 1) -> None:
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (queue depth, buffer fill, ...)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` semantics: bucket i
    counts observations ``v <= bounds[i]``; an implicit +Inf bucket
    catches the rest. Exposition renders the counts cumulatively."""

    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]) -> None:
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def snapshot(self):
        cum = 0
        buckets = []
        for bound, c in zip(self.bounds, self.counts):
            cum += c
            buckets.append([bound, cum])
        buckets.append(["+Inf", cum + self.counts[-1]])
        return {"count": self.count, "sum": self.sum, "buckets": buckets}


class _Family:
    """One named metric family; holds one child per label-value set (the
    empty set for unlabeled metrics). Child creation is locked; child
    lookup on the hot path is a plain dict get."""

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 factory) -> None:
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self._factory = factory
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not labelnames:
            self._children[()] = factory()

    @property
    def kind(self) -> str:
        with self._lock:
            if self._children:
                return next(iter(self._children.values())).kind
        return self._factory().kind

    def labels(self, **labelvalues):
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._factory())
        return child

    # unlabeled convenience: family proxies its single child
    def inc(self, n: float = 1) -> None:
        self._children[()].inc(n)

    def set(self, v: float) -> None:
        self._children[()].set(v)

    def dec(self, n: float = 1) -> None:
        self._children[()].dec(n)

    def observe(self, v: float) -> None:
        self._children[()].observe(v)

    @property
    def value(self):
        return self._children[()].value

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Create-once registry of metric families + the optional HTTP
    exposition endpoint. One process-wide instance (``registry()``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: "Dict[str, _Family]" = {}
        self._http: Optional[tuple] = None  # (server, thread)

    # -- metric creation (idempotent by name) ------------------------------
    def _family(self, name: str, help: str, labelnames, factory) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help, tuple(labelnames), factory)
                self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, help, labelnames, Counter)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, help, labelnames, Gauge)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS,
                  labelnames: Sequence[str] = ()) -> _Family:
        b = tuple(buckets)
        return self._family(name, help, labelnames, lambda: Histogram(b))

    # -- snapshot ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Nested JSON-serializable dict of every family and child."""
        with self._lock:
            families = list(self._families.values())
        out = {}
        for fam in families:
            values = []
            for key, child in fam.children():
                values.append({
                    "labels": dict(zip(fam.labelnames, key)),
                    "value": child.snapshot(),
                })
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": values}
        return out

    # -- Prometheus exposition --------------------------------------------
    def prometheus_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in families:
            children = fam.children()
            if not children:
                continue
            kind = children[0][1].kind
            if fam.help:
                lines.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.name} {kind}")
            for key, child in children:
                labels = list(zip(fam.labelnames, key))
                if kind == "histogram":
                    snap = child.snapshot()
                    for bound, cum in snap["buckets"]:
                        le = bound if isinstance(bound, str) \
                            else _fmt_value(bound)
                        lines.append(
                            f"{fam.name}_bucket"
                            f"{_fmt_labels(labels + [('le', le)])} {cum}")
                    lines.append(f"{fam.name}_sum{_fmt_labels(labels)} "
                                 f"{_fmt_value(snap['sum'])}")
                    lines.append(f"{fam.name}_count{_fmt_labels(labels)} "
                                 f"{snap['count']}")
                else:
                    lines.append(f"{fam.name}{_fmt_labels(labels)} "
                                 f"{_fmt_value(child.value)}")
        return "\n".join(lines) + "\n"

    # -- HTTP endpoint (HOROVOD_METRICS_PORT) ------------------------------
    def serve(self, port: int) -> int:
        """Start (or return) the /metrics endpoint on a daemon thread;
        returns the bound port (useful with port 0)."""
        with self._lock:
            if self._http is not None:
                return self._http[0].server_address[1]
        import http.server

        reg = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                route = self.path.split("?")[0].rstrip("/")
                if route == "/metrics":
                    body = reg.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif route in ("", "/debug/routes"):
                    # route index: which surfaces this endpoint serves,
                    # so tooling discovers them instead of probing 404s
                    body = json.dumps(route_index(), default=repr).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif route == "/profile":
                    # step-profiler state: the last N breakdowns and the
                    # summary (a rate-limited snapshot, see
                    # profiler.profile_state)
                    from horovod_tpu_torch import profiler

                    body = json.dumps(profiler.profile_state(),
                                      default=repr).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif route == "/healthz":
                    # readiness gate for external load balancers: 200
                    # only once hvd.init() ran
                    state = healthz_state()
                    body = json.dumps(state).encode()
                    self.send_response(200 if state["ready"] else 503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_error(404)

            def log_message(self, *args):  # keep worker logs clean
                pass

        server = http.server.ThreadingHTTPServer(("", port), Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True,
                                  name="hvd-metrics-http")
        thread.start()
        with self._lock:
            self._http = (server, thread)
        return server.server_address[1]

    @property
    def http_port(self) -> Optional[int]:
        with self._lock:
            return None if self._http is None \
                else self._http[0].server_address[1]

    def stop_server(self) -> None:
        with self._lock:
            http, self._http = self._http, None
        if http is not None:
            server, thread = http
            server.shutdown()
            server.server_close()
            thread.join(timeout=5.0)

    # -- per-rank dump (HOROVOD_METRICS_DUMP) ------------------------------
    def dump(self, path: str, rank: int = 0) -> str:
        """Write this rank's snapshot as JSON. ``path`` may contain a
        ``{rank}`` placeholder or name a ``.json`` file directly; anything
        else is treated as a directory receiving
        ``metrics-rank-<rank>.json``. Returns the written path."""
        if "{rank}" in path:
            out = path.format(rank=rank)
        elif path.endswith(".json"):
            out = path
        else:
            os.makedirs(path, exist_ok=True)
            out = os.path.join(path, f"metrics-rank-{rank}.json")
        parent = os.path.dirname(out)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(out, "w") as f:
            json.dump({"rank": rank, "metrics": self.snapshot()}, f)
        return out

    def reset(self) -> None:
        """Stop the endpoint and drop every family (for a registry of its
        own; the process-wide one's counters last as long as the
        process)."""
        self.stop_server()
        with self._lock:
            self._families.clear()


def _fmt_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _fmt_value(v) -> str:
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


_registry = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _registry


def healthz_state() -> dict:
    """``GET /healthz``: ready (200) once ``hvd.init()`` has run and until
    ``hvd.shutdown()``, else 503."""
    from horovod_tpu_torch.core import state

    ready = state.global_state().initialized
    return {"ready": ready, "initialized": ready}


# ---------------------------------------------------------------------------
# Cross-rank aggregation of the per-rank dumps
# ---------------------------------------------------------------------------

def flatten_snapshot(snap: dict) -> Dict[str, float]:
    """Scalar leaves of a snapshot: counters/gauges become
    ``name{labels}``; histograms contribute ``.count``/``.sum``/``.mean``."""
    flat: Dict[str, float] = {}
    for name, fam in snap.items():
        for entry in fam.get("values", []):
            labels = entry.get("labels") or {}
            key = name
            if labels:
                inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                key = f"{name}{{{inner}}}"
            v = entry.get("value")
            if isinstance(v, dict):  # histogram
                count, total = v.get("count", 0), v.get("sum", 0.0)
                flat[key + ".count"] = count
                flat[key + ".sum"] = total
                if count:
                    flat[key + ".mean"] = total / count
            elif isinstance(v, (int, float)):
                flat[key] = v
    return flat


def summarize_dumps(paths: Sequence[str]) -> List[tuple]:
    """Aggregate per-rank JSON dumps into (metric, min, median, max) rows,
    sorted by metric name. A metric missing from some ranks aggregates
    over the ranks that reported it."""
    import statistics

    per_rank = []
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        per_rank.append(flatten_snapshot(data.get("metrics", data)))
    keys = sorted(set().union(*per_rank)) if per_rank else []
    rows = []
    for k in keys:
        vals = [flat[k] for flat in per_rank if k in flat]
        rows.append((k, min(vals), statistics.median(vals), max(vals)))
    return rows


def format_summary(rows: List[tuple], n_ranks: int) -> str:
    """Render summarize_dumps rows as an aligned min/median/max table."""
    header = ("metric", "min", "median", "max")
    body = [(name, _fmt_value(lo), _fmt_value(mid), _fmt_value(hi))
            for name, lo, mid, hi in rows]
    width0 = max([len(header[0])] + [len(r[0]) for r in body])
    widths = [max([len(header[i])] + [len(r[i]) for r in body])
              for i in (1, 2, 3)]
    lines = [f"cross-rank metrics summary ({n_ranks} rank"
             f"{'s' if n_ranks != 1 else ''})"]
    fmt = "{:<%d}  {:>%d}  {:>%d}  {:>%d}" % (width0, *widths)
    lines.append(fmt.format(*header))
    lines.extend(fmt.format(*r) for r in body)
    return "\n".join(lines)
