"""Memory ledger: bytes a subsystem, the device's own figures, and OOM
records (port of ``horovod_tpu/memory.py``: the same knobs, subsystems,
metric families, ledger keys and report).

The time planes say where the time went; this one says where the bytes
went. One process-wide :class:`MemoryTracker` keeps the live bytes and the
high watermark of each subsystem that holds bytes:

* ``params`` and ``grads``, pushed by ``DistributedOptimizer.step``
  (``parallel/dp.py``);
* ``optimizer_shards``, pushed by ZeRO's optimizer states
  (``parallel/zero.py``: the flat AdamW master and moments, or the inner
  optimizer's state over the shards);
* ``grad_shards`` and ``param_shards``, pushed by ZeRO stages 2 and 3;
* ``fusion``, pulled from the fusion-buffer slab registry
  (``runtime/fusion_buffer.bytes_by_purpose``: slabs on the card, outside
  the reconciliation set as in the JAX package, so they show in the
  drift);
* ``ckpt_staging``, pulled from the checkpoint writer's host slabs
  (``ckpt/writer.staging_bytes``, pinned host memory on the card's path);
* ``serve_kv`` and ``kv_pages``, pulled from the serving plane's live
  engines (``serve/kv_cache.total_cache_bytes``, the dense caches, and
  ``serve/paging.total_pool_bytes``, the page pools);
* ``host_rss``, the process's VmRSS from ``/proc/self/status``.

The claimed device bytes are reconciled against the device's own figures
on a sampling cadence (``HOROVOD_MEMORY_SAMPLE_SECONDS``). On the card
those are the CUDA caching allocator's (``torch.cuda.memory_stats``):
``allocated_bytes.all.current`` and ``.peak`` under the JAX package's
names ``bytes_in_use`` and ``peak_bytes_in_use``, the card's total from
``torch.cuda.mem_get_info`` as ``bytes_limit``, and the allocator's
reserved bytes beside them (``bytes_reserved``, ``peak_bytes_reserved``).
The reconciliation reads allocated bytes, not reserved ones: the
allocator rounds each block up and keeps freed blocks cached, and the
pinned host slabs are no device bytes at all. On the CPU there is no
allocator to read: the device figures are ``{}`` (as the JAX package's are
on a backend without stats), the drift gauge stays unset and the ledger
stands alone. Torch keeps no registry of live tensors, so the device's
``live_array_bytes`` is 0 and :meth:`MemoryTracker.top_live_arrays` walks
the garbage collector's objects for tensors on the tracker's device: only
for a dump, ``GET /memory`` or an OOM, never each step. Views of one
storage are one entry, counted once.

Surfaces: the ``horovod_memory_*`` families and ``GET /memory``; the
``memory`` state provider of every flight-recorder dump; the profiler's
``peak_hbm_bytes`` a step and its memory counter track; an OOM record
(:func:`is_oom`, :func:`record_oom` at the executor and the elastic
boundaries: the ledger and the largest live tensors with their owners);
and :func:`format_memory_report`, the postmortem's section naming the
dominant subsystem and the rank nearest its ceiling.

Knobs: ``HOROVOD_MEMORY`` (accounting on/off, default on),
``HOROVOD_MEMORY_SAMPLE_SECONDS`` (the sampler's cadence, default 10; the
sampler runs only for a CUDA device, where there is an allocator to
reconcile against), ``HOROVOD_MEMORY_TOPK`` (live tensors in an OOM
record, default 8).
"""

from __future__ import annotations

import gc
import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import torch

from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log

HOROVOD_MEMORY = env.HOROVOD_MEMORY
HOROVOD_MEMORY_SAMPLE_SECONDS = env.HOROVOD_MEMORY_SAMPLE_SECONDS
HOROVOD_MEMORY_TOPK = env.HOROVOD_MEMORY_TOPK

DEFAULT_SAMPLE_SECONDS = 10.0
DEFAULT_TOPK = 8
_SAMPLE_RING = 512  # bounded: ~85 min of samples at the default cadence

_BYTES = _metrics().gauge(
    "horovod_memory_bytes",
    "Live bytes claimed per subsystem (params, grads, param_shards, "
    "grad_shards, optimizer_shards, fusion, ckpt_staging, serve_kv, "
    "kv_pages, program_cache, host_rss).",
    labelnames=("subsystem",))
_PEAK_BYTES = _metrics().gauge(
    "horovod_memory_peak_bytes",
    "High watermark of the per-subsystem live bytes since process start.",
    labelnames=("subsystem",))
_DEVICE_BYTES = _metrics().gauge(
    "horovod_memory_device_bytes_in_use",
    "Device truth: bytes_in_use from jax.Device.memory_stats() (or the "
    "jax.live_arrays() sum where the backend reports no stats).")
_DEVICE_PEAK = _metrics().gauge(
    "horovod_memory_device_peak_bytes",
    "Device truth: peak_bytes_in_use high watermark.")
_DEVICE_LIMIT = _metrics().gauge(
    "horovod_memory_device_limit_bytes",
    "Device HBM ceiling (bytes_limit from memory_stats; 0 when the "
    "backend does not report one).")
_HOST_RSS = _metrics().gauge(
    "horovod_memory_host_rss_bytes",
    "Process resident set size (VmRSS from /proc/self/status).")
_DRIFT = _metrics().gauge(
    "horovod_memory_reconcile_drift_ratio",
    "Relative drift between claimed device-resident bytes and device "
    "truth: (actual - claimed) / actual. Accounting rot is a metric.")
_SAMPLES = _metrics().counter(
    "horovod_memory_samples_total",
    "Reconciliation sweeps completed by the memory sampler.")
_OOMS = _metrics().counter(
    "horovod_memory_oom_total",
    "RESOURCE_EXHAUSTED errors caught and turned into forensics dumps.")

# subsystems whose bytes live in device memory: the reconciliation set;
# the rest is host memory (checkpoint staging, host_rss) or the runtime's
# own slabs (fusion)
DEVICE_SUBSYSTEMS = ("params", "grads", "param_shards", "grad_shards",
                     "optimizer_shards", "serve_kv", "kv_pages")


def host_rss_bytes() -> int:
    """VmRSS of this process, 0 where /proc is not there."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 0


def device_memory_stats(device=None) -> Dict[str, int]:
    """The CUDA caching allocator's figures for ``device`` under the JAX
    package's names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``) and the reserved bytes beside them; ``{}`` for the
    CPU or where no card is visible."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda" \
            or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    _free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(total),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "peak_bytes_reserved": int(stats.get("reserved_bytes.all.peak", 0)),
    }


def _storage(t: torch.Tensor):
    """(key, bytes) of the storage behind ``t``: one key a storage, so that
    views of it count once (a meta or a sparse tensor has none: its own
    identity stands in)."""
    if t.layout == torch.sparse_coo:
        return ("own", id(t)), int(t._indices().nbytes + t._values().nbytes)
    if t.device.type == "meta" or t.layout != torch.strided:
        return ("own", id(t)), (int(t.nbytes) if t.layout == torch.strided
                                else 0)
    st = t.untyped_storage()
    return (t.device, st.data_ptr()), int(st.nbytes())


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` itself (a sparse tensor's indices and values)."""
    if t.layout == torch.strided:
        return int(t.nbytes)
    return _storage(t)[1]


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, lists and tuples."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return out


def tree_bytes(tree) -> int:
    """Bytes held by the tensors of ``tree``, each storage once."""
    return sum(dict(_storage(t) for t in tree_tensors(tree)).values())


class MemoryTracker:
    """Process-wide byte ledger: pushed gauges, polled providers,
    watermarks, a reconciliation sampler, and the last OOM record."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._claimed: Dict[str, int] = {}       # guarded-by: _lock
        self._peaks: Dict[str, int] = {}         # guarded-by: _lock
        self._providers: Dict[str, Callable[[], int]] = {}  # guarded-by: _lock
        # id -> (weakref, subsystem) of adopted tensors; the weakref's
        # callback drops a freed tensor
        self._owned: Dict[int, Any] = {}         # guarded-by: _lock
        self._samples: deque = deque(maxlen=_SAMPLE_RING)  # guarded-by: _lock
        self._last_oom: Optional[dict] = None    # guarded-by: _lock
        self._sampler: Optional[threading.Thread] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self.enabled = True   # accounting; the sampler thread is separate
        self.rank = env._get_int(env.HOROVOD_RANK, 0)
        self.device: Optional[torch.device] = None
        self.sample_seconds = DEFAULT_SAMPLE_SECONDS
        self.topk = DEFAULT_TOPK

    # -- accounting (push) -------------------------------------------------
    def set_bytes(self, subsystem: str, nbytes: int) -> None:
        """Record ``subsystem``'s live bytes and roll its peak."""
        if not self.enabled:
            return
        nbytes = int(nbytes)
        with self._lock:
            self._claimed[subsystem] = nbytes
            peak = self._peaks.get(subsystem, 0)
            if nbytes > peak:
                peak = nbytes
                self._peaks[subsystem] = peak
        _BYTES.labels(subsystem=subsystem).set(nbytes)
        _PEAK_BYTES.labels(subsystem=subsystem).set(peak)

    def note_tree_bytes(self, subsystem: str, tree) -> None:
        """``set_bytes`` over the tensors of ``tree``, each storage once
        (sizes only: nothing is read from the device)."""
        if not self.enabled:
            return
        self.set_bytes(subsystem, tree_bytes(tree))

    # -- accounting (pull) -------------------------------------------------
    def register(self, subsystem: str,
                 fn: Optional[Callable[[], int]]) -> None:
        """Register a live-bytes provider polled at each sample and
        snapshot; ``None`` unregisters. Providers run outside the
        tracker's lock."""
        with self._lock:
            if fn is None:
                self._providers.pop(subsystem, None)
            else:
                self._providers[subsystem] = fn

    # -- ownership ---------------------------------------------------------
    def adopt(self, subsystem: str, tree, replace: bool = False) -> None:
        """Tag the tensors of ``tree`` as owned by ``subsystem``, so that
        :meth:`top_live_arrays` names them. By weakref: a freed tensor
        leaves by itself. ``replace`` first drops the subsystem's earlier
        tensors (a re-slice or a re-init made new ones)."""
        if not self.enabled:
            return
        tensors = tree_tensors(tree)
        with self._lock:
            if replace:
                for key in [k for k, (_r, s) in self._owned.items()
                            if s == subsystem]:
                    del self._owned[key]
        for t in tensors:
            key = id(t)
            ref = weakref.ref(t, lambda _r, _k=key: self._disown(_k, _r))
            with self._lock:
                self._owned[key] = (ref, subsystem)

    def _disown(self, key: int, ref=None) -> None:
        with self._lock:
            entry = self._owned.get(key)
            if entry is not None and (ref is None or entry[0] is ref):
                del self._owned[key]

    def owner_of(self, arr) -> Optional[str]:
        with self._lock:
            entry = self._owned.get(id(arr))
        if entry is None:
            return None
        ref, subsystem = entry
        return subsystem if ref() is arr else None

    # -- snapshots ---------------------------------------------------------
    def _collect(self) -> Dict[str, int]:
        """Claimed bytes: pushed values, polled providers, the fusion and
        checkpoint slabs, and the host RSS."""
        with self._lock:
            claimed = dict(self._claimed)
            providers = list(self._providers.items())
        for name, fn in providers:
            try:
                claimed[name] = int(fn())
            except Exception as exc:  # a dying subsystem must not stop it
                log.debug("memory: provider %s failed: %s", name, exc)
        from horovod_tpu_torch.runtime import fusion_buffer

        for purpose, rec in fusion_buffer.bytes_by_purpose().items():
            claimed[purpose] = int(rec["allocated_bytes"])
        from horovod_tpu_torch.serve import kv_cache, paging

        claimed["serve_kv"] = kv_cache.total_cache_bytes()
        claimed["kv_pages"] = paging.total_pool_bytes()
        claimed["host_rss"] = host_rss_bytes()
        # polled values go through the peak and gauge bookkeeping too
        for name, nbytes in claimed.items():
            self.set_bytes(name, nbytes)
        return claimed

    def ledger(self) -> dict:
        """The subsystems, the device's figures and the drift: the
        ``memory`` state of every flight-recorder dump."""
        claimed = self._collect()
        device = device_memory_stats(self.device)
        actual = int(device.get("bytes_in_use", 0))
        claimed_device = sum(claimed.get(s, 0) for s in DEVICE_SUBSYSTEMS)
        drift = None
        if actual > 0:
            drift = (actual - claimed_device) / actual
            _DRIFT.set(round(drift, 6))
        _DEVICE_BYTES.set(actual)
        if device.get("peak_bytes_in_use"):
            _DEVICE_PEAK.set(int(device["peak_bytes_in_use"]))
        if device.get("bytes_limit"):
            _DEVICE_LIMIT.set(int(device["bytes_limit"]))
        _HOST_RSS.set(claimed.get("host_rss", 0))
        with self._lock:
            peaks = dict(self._peaks)
            last_oom = self._last_oom
        return {
            "rank": self.rank,
            "wall_time": time.time(),
            "subsystems": {
                name: {"bytes": nbytes, "peak_bytes": peaks.get(name, nbytes)}
                for name, nbytes in sorted(claimed.items())},
            "total_claimed_bytes": sum(claimed.values())
            - claimed.get("host_rss", 0),
            "claimed_device_bytes": claimed_device,
            "device": {
                "bytes_in_use": actual,
                "peak_bytes_in_use": int(device.get("peak_bytes_in_use", 0)),
                "bytes_limit": int(device.get("bytes_limit", 0)),
                "live_array_bytes": 0,
                "bytes_reserved": int(device.get("bytes_reserved", 0)),
                "peak_bytes_reserved": int(
                    device.get("peak_bytes_reserved", 0)),
                "reconciled_against": ("allocated_bytes" if device
                                       else None),
            },
            "reconcile_drift_ratio": drift,
            "last_oom": last_oom,
        }

    def top_live_arrays(self, k: Optional[int] = None) -> List[dict]:
        """The ``k`` largest live tensors on the tracker's device (views
        of one storage once, by the storage's bytes), with shape, dtype
        and owner: the core of an OOM record. Walks the garbage
        collector's objects, so it runs for a dump, not a step."""
        k = self.topk if k is None else int(k)
        want = self.device.type if self.device is not None else "cpu"
        best: Dict[Any, tuple] = {}
        for obj in gc.get_objects():
            # type(), not isinstance: a deprecated module proxy among the
            # objects warns when its __class__ is read
            if not issubclass(type(obj), torch.Tensor) \
                    or obj.device.type != want:
                continue
            key, nbytes = _storage(obj)
            owner = self.owner_of(obj)
            prev = best.get(key)
            if prev is None or (prev[2] is None and owner is not None):
                best[key] = (nbytes, obj, owner)
        rows = sorted(best.values(), key=lambda r: r[0], reverse=True)[:k]
        return [{"bytes": nbytes, "shape": list(t.shape),
                 "dtype": str(t.dtype).removeprefix("torch."),
                 "owner": owner or "unattributed"}
                for nbytes, t, owner in rows]

    def peak_hbm_bytes(self) -> int:
        """The high watermark the profiler records a step: the allocator's
        peak allocated bytes on the card, the claimed device subsystems'
        peaks elsewhere."""
        device = device_memory_stats(self.device)
        if device.get("peak_bytes_in_use"):
            return int(device["peak_bytes_in_use"])
        with self._lock:
            return sum(v for k, v in self._peaks.items()
                       if k in DEVICE_SUBSYSTEMS)

    def samples(self) -> List[list]:
        """The sampler's ring: [wall_time, claimed_device, actual_device]
        rows, which the merged trace's memory counter track reads."""
        with self._lock:
            return [list(s) for s in self._samples]

    # -- sampler -----------------------------------------------------------
    def sample(self) -> dict:
        """One reconciliation sweep into the sample ring."""
        led = self.ledger()
        with self._lock:
            self._samples.append((led["wall_time"],
                                  led["claimed_device_bytes"],
                                  led["device"]["bytes_in_use"]
                                  or led["device"]["live_array_bytes"]))
        _SAMPLES.inc()
        return led

    def start(self, interval: Optional[float] = None) -> None:
        """Start the sampling thread (idempotent)."""
        if interval is not None:
            self.sample_seconds = float(interval)
        with self._lock:
            if self._sampler is not None and self._sampler.is_alive():
                return
            self._stop.clear()
            self._sampler = threading.Thread(
                target=self._sample_loop, daemon=True, name="hvd-memory")
            self._sampler.start()

    def stop(self) -> None:
        with self._lock:
            sampler, self._sampler = self._sampler, None
        self._stop.set()
        if sampler is not None:
            sampler.join(timeout=5.0)

    def _sample_loop(self) -> None:
        while not self._stop.wait(self.sample_seconds):
            try:
                self.sample()
            except (RuntimeError, OSError) as exc:
                # a device torn down under the sampler ends its sweep, not
                # the process
                log.debug("memory: sample failed: %s", exc)

    # -- OOM record --------------------------------------------------------
    def record_oom(self, exc: BaseException, where: str) -> dict:
        """An OOM as a record: the ledger (the allocator's figures in it),
        the largest live tensors and the dominant subsystem, kept on the
        tracker (the ``memory`` provider puts it in the dump that follows)
        and emitted as a flight event."""
        _OOMS.inc()
        led = self.ledger()
        top = self.top_live_arrays()
        subsystems = led.get("subsystems", {})
        dominant = None
        if subsystems:
            dominant = max(
                (s for s in subsystems if s != "host_rss"),
                key=lambda s: subsystems[s]["bytes"], default=None)
        forensics = {
            "where": where,
            "error": str(exc)[:2000],
            "wall_time": time.time(),
            "dominant_subsystem": dominant,
            "top_live_arrays": top,
            "subsystems": subsystems,
            "device": led.get("device", {}),
        }
        with self._lock:
            self._last_oom = forensics
        from horovod_tpu_torch import flight_recorder

        flight_recorder.emit(
            "oom", where=where, dominant_subsystem=dominant,
            device_bytes_in_use=led.get("device", {}).get("bytes_in_use"),
            error=str(exc)[:200])
        flight_recorder.dump_on_failure("oom")
        return forensics

    def last_oom(self) -> Optional[dict]:
        with self._lock:
            return self._last_oom


_tracker = MemoryTracker()


def tracker() -> MemoryTracker:
    return _tracker


def configure(rank: Optional[int] = None, device=None) -> None:
    """Take the rank and device, parse the ``HOROVOD_MEMORY_*`` knobs,
    register the flight recorder's ``memory`` provider, and start the
    sampler for a CUDA device. From ``hvd.init()`` (again at each elastic
    re-init)."""
    t = _tracker
    if rank is not None:
        t.rank = int(rank)
    if device is not None:
        t.device = torch.device(device)
    t.enabled = env._get_bool(HOROVOD_MEMORY, True)
    t.sample_seconds = env._get_float(HOROVOD_MEMORY_SAMPLE_SECONDS,
                                      DEFAULT_SAMPLE_SECONDS)
    t.topk = env._get_int(HOROVOD_MEMORY_TOPK, DEFAULT_TOPK)
    from horovod_tpu_torch import flight_recorder

    if t.enabled:
        flight_recorder.set_state_provider("memory", t.ledger)
        if t.device is not None and t.device.type == "cuda":
            t.start()
    else:
        flight_recorder.set_state_provider("memory", None)
        t.stop()


def memory_state() -> dict:
    """``GET /memory``: the ledger, the largest live tensors and the
    recent samples."""
    t = _tracker
    state = t.ledger()
    state["top_live_arrays"] = t.top_live_arrays()
    state["samples"] = t.samples()[-64:]
    state["sample_seconds"] = t.sample_seconds
    return state


# -- OOM detection -----------------------------------------------------------

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "OOM when allocating")


def is_oom(exc: BaseException) -> bool:
    """True for an allocator running out: ``torch.cuda.OutOfMemoryError``
    (``torch.OutOfMemoryError``), a message with "CUDA out of memory" (an
    error re-raised as another type keeps it), or the JAX package's cases
    (``RESOURCE_EXHAUSTED``, a ``MemoryError``)."""
    if exc is None:
        return False
    oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_type is not None and isinstance(exc, oom_type):
        return True
    text = str(exc)
    if "CUDA out of memory" in text:
        return True
    if type(exc).__name__ == "XlaRuntimeError":
        return any(m in text for m in _OOM_MARKERS)
    return _OOM_MARKERS[0] in text or type(exc).__name__ == "MemoryError"


def maybe_record_oom(exc: BaseException, where: str) -> bool:
    """The executor's and the elastic runner's hook: one call, nothing
    unless ``exc`` is an OOM."""
    if not is_oom(exc):
        return False
    try:
        _tracker.record_oom(exc, where)
    except (RuntimeError, OSError) as err:
        # the OOM itself goes on up; a record that could not be made is
        # logged, not raised over it
        log.warning("memory: OOM record at %s failed: %s", where, err)
    return True


# -- cross-rank postmortem ----------------------------------------------------

def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return ("%.1f %s" % (n, unit)) if unit != "B" \
                else ("%d B" % int(n))
        n /= 1024.0
    return "%d B" % int(n)


def format_memory_report(dumps: List[dict]) -> str:
    """The postmortem's memory section from the dumps' ``memory`` state:
    each rank's claimed and device bytes, the dominant subsystem across
    the ranks, and the rank nearest its ceiling. Empty when no dump has
    a memory ledger."""
    ranks = []
    for d in dumps:
        mem = (d.get("state") or {}).get("memory")
        if not isinstance(mem, dict):
            continue
        ranks.append((d.get("launch_rank", d.get("rank", "?")), mem))
    if not ranks:
        return ""
    lines = ["=== memory report (%d rank%s) ==="
             % (len(ranks), "" if len(ranks) == 1 else "s")]
    totals: Dict[str, int] = {}
    nearest = None  # (rank, headroom_ratio, in_use, limit)
    for rank, mem in sorted(ranks, key=lambda r: str(r[0])):
        subs = mem.get("subsystems", {})
        for name, rec in subs.items():
            if name == "host_rss":
                continue
            totals[name] = totals.get(name, 0) + int(rec.get("bytes", 0))
        device = mem.get("device", {})
        in_use = int(device.get("bytes_in_use", 0)) \
            or int(device.get("live_array_bytes", 0))
        limit = int(device.get("bytes_limit", 0))
        ratio = (in_use / limit) if limit else None
        drift = mem.get("reconcile_drift_ratio")
        top = ", ".join(
            "%s=%s" % (n, _fmt_bytes(r.get("bytes", 0)))
            for n, r in sorted(subs.items(),
                               key=lambda kv: -int(kv[1].get("bytes", 0)))
            if n != "host_rss")[:200]
        lines.append(
            "rank %s: device %s in use%s, host rss %s%s%s" % (
                rank, _fmt_bytes(in_use),
                (" / %s limit (%.1f%%)" % (_fmt_bytes(limit),
                                           100.0 * ratio))
                if ratio is not None else "",
                _fmt_bytes(subs.get("host_rss", {}).get("bytes", 0)),
                ("  drift=%+.1f%%" % (100.0 * drift))
                if isinstance(drift, (int, float)) else "",
                ("  [%s]" % top) if top else ""))
        oom = mem.get("last_oom")
        if isinstance(oom, dict):
            lines.append(
                "rank %s: OOM at %s — dominant subsystem %s" % (
                    rank, oom.get("where", "?"),
                    oom.get("dominant_subsystem", "?")))
            for arr in (oom.get("top_live_arrays") or ())[:3]:
                lines.append(
                    "    live array %s %s %s (%s)" % (
                        _fmt_bytes(arr.get("bytes", 0)),
                        tuple(arr.get("shape", ())),
                        arr.get("dtype", "?"),
                        arr.get("owner", "unattributed")))
        key = ratio if ratio is not None else float(in_use)
        if nearest is None or key > nearest[1]:
            nearest = (rank, key, in_use, limit)
    if totals:
        dominant = max(totals, key=lambda k: totals[k])
        lines.append("dominant subsystem: %s (%s across %d rank%s)"
                     % (dominant, _fmt_bytes(totals[dominant]), len(ranks),
                        "" if len(ranks) == 1 else "s"))
    if nearest is not None:
        rank, _key, in_use, limit = nearest
        lines.append(
            "nearest HBM ceiling: rank %s (%s in use%s)" % (
                rank, _fmt_bytes(in_use),
                (" of %s, %.1f%% full" % (_fmt_bytes(limit),
                                          100.0 * in_use / limit))
                if limit else ""))
    return "\n".join(lines)
