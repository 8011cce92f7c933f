"""Hardware bandwidth probes seeding the autotuner (port of
``horovod_tpu/autotune/probe.py``).

The probes measure the machine once, when the runtime starts under
``HOROVOD_AUTOTUNE_PROBE``, and turn the measurement into an initial fusion
threshold: fuse at most what the data group can reduce within a set
fraction of one cycle, so the first autotune samples start near the right
region instead of at a hardware-blind constant.

On the card every time is the device's: :func:`probe_hbm_bandwidth` is a
device copy timed by ``utils.measure.time_ms`` (CUDA events around a CUDA
graph of the copies), and the collectives' probes are NCCL calls on the
runtime's groups between two CUDA events on the current stream. On the CPU
(gloo) they are the host's clock, as every CPU time is.

``HOROVOD_PROBE_CACHE=<path>`` keeps the measurements as a JSON roofline
(schema 2, written through a temporary file, fsync'd and renamed, its
directory fsync'd too) and reads them back at the next start instead of
probing again; an artifact probed at another world size is ignored (the
bus factor depends on the world). ``comms.configure`` seeds the comms
observatory's ``device``, ``hier_intra`` and ``hier_cross`` rooflines from
it. The probes are collective: every rank runs them at the same point.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils.measure import time_ms

log = logging.getLogger("horovod_tpu_torch")

HOROVOD_PROBE_CACHE = env.HOROVOD_PROBE_CACHE

# the persisted roofline's schema (a mismatch re-probes); v2 holds the
# hierarchy's two hops apart (hier_intra_busbw_gbps, hier_cross_busbw_gbps)
_CACHE_SCHEMA = 2


def _timed(device, fn, iters: int) -> float:
    """Seconds a call of ``fn`` (a collective, so no CUDA graph): on the
    card CUDA events around ``iters`` calls on the current stream after
    two warm-up calls, which double as a barrier; on the CPU the host's
    clock."""
    for _ in range(2):
        fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def probe_hbm_bandwidth(size_mb: int = 64, iters: int = 16,
                        device=None) -> float:
    """Sustained copy bandwidth of ``device``'s memory in GB/s (a read and
    a write a byte): ``iters`` copies of a ``size_mb`` MiB buffer timed by
    ``utils.measure.time_ms``."""
    device = torch.device(device) if device is not None else _device()
    n = size_mb * (1 << 20) // 4
    src = torch.ones(n, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), iters, device)
    return 2.0 * src.numel() * src.element_size() / (ms / 1e3) / 1e9


def probe_allreduce_bandwidth(group=None, size_mb: int = 32,
                              iters: int = 8, detail: bool = False,
                              device=None) -> Union[float, dict]:
    """Algorithm bandwidth (input bytes / time) of an allreduce on
    ``group`` (the runtime's data group: NCCL on the card) in GB/s. Each
    iteration is the allreduce then a scale by 1/world, as the JAX
    package's chain is (``psum`` then ``* inv``): at world 1 the allreduce
    moves nothing and the probe degenerates to one read and one write of
    the buffer, the memory-bound pass the JAX probe measures on a
    one-device mesh.

    ``detail=True`` returns ``{"algbw_gbps", "busbw_gbps", "world"}``:
    bus bandwidth is algbw x 2(N-1)/N (0 at world 1, the comms plane's
    convention) and the world it was probed at."""
    from horovod_tpu_torch import comms

    device = torch.device(device) if device is not None else _device()
    group = _data_group() if group is None else group
    world = dist.get_world_size(group)
    x = torch.ones(size_mb * (1 << 20) // 4, dtype=torch.float32,
                   device=device)
    inv = 1.0 / world

    def step():
        dist.all_reduce(x, group=group)
        x.mul_(inv)

    dt = _timed(device, step, iters)
    algbw = x.numel() * x.element_size() / dt / 1e9
    if not detail:
        return algbw
    return {"algbw_gbps": algbw,
            "busbw_gbps": algbw * comms.bus_factor("allreduce", world),
            "world": world}


def recommended_fusion_threshold(allreduce_gbps: float,
                                 cycle_time_ms: float,
                                 cycle_fraction: float = 0.5,
                                 floor_bytes: int = 1 << 20,
                                 ceil_bytes: int = 256 << 20,
                                 hbm_gbps: Optional[float] = None) -> int:
    """Fusion threshold such that reducing one full fused buffer takes at
    most ``cycle_fraction`` of a cycle at the probed bandwidth (the JAX
    package's formula). The rate is capped by ``hbm/2`` when given: a fused
    collective also packs and unpacks its slab through memory."""
    rate = allreduce_gbps
    if hbm_gbps is not None:
        rate = min(rate, hbm_gbps / 2.0)
    budget_s = cycle_time_ms * 1e-3 * cycle_fraction
    threshold = int(rate * 1e9 * budget_s)
    return max(floor_bytes, min(ceil_bytes, threshold))


def _device() -> torch.device:
    from horovod_tpu_torch.core import basics

    return basics._ensure_init().device


def _data_group():
    from horovod_tpu_torch.core import basics

    return basics._ensure_init().data_group


def _cache_path() -> Optional[str]:
    path = os.environ.get(HOROVOD_PROBE_CACHE, "").strip()
    return path or None


def load_cached_roofline(path: Optional[str] = None,
                         world: Optional[int] = None) -> Optional[dict]:
    """The persisted probe artifact (``HOROVOD_PROBE_CACHE``), or None when
    the knob is unset, the file is missing or corrupt, the schema moved on,
    or it was probed at another world size."""
    path = path or _cache_path()
    if not path:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != _CACHE_SCHEMA:
        return None
    if world is not None and int(doc.get("world", -1)) != int(world):
        log.info("probe cache %s ignored: probed on world=%s, running "
                 "world=%d", path, doc.get("world"), world)
        return None
    return doc


def _persist_roofline(path: str, doc: dict) -> None:
    """Write the artifact through a temporary file, fsync it, rename it
    into place and fsync the directory: a crash leaves the old file or the
    new one, never a torn one."""
    tmp = "%s.tmp.%d" % (path, os.getpid())
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dir_fd)
    finally:
        os.close(dir_fd)


def _persist(world: int, rank: int, fields: dict) -> None:
    """Rank 0 merges ``fields`` into the artifact of this world (the
    device probe's and the hops' keys live side by side)."""
    path = _cache_path()
    if not path or rank != 0:
        return
    doc = load_cached_roofline(path, world=world) or {}
    doc.update(fields, schema=_CACHE_SCHEMA, world=world,
               wall_time=time.time())
    try:
        _persist_roofline(path, doc)
    except OSError as exc:
        log.warning("probe cache not persisted to %s: %s", path, exc)


def probe_and_seed(config, world: Optional[int] = None, rank: int = 0,
                   group=None, device=None) -> dict:
    """Run the probes (or read the matching artifact) and seed
    ``config.fusion_threshold_bytes``; returns the measurements. Every rank
    of the data group runs it together; the runtime then agrees on the
    coordinator's threshold. Rank 0 keeps a fresh measurement in the probe
    cache, and the ``device`` lane's roofline is seeded from its bus
    bandwidth when that is above 0 (not at world 1)."""
    from horovod_tpu_torch import comms

    group = _data_group() if group is None else group
    world = dist.get_world_size(group) if world is None else world
    cached = load_cached_roofline(world=world)
    if cached is not None and "hbm_gbps" not in cached:
        cached = None  # an artifact of the hops only
    if cached is not None:
        measured = {
            "hbm_gbps": float(cached["hbm_gbps"]),
            "allreduce_gbps": float(cached["allreduce_gbps"]),
            "allreduce_busbw_gbps": float(
                cached.get("allreduce_busbw_gbps", 0.0)),
            "world": world,
            "cached": True,
        }
    else:
        hbm = probe_hbm_bandwidth(device=device)
        ar = probe_allreduce_bandwidth(group, detail=True, device=device)
        if not isinstance(ar, dict):  # a stand-in that gives algbw alone
            ar = {"algbw_gbps": float(ar),
                  "busbw_gbps": float(ar)
                  * comms.bus_factor("allreduce", world)}
        measured = {
            "hbm_gbps": hbm,
            "allreduce_gbps": ar["algbw_gbps"],
            "allreduce_busbw_gbps": ar["busbw_gbps"],
            "world": world,
            "cached": False,
        }
    threshold = recommended_fusion_threshold(
        measured["allreduce_gbps"], config.cycle_time_ms,
        hbm_gbps=measured["hbm_gbps"])
    config.fusion_threshold_bytes = threshold
    measured["fusion_threshold_bytes"] = threshold
    if not measured["cached"]:
        _persist(world, rank, {
            "hbm_gbps": measured["hbm_gbps"],
            "allreduce_gbps": measured["allreduce_gbps"],
            "allreduce_busbw_gbps": measured["allreduce_busbw_gbps"],
            "fusion_threshold_bytes": threshold})
    if measured["allreduce_busbw_gbps"] > 0:
        comms.tracker().seed_roofline(
            "device", measured["allreduce_busbw_gbps"],
            source="probe_cache" if measured["cached"] else "probe")
    return measured


def probe_hier_hops(groups, size_mb: int = 4, iters: int = 6,
                    device=None) -> dict:
    """Time the hierarchy's two hops apart: an allreduce on this rank's
    intra group (``hier_intra``) and on its cross group (``hier_cross``),
    each as bus bandwidth (GB/s). ``max`` keeps the values fixed across
    iterations. Collective: every rank of the plan calls it together (the
    intra groups are disjoint, so are the cross groups)."""
    from horovod_tpu_torch import comms

    device = torch.device(device) if device is not None else _device()
    plan = groups.plan
    buf = torch.ones(max(1, size_mb * (1 << 20) // 4), dtype=torch.float32,
                     device=device)
    nbytes = buf.numel() * buf.element_size()

    def busbw(group, n) -> float:
        dt = _timed(device, lambda: dist.all_reduce(
            buf, op=dist.ReduceOp.MAX, group=group), iters)
        return nbytes / dt / 1e9 * comms.bus_factor("allreduce", n)

    return {"hier_intra_busbw_gbps": busbw(groups.intra, plan.group_size),
            "hier_cross_busbw_gbps": busbw(groups.cross, plan.num_groups)}


def probe_host_hier_and_seed(net, executor) -> Optional[dict]:
    """The hops' counterpart of :func:`probe_and_seed`: read a matching
    artifact's hop numbers, or build the executor's plan and probe both
    hops over its groups (rank 0 keeps them in the cache), and seed the
    ``hier_intra`` and ``hier_cross`` rooflines. None when the world
    cannot form a hierarchy. Collective."""
    from horovod_tpu_torch import comms

    groups = executor._hierarchy_plan(net, True)
    if groups is None:
        return None
    cached = load_cached_roofline(world=net.world)
    if cached is not None and cached.get("hier_intra_busbw_gbps") \
            and cached.get("hier_cross_busbw_gbps"):
        measured = {
            "hier_intra_busbw_gbps": float(cached["hier_intra_busbw_gbps"]),
            "hier_cross_busbw_gbps": float(cached["hier_cross_busbw_gbps"]),
            "cached": True,
        }
    else:
        measured = probe_hier_hops(groups, device=executor.device)
        _persist(net.world, net.rank, dict(measured))
        measured["cached"] = False
    source = "probe_cache" if measured["cached"] else "probe"
    for lane in ("hier_intra", "hier_cross"):
        comms.tracker().seed_roofline(
            lane, measured[f"{lane}_busbw_gbps"], source=source)
    return measured
