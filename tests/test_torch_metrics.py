"""The port's metrics registry, its instruments, the stall tracker and the
lifecycle's metrics knobs against the JAX package's (mirrors
``tests/test_metrics.py``).

The same operations on both registries give byte-equal Prometheus text
and equal snapshots, dumps and cross-rank summaries; the endpoint serves
its four routes and no thread or socket exists while
``HOROVOD_METRICS_PORT`` is unset; ``HOROVOD_METRICS_DUMP`` writes this
rank's snapshot at shutdown; the straggler tracker ranks the JAX package's
way; ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` shuts a stalled job down; and
in a 2-rank world the same named allreduces through both runtimes move
the same families by the same counts.
"""

import importlib
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

import horovod_tpu.stall as jstall
import horovod_tpu_torch as hvd
from horovod_tpu_torch import stall as tstall
from horovod_tpu_torch.runtime import message as tmsg
from horovod_tpu_torch.runtime import runtime as trt
from horovod_tpu_torch.utils import env

# the modules (both packages bind ``metrics`` to the snapshot function)
jmetrics = importlib.import_module("horovod_tpu.metrics")
tmetrics = importlib.import_module("horovod_tpu_torch.metrics")
REPO = Path(__file__).resolve().parents[1]


def _drive(reg, seed: int) -> None:
    """A seeded mix of counters, gauges and histograms, labelled and not,
    with values that need escaping and formatting."""
    rng = random.Random(seed)
    c = reg.counter("c_total", 'help with "quotes" and \\ and\nnewline')
    lc = reg.counter("ops_total", "per op", labelnames=("op",))
    g = reg.gauge("depth", "a gauge")
    lg = reg.gauge("lag_seconds", "per rank", labelnames=("rank",))
    h = reg.histogram("lat_seconds", "latency")
    hc = reg.histogram("n", "counts", buckets=tmetrics.COUNT_BUCKETS,
                       labelnames=("op",))
    reg.counter("never_total", "declared, never moved")
    for _ in range(300):
        k = rng.randrange(7)
        if k == 0:
            c.inc(rng.choice([1, 3, 0.25]))
        elif k == 1:
            lc.labels(op=rng.choice(['AL"L', "B\\C", "x\ny"])).inc()
        elif k == 2:
            g.set(rng.choice([0, 7, 1e-9, 123456789.125]))
        elif k == 3:
            g.inc(rng.randint(0, 3)) if rng.random() < 0.5 else g.dec()
        elif k == 4:
            lg.labels(rank=rng.randrange(3)).set(rng.random())
        elif k == 5:
            h.observe(rng.choice([0.0001, 0.003, 0.5, 20.0, rng.random()]))
        else:
            hc.labels(op="a").observe(rng.choice([0, 1, 8, 9, 1000]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_give_the_jax_packages_text_and_dumps(tmp_path,
                                                              seed):
    ours, theirs = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive(ours, seed)
    _drive(theirs, seed)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.snapshot() == theirs.snapshot()
    json.dumps(ours.snapshot())
    paths = {}
    for name, reg in (("ours", ours), ("theirs", theirs)):
        paths[name] = [reg.dump(str(tmp_path / name), rank=0),
                       reg.dump(str(tmp_path / f"{name}-{{rank}}.json"),
                                rank=1),
                       reg.dump(str(tmp_path / f"{name}2.json"), rank=2)]
    assert [Path(p).name for p in paths["ours"]] == [
        "metrics-rank-0.json", "ours-1.json", "ours2.json"]
    for a, b in zip(paths["ours"], paths["theirs"]):
        assert Path(a).read_text() == Path(b).read_text()
    rows = tmetrics.summarize_dumps(paths["ours"])
    assert rows == jmetrics.summarize_dumps(paths["theirs"])
    assert tmetrics.flatten_snapshot(ours.snapshot()) == \
        jmetrics.flatten_snapshot(theirs.snapshot())
    assert tmetrics.format_summary(rows, 3) == \
        jmetrics.format_summary(rows, 3)
    assert tmetrics.format_summary(rows[:0], 1) == \
        jmetrics.format_summary(rows[:0], 1)


def _get(port: int, route: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=5) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, None, None


@pytest.fixture
def world1(monkeypatch):
    hvd.shutdown()
    trt.reset_counts()
    yield monkeypatch
    hvd.shutdown()


def _metrics_threads() -> list:
    return [t for t in threading.enumerate() if t.name == "hvd-metrics-http"]


def test_endpoint_serves_its_routes_and_stops():
    reg = tmetrics.MetricsRegistry()
    reg.counter("up_total", "liveness").inc()
    port = reg.serve(0)
    try:
        assert reg.serve(0) == port == reg.http_port
        status, kind, body = _get(port, "/metrics")
        assert status == 200 and kind.startswith("text/plain; version=0.0.4")
        assert body.decode() == reg.prometheus_text()
        for route in ("/", "/debug/routes"):
            status, kind, body = _get(port, route)
            assert status == 200 and kind == "application/json"
            assert set(json.loads(body)["routes"]) == {
                "/metrics", "/debug/routes", "/profile", "/healthz"}
        hvd.shutdown()
        status, _, _ = _get(port, "/healthz")
        assert status == 503
        assert _get(port, "/nope")[0] == 404
        assert _get(port, "/serve")[0] == 404
    finally:
        reg.stop_server()
    assert reg.http_port is None
    assert not _metrics_threads()


def test_no_thread_or_socket_while_the_knob_is_unset(world1):
    world1.delenv("HOROVOD_METRICS_PORT", raising=False)
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="x")
    assert tmetrics.registry().http_port is None
    assert not _metrics_threads()


def test_init_serves_the_registry_and_shutdown_stops_it(world1):
    world1.setenv("HOROVOD_METRICS_PORT", "0")
    hvd.init(device="cpu")
    port = tmetrics.registry().http_port
    assert port
    hvd.allreduce(torch.ones(2), name="x")
    status, _, body = _get(port, "/metrics")
    text = body.decode()
    assert status == 200
    assert "horovod_cycles_total" in text
    assert "horovod_response_cache_misses_total" in text
    assert _get(port, "/healthz")[0] == 200
    hvd.shutdown()
    assert tmetrics.registry().http_port is None
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=2)


def test_shutdown_writes_the_dump(world1, tmp_path):
    world1.setenv("HOROVOD_METRICS_DUMP", str(tmp_path / "dumps"))
    hvd.init(device="cpu")
    hvd.grouped_allreduce([torch.ones(2), torch.ones(3)], name="d")
    hvd.shutdown()
    path = tmp_path / "dumps" / "metrics-rank-0.json"
    data = json.loads(path.read_text())
    assert data["rank"] == 0
    flat = tmetrics.flatten_snapshot(data["metrics"])
    assert flat["horovod_fusion_tensors_total"] >= 2
    rows = dict((r[0], r[1:]) for r in tmetrics.summarize_dumps([str(path)]))
    assert rows["horovod_cycles_total"][0] >= 1


def test_metrics_work_before_init_and_move_with_counts(world1):
    """``hvd.metrics()`` before ``init()``; then, over a world-1 run read
    once its runtime has stopped, cycles move with ``COUNTS["cycles"]``
    (one call moves both) and every request answered from the cache is two
    hit lookups (its announcement and the agreed list's check, as in the
    JAX package)."""
    before = tmetrics.flatten_snapshot(hvd.metrics())
    assert "horovod_cycles_total" in before
    hvd.init(device="cpu")
    xs = [torch.ones(3), torch.ones(4)]
    for _ in range(4):
        hvd.grouped_allreduce(xs, name="w")
    trt.get_runtime().stop()
    after = tmetrics.flatten_snapshot(hvd.metrics())

    def moved(key):
        return after[key] - before.get(key, 0)

    assert moved("horovod_cycles_total") == trt.COUNTS["cycles"] == 4
    assert moved("horovod_response_cache_hits_total") == \
        2 * trt.COUNTS["cache_hits"] == 12
    assert moved("horovod_response_cache_misses_total") == 4
    assert moved("horovod_fusion_buffer_allocs_total") == \
        trt.COUNTS["slabs"] == 2
    assert moved("horovod_fusion_buffer_reuses_total") == 3
    assert moved("horovod_tensor_queue_enqueued_total") == 8
    assert moved("horovod_handle_wait_seconds.count") == 8
    assert moved("horovod_executor_op_bytes_total{op=ALLREDUCE}") == 112
    assert moved("horovod_cycle_duration_seconds.count") == 4
    for gauge in ("horovod_tensor_queue_depth",
                  "horovod_cycle_pipeline_depth",
                  "horovod_fusion_buffer_leases_outstanding{purpose=fusion}",
                  "horovod_fusion_buffer_live_bytes{purpose=fusion}"):
        assert after[gauge] == 0, gauge


ARRIVALS = [{0: 1.0, 1: 1.0, 2: 1.4}, {0: 2.0, 1: 2.1, 2: 2.5},
            {0: 3.2, 1: 3.0, 2: 3.0}, {0: 4.0, 1: 4.0, 2: 4.0},
            {0: 5.0, 2: 5.9}]


def test_straggler_tracker_ranks_the_jax_packages_way():
    ours = tstall.StragglerTracker(world=3, report_seconds=0)
    theirs = jstall.StragglerTracker(world=3, report_seconds=0)
    for i, arrivals in enumerate(ARRIVALS):
        ours.observe(f"t{i}", arrivals)
        theirs.observe(f"t{i}", arrivals)
        assert ours.ranking() == theirs.ranking()
        assert ours.lag_summary() == theirs.lag_summary()
        assert ours.lag_summary([1]) == theirs.lag_summary([1])
        assert ours.last_counts == theirs.last_counts
    assert ours.ranking()[0][0] == 2
    snap = tmetrics.flatten_snapshot(hvd.metrics())
    assert snap["horovod_straggler_lag_seconds{rank=2}"] == \
        pytest.approx(dict(ours.ranking())[2])


def test_stall_warning_names_missing_ranks_with_their_lag(caplog):
    """The coordinator's scan over a world-3 table where rank 1 never
    announced: the warning names it, with the tracker's lag note."""
    from horovod_tpu_torch.runtime.controller import MessageTable

    table = MessageTable()
    for rank in (0, 2):
        table.increment(tmsg.Request(rank, "ALLREDUCE", "g", "float32", (2,)),
                        world=3)
    tracker = tstall.StragglerTracker(world=3, report_seconds=0)
    tracker.observe("old", {0: 0.0, 1: 0.5, 2: 0.0})
    inspector = tstall.StallInspector(warning_time_seconds=0.0)
    before = tstall._STALL_WARNINGS.value
    assert not inspector.check(table, world=3, straggler=tracker)
    assert tstall._STALL_WARNINGS.value == before + 1


def test_stall_shutdown_time_from_the_knob_shuts_the_job_down(world1):
    """``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS`` reaches the coordinator's
    inspector through init's Config; a tensor stalled past it asks for the
    shutdown, which the next cycle carries, and later enqueues raise."""
    world1.setenv("HOROVOD_STALL_CHECK_TIME_SECONDS", "0.05")
    world1.setenv("HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", "0.1")
    world1.setenv("HOROVOD_STRAGGLER_REPORT_SECONDS", "5")
    hvd.init(device="cpu")
    assert hvd.allreduce(torch.ones(2), name="a").tolist() == [1.0, 1.0]
    rt = trt.get_runtime()
    assert rt.stall_inspector.shutdown_time == 0.1
    assert rt.controller.straggler.report_seconds == 5.0
    # a tensor only one of two ranks announced, as a world-2 table holds it
    rt.controller.message_table.increment(
        tmsg.Request(0, "ALLREDUCE", "stuck", "float32", (2,)), world=2)
    shutdowns = tstall._STALL_SHUTDOWNS.value
    time.sleep(0.2)
    hvd.allreduce(torch.ones(2), name="b")  # its cycle's scan asks
    hvd.allreduce(torch.ones(2), name="c")  # its cycle carries the bit
    rt._thread.join(timeout=10)
    assert not rt._thread.is_alive()
    assert tstall._STALL_SHUTDOWNS.value == shutdowns + 1
    with pytest.raises(RuntimeError, match="shut down"):
        hvd.allreduce(torch.ones(2), name="d")


def test_config_holds_the_knobs(monkeypatch):
    for knob in ("HOROVOD_METRICS_PORT", "HOROVOD_METRICS_DUMP",
                 "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
                 "HOROVOD_TIMELINE_MARK_CYCLES", "HOROVOD_NATIVE_CYCLE"):
        monkeypatch.delenv(knob, raising=False)
    cfg = env.Config.from_env()
    assert (cfg.metrics_port, cfg.metrics_dump, cfg.native_cycle,
            cfg.stall_shutdown_time_seconds, cfg.timeline_mark_cycles) == \
        (None, "", True, 0.0, False)
    monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
    monkeypatch.setenv("HOROVOD_NATIVE_CYCLE", "off")
    monkeypatch.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    monkeypatch.setenv("HOROVOD_STRAGGLER_REPORT_SECONDS", "0")
    cfg = env.Config.from_env()
    assert (cfg.metrics_port, cfg.native_cycle, cfg.timeline_mark_cycles,
            cfg.straggler_report_seconds) == (0, False, True, 0.0)


# the families both runtimes move; the fusion slabs' allocations and bytes
# differ by design (the port allocates a key's pipeline depth of slabs at
# its first lease, the JAX package one a lease)
EQUAL = ("horovod_response_cache_hits_total",
         "horovod_response_cache_misses_total",
         "horovod_fusion_tensors_total", "horovod_fusion_bytes_total",
         "horovod_fusion_batches_total", "horovod_cycles_total",
         "horovod_cycle_tensors.count", "horovod_cycle_tensors.sum",
         "horovod_tensor_queue_enqueued_total",
         "horovod_executor_op_bytes_total{op=ALLREDUCE}",
         "horovod_fusion_buffer_utilization_ratio.count",
         "horovod_fusion_buffer_utilization_ratio.sum",
         "horovod_fusion_buffer_reuses_total")


def _moved(side: dict) -> dict:
    b, a = side["before"], side["after"]
    return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}


def _family(key: str) -> str:
    return key.split("{")[0].split(".")[0]


def test_two_rank_world_moves_the_jax_runtimes_metrics(tmp_path):
    """The same grouped named allreduces, 3 steps on 2 ranks, through the
    port's runtime (gloo) and the JAX package's (socket controller): the
    families the port has move on both sides alike, by equal cache hits,
    misses, fused tensors and bytes."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_ = dict(os.environ, PYTHONPATH=str(REPO))
    env_.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_metrics_worker.py"),
         str(r), "2", str(tmp_path), str(port)], env=env_,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    ours_families = set(tmetrics.registry().snapshot())
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        ours, theirs = _moved(got["port"]), _moved(got["jax"])
        moved_ours = {_family(k) for k in ours}
        moved_theirs = {_family(k) for k in theirs}
        assert moved_ours == moved_theirs & ours_families, (
            moved_ours ^ (moved_theirs & ours_families))
        for key in EQUAL:
            assert ours[key] == theirs[key], (r, key)
        assert ours["horovod_response_cache_hits_total"] == 32
        assert ours["horovod_response_cache_misses_total"] == 16
        assert ours["horovod_fusion_tensors_total"] == 18
