"""The port's comms observatory against the JAX package's (mirrors
tests/test_comms.py, but for its probe-cache cases, which wait for the
port's ``autotune/probe.py``): the bus factor, the size buckets, the
records, windows and EWMA, the roofline, the degradation detector's latch
and re-arm, the ``/comms`` route, the profiler's trail, the postmortem
report, and the device-timed records.

The same record stream fed to both trackers (on one frozen clock) gives
bit-equal ledgers, flight events and samples. On the card the seconds of a
record are CUDA event times; here a stand-in event with ``query`` and
``elapsed_time`` drives that path: a record waits until its end event has
passed, and is then made with the event seconds."""

import json
import os
import sys
import urllib.request

import pytest

from horovod_tpu import comms as jcomms
from horovod_tpu import flight_recorder as jfr
from horovod_tpu_torch import comms
from horovod_tpu_torch import flight_recorder as tfr


@pytest.fixture
def tracker():
    t = comms.CommsTracker()
    t.world = 2
    return t


@pytest.fixture
def singleton():
    """The port's process-wide tracker, fresh, put back after."""
    t = comms.tracker()
    with t._lock:
        saved_roof = (dict(t._roofline), dict(t._roofline_source))
        saved = (t.enabled, t.rank, t.world, t.window, t.ewma_alpha,
                 t.degraded_fraction)
    t.reset()
    t.enabled = True
    yield t
    t.reset()
    with t._lock:
        t._roofline.clear()
        t._roofline.update(saved_roof[0])
        t._roofline_source.clear()
        t._roofline_source.update(saved_roof[1])
    (t.enabled, t.rank, t.world, t.window, t.ewma_alpha,
     t.degraded_fraction) = saved


@pytest.mark.parametrize("op", ["allreduce", "reducescatter", "allgather",
                                "alltoall", "broadcast", "set", "ALLREDUCE",
                                "REDUCESCATTER"])
@pytest.mark.parametrize("world", [0, 1, 2, 3, 8])
def test_bus_factor_is_the_jax_packages(op, world):
    assert comms.bus_factor(op, world) == jcomms.bus_factor(op, world)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 3 << 20, 7 << 20,
                               (1 << 30) + 1])
def test_size_bucket_is_the_jax_packages(n):
    assert comms.size_bucket(n) == jcomms.size_bucket(n)
    assert comms._fmt_bucket(comms.size_bucket(n)) == \
        jcomms._fmt_bucket(jcomms.size_bucket(n))


def _stream():
    """Records of three lanes: warm-ups, a collapse of the ``device``
    lane's busbw, its recovery, a kv trickle and garbage rows."""
    rows = []
    rows += [("allreduce", "device", 10 ** 9, 0.1, 2)] * 8
    rows += [("allreduce", "device", 10 ** 7, 0.1, 2)] * 12
    rows += [("allreduce", "device", 10 ** 9, 0.1, 2)] * 24
    rows += [("reducescatter", "zero", 3 << 20, 0.002, 4),
             ("allgather", "zero", 3 << 20, 0.003, None)] * 5
    rows += [("set", "kv", 120, 0.001, None), ("get", "kv", 0, 0.001, None),
             ("ALLGATHER", "device", 4096, 0.0, 2),
             ("allreduce", "device", -5, 0.1, 2)]
    return rows


def test_same_stream_gives_the_jax_packages_ledger(monkeypatch):
    clock = [1700000000.0]
    monkeypatch.setattr("time.time", lambda: clock[0])
    ours, theirs = comms.CommsTracker(), jcomms.CommsTracker()
    for t in (ours, theirs):
        t.world, t.window = 2, 16
        t.seed_roofline("kv", 0.5, source="unit")
    n_ours = len(tfr.recorder().events())
    n_theirs = len(jfr.recorder().events())
    for op, lane, nbytes, secs, world in _stream():
        clock[0] += 0.01
        ours.record(op, lane, nbytes, secs, world=world)
        theirs.record(op, lane, nbytes, secs, world=world)
    assert ours.ledger() == theirs.ledger()
    assert ours.samples() == theirs.samples()
    ev_ours = [e for e in tfr.recorder().events()[n_ours:]
               if e["kind"].startswith("comms_")]
    ev_theirs = [e for e in jfr.recorder().events()[n_theirs:]
                 if e["kind"].startswith("comms_")]
    assert ev_ours == ev_theirs
    assert [e["kind"] for e in ev_ours] == ["comms_degraded",
                                            "comms_recovered"]
    assert comms.LANES == jcomms.LANES


def test_records_land_in_the_ledger(tracker):
    tracker.record("allreduce", "device", 10 ** 9, 0.5)
    led = tracker.ledger()
    lane = led["lanes"]["device"]
    assert lane["busbw_gbs"] == 2.0 and lane["bytes_total"] == 10 ** 9
    key = led["keys"][0]
    assert key["algbw_gbs"] == 2.0 and key["size_bucket"] == "1GiB"
    tracker.record("allgather", "zero", 10 ** 9, 1.0, world=4)
    assert tracker.ledger()["lanes"]["zero"]["busbw_gbs"] == 0.75
    tracker.record("allreduce", "kv", 10 ** 6, 0.1, world=1)
    assert tracker.ledger()["lanes"]["kv"]["busbw_gbs"] is None
    tracker.record("allreduce", "device", 0, 0.1)
    tracker.record("allreduce", "device", 10, 0.0)
    assert tracker.ledger()["lanes"]["device"]["ops_total"] == 1
    tracker.enabled = False
    tracker.record("allreduce", "host_ring", 10 ** 9, 1.0)
    assert "host_ring" not in tracker.ledger()["lanes"]


def test_windows_and_samples_are_bounded(tracker):
    tracker.window = 4
    for _ in range(10):
        tracker.record("allreduce", "device", 1 << 20, 0.01)
    assert tracker.ledger()["keys"][0]["ops"] == 4
    for _ in range(comms._SAMPLE_RING + 10):
        tracker.record("allreduce", "device", 1 << 20, 0.01)
    assert len(tracker.samples()) == comms._SAMPLE_RING


def test_roofline_seed_and_peak(tracker):
    tracker.record("allreduce", "device", 10 ** 9, 0.1)
    assert tracker.ledger()["lanes"]["device"]["roofline_source"] == \
        "peak_observed"
    tracker.seed_roofline("device", 100.0)
    tracker.seed_roofline("device", 0.0)  # ignored
    lane = tracker.ledger()["lanes"]["device"]
    assert lane["roofline_gbs"] == 100.0 and lane["utilization"] == 0.1


def test_detector_latches_once_rearms_and_waits_for_warmup(tracker):
    before = len([e for e in tfr.recorder().events()
                  if e["kind"] == "comms_degraded"])
    tracker.seed_roofline("device", 100.0)
    for _ in range(comms._WARMUP_OPS - 1):
        tracker.record("allreduce", "device", 10 ** 7, 0.1)
    assert not tracker.ledger()["lanes"]["device"]["alerting"]
    for _ in range(3):
        tracker.record("allreduce", "device", 10 ** 7, 0.1)
    lane = tracker.ledger()["lanes"]["device"]
    assert lane["alerting"] and lane["degraded_count"] == 1
    assert lane["last_degraded"]["size_bucket"] == "16MiB"
    after = [e for e in tfr.recorder().events()
             if e["kind"] == "comms_degraded"]
    assert len(after) - before == 1 and after[-1]["lane"] == "device"


# ---------------------------------------------------------------------------
# device-timed records
# ---------------------------------------------------------------------------

class _Event:
    """A CUDA event's stand-in: a time stamp in ms that has passed once
    ``done`` is set."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time of an unfinished event"
        return end.ms - self.ms


def test_spans_wait_for_the_device_then_record(tracker):
    s1, e1 = comms.Stamp(_Event(0.0), 1), comms.Stamp(_Event(4.0, False), 3)
    s2, e2 = comms.Stamp(_Event(1.0), 2), comms.Stamp(_Event(6.0, False), 4)
    try:
        tracker.record_span("allreduce", "device", 8 << 20,
                            comms.span(s1, e1))
        # pipelined: the second was stamped before the first's end, so it
        # is timed from that end (2 ms), not from its own start (5 ms)
        tracker.record_span("allreduce", "device", 8 << 20,
                            comms.span(s2, e2, after=e1))
        assert tracker.pending_spans() == 2 and tracker.sweep() == 0
        assert "device" not in tracker.ledger()["lanes"]
        e1.event.done = True
        assert tracker.sweep() == 1 and tracker.pending_spans() == 1
        e2.event.done = True
        led = tracker.ledger()  # a ledger sweeps first
        assert tracker.pending_spans() == 0
        key = led["keys"][0]
        assert key["ops"] == 2 and key["window_bytes"] == 16 << 20
        secs = (4.0 + 2.0) / 1e3
        assert key["algbw_gbs"] == round((16 << 20) / secs / 1e9, 4)
        # spent events went back to the pool: both starts and e1 (the
        # second's previous end), never a span's own end before its
        # successor was read
        assert {id(e) for e in comms._free_events} == {
            id(s1.event), id(s2.event), id(e1.event)}
        # stamped after the previous end: timed from its own start
        s3, e3 = comms.Stamp(_Event(7.0), 5), comms.Stamp(_Event(9.0), 6)
        sp = comms.span(s3, e3, after=e2)
        assert sp.begin is s3.event and comms.span_seconds(sp) == 0.002
        tracker.enabled = False
        tracker.record_span("allreduce", "device", 1, comms.span(s1, e1))
        assert tracker.pending_spans() == 0
    finally:
        comms._free_events.clear()


def test_the_executor_records_the_device_lane_once(monkeypatch):
    """One allreduce through the runtime on the CPU: one ``device`` record
    of its bytes with the host's seconds (the event path is the card's)."""
    import torch

    import horovod_tpu_torch as hvd

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        t = comms.tracker()
        t.reset()
        hvd.allreduce(torch.ones(1000), name="comms.one", op=hvd.Sum)
        hvd.allgather(torch.ones(10), name="comms.two")
    finally:
        hvd.shutdown()
    keys = {(k["op"], k["lane"]): k for k in t.ledger()["keys"]}
    assert keys[("allreduce", "device")]["window_bytes"] == 4000
    assert keys[("allreduce", "device")]["ops"] == 1
    assert keys[("allgather", "device")]["window_bytes"] == 40
    assert t.ledger()["lanes"]["device"]["busbw_gbs"] is None  # world 1


# ---------------------------------------------------------------------------
# configure, the route, the report, the trail
# ---------------------------------------------------------------------------

def test_knobs_and_provider_registration(singleton, monkeypatch):
    monkeypatch.setattr(tfr._recorder, "_providers",
                        dict(tfr._recorder._providers))
    monkeypatch.setenv("HOROVOD_COMMS", "1")
    monkeypatch.setenv("HOROVOD_COMMS_WINDOW", "7")
    monkeypatch.setenv("HOROVOD_COMMS_EWMA_ALPHA", "2.5")
    monkeypatch.setenv("HOROVOD_COMMS_DEGRADED_FRACTION", "0.3")
    comms.configure(rank=3, world=4)
    assert (singleton.rank, singleton.world, singleton.window,
            singleton.ewma_alpha, singleton.degraded_fraction) == \
        (3, 4, 7, 1.0, 0.3)
    assert "comms" in tfr._recorder._providers
    monkeypatch.setenv("HOROVOD_COMMS", "0")
    comms.configure()
    assert not singleton.enabled
    assert "comms" not in tfr._recorder._providers


def test_comms_route_and_the_jax_top_panel(singleton):
    from horovod_tpu_torch.metrics import MetricsRegistry

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import hvd_top

    singleton.seed_roofline("device", 20.0)
    singleton.record("allreduce", "device", 10 ** 9, 0.1, world=2)
    reg = MetricsRegistry()
    port = reg.serve(0)
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/comms" % port, timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["lanes"]["device"]["busbw_gbs"] == 10.0
        assert doc["enabled"] is True and doc["samples"]
        panel = hvd_top.render_comms(["127.0.0.1:%d" % port])
        assert "10.00/20.00 (50%)" in panel
    finally:
        reg.stop_server()


def test_profiler_snapshot_carries_the_samples(singleton):
    from horovod_tpu_torch import profiler

    singleton.record("allreduce", "device", 1 << 20, 0.001, world=2)
    snap = profiler.profiler().snapshot()
    assert snap["comms_samples"][-1][2] == "device"


def _lane(busbw, roofline=None, alerting=False, last=None):
    util = (busbw / roofline) if roofline else None
    return {"busbw_gbs": busbw, "peak_busbw_gbs": busbw,
            "roofline_gbs": roofline,
            "roofline_source": "probe" if roofline else "none",
            "utilization": util, "bytes_total": 1 << 30, "ops_total": 10,
            "alerting": alerting, "degraded_count": int(alerting),
            "last_degraded": last}


def _dump(rank, lanes):
    return {"schema": tfr.SCHEMA, "rank": rank, "launch_rank": rank,
            "pid": 1, "host": "h", "reason": "test", "wall_time": 0.0,
            "clock_offset_seconds": 0.0, "dump_history": [], "events": [],
            "state": {"comms": {"rank": rank, "world": 2, "wall_time": 0.0,
                                "degraded_fraction": 0.5, "lanes": lanes,
                                "keys": []}},
            "metrics": {}}


def test_report_is_the_jax_packages(tmp_path, monkeypatch):
    last = {"op": "allreduce", "size_bucket": "16MiB", "busbw_gbs": 1.0,
            "roofline_gbs": 10.0, "utilization": 0.1, "wall_time": 0.0}
    dumps = [_dump(0, {"device": _lane(9.0, 10.0),
                       "zero": _lane(4.0, 10.0)}),
             _dump(1, {"device": _lane(1.0, 10.0, True, last),
                       "kv": _lane(0.01)})]
    text = comms.format_comms_report(dumps)
    assert text == jcomms.format_comms_report(dumps)
    assert "slowest lane: zero" in text or "slowest lane: device" in text
    assert "furthest below roofline: rank 1 device" in text
    empty = _dump(0, {})
    empty["state"] = {}
    assert comms.format_comms_report([empty]) == "" == \
        jcomms.format_comms_report([empty])
    # a dump of the port's own tracker, read by both packages
    t = comms.tracker()
    t.reset()
    t.record("reducescatter", "zero", 3 << 20, 0.001, world=2)
    rec = tfr.FlightRecorder()
    rec.set_state_provider("comms", t.ledger)
    rec.dump("unit", path=str(tmp_path), ship=False)
    dumps = tfr.load_dumps(str(tmp_path))
    assert comms.format_comms_report(dumps) == \
        jcomms.format_comms_report(dumps)
    assert "zero" in comms.format_comms_report(dumps)
    t.reset()


def test_planes_cost_tool_rehearses_on_the_cpu():
    """``tools/planes_cost.py --cpu``: every config runs P2's step and
    prints its line (the card's numbers come from the same code)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("HOROVOD_")}
    env["PYTHONPATH"] = repo
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.planes_cost",
         "--cpu", "--steps", "1", "--turns", "1"], cwd=repo, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert [r["config"] for r in rows] == ["off", "flight", "memory",
                                           "comms", "goodput", "all"]
    assert all(r["dispatches_a_step"] == 2 and r["step_ms_median"] > 0
               for r in rows)
