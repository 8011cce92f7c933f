"""The port's flight recorder against the JAX package's (mirrors
tests/test_flight_recorder.py): the knob, the ring's bound, the dump's
keys and history, the state providers, the rate-limited failure dump, the
public ``dump_debug_state``, the ``/debug`` route, the signal handlers
chained to the ones before, the runtime's cycle-abort dump, the stall and
straggler events, and the postmortem readers.

The same event stream fed to both recorders gives dumps whose fields,
times aside, are equal; ``merge_events``, ``suspect_culprit`` and
``format_postmortem`` of each package give equal verdicts and strings on
the same dumps; and each package's ``load_dumps`` reads the other's
files. The killed-worker world is tests/test_torch_flight_recorder_
multiprocess.py."""

import json
import os
import signal
import threading
import time
import urllib.request

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import flight_recorder as jfr
from horovod_tpu.utils import env as jenv
from horovod_tpu_torch import flight_recorder as tfr
from horovod_tpu_torch.flight_recorder import SCHEMA, FlightRecorder
from horovod_tpu_torch.utils import env as tenv

_KNOBS = ("HOROVOD_FLIGHT_RECORDER", "HOROVOD_FLIGHT_RECORDER_DIR",
          "HOROVOD_RANK", "HOROVOD_RENDEZVOUS_HTTP_ADDR",
          "HOROVOD_RENDEZVOUS_HTTP_PORT")


@pytest.fixture
def rec(monkeypatch):
    """A private recorder: the module's own stays as the runtime left it."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    return FlightRecorder()


@pytest.fixture
def glob(monkeypatch, tmp_path):
    """The module's recorder with a dump directory, its history, rate
    limit and providers put back after the test."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    g = tfr.recorder()
    monkeypatch.setattr(g, "enabled", True)
    monkeypatch.setattr(g, "dir", str(tmp_path))
    monkeypatch.setattr(g, "_dump_history", [])
    monkeypatch.setattr(g, "_last_failure_dump", 0.0)
    monkeypatch.setattr(g, "_providers", dict(g._providers))
    return g


@pytest.mark.parametrize("value", [None, "", "0", "false", "no", "off",
                                   " OFF ", "512", "1", "yes", "x2"])
def test_knob_parses_as_the_jax_packages(value):
    assert tenv.parse_flight_recorder(value) == \
        jenv.parse_flight_recorder(value)
    assert tenv.DEFAULT_FLIGHT_RECORDER_CAPACITY == \
        jenv.DEFAULT_FLIGHT_RECORDER_CAPACITY


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_ring_overwrites_the_oldest(rec, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", "8")
    rec.configure()
    assert rec.capacity == 8
    for i in range(20):
        rec.emit("tick", i=i)
    evs = rec.events()
    assert [e["i"] for e in evs] == list(range(12, 20))
    assert all(e["kind"] == "tick" and "t" in e for e in evs)


def test_capacity_change_keeps_the_recent(rec, monkeypatch):
    for i in range(10):
        rec.emit("tick", i=i)
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", "4")
    rec.configure(rank=3)
    assert [e["i"] for e in rec.events()] == [6, 7, 8, 9]
    assert rec.rank == 3 and rec.launch_rank == 0


def test_disabled_emits_nothing(rec, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", "0")
    rec.configure()
    rec.emit("tick")
    assert rec.events() == []


def test_concurrent_emit_keeps_whole_records(rec, monkeypatch):
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", "256")
    rec.configure()
    barrier = threading.Barrier(8)

    def hammer(tid):
        barrier.wait()
        for i in range(2000):
            rec.emit("hammer", tid=tid, i=i)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    evs = rec.events()
    assert len(evs) == 256
    assert all(e["kind"] == "hammer" and "tid" in e and "i" in e
               for e in evs)


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

def _without_times(snap):
    out = {k: v for k, v in snap.items()
           if k not in ("wall_time", "pid", "metrics")}
    out["events"] = [{k: v for k, v in e.items() if k != "t"}
                     for e in snap["events"]]
    out["dump_history"] = [h["reason"] for h in snap["dump_history"]]
    return out


def test_same_stream_gives_the_jax_packages_dump(monkeypatch, tmp_path):
    """Both recorders fed the same events and providers: equal dumps but
    for the clocks, the pid and each package's own metric families."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOROVOD_RANK", "2")
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER", "16")
    ours, theirs = FlightRecorder(), jfr.FlightRecorder()
    for r in (ours, theirs):
        r.configure(rank=1)
        r.set_state_provider("thing", lambda: {"depth": 3, "names": ["a"]})
        r.set_state_provider("gone", lambda: 1)
        r.set_state_provider("gone", None)
        for i in range(20):
            r.emit("op_dispatch", op="ALLREDUCE", name=f"g.{i}", bytes=4 * i)
        r.emit("negotiate_end", name="g.19", skew=0.25)
        r.dump("first", path=str(tmp_path / type(r).__module__ / "x.json"))
    a = ours.dump("second", ship=False)
    b = theirs.dump("second", ship=False)
    assert _without_times(a) == _without_times(b)
    assert a["schema"] == b["schema"] == SCHEMA
    assert set(a) == set(b)
    assert a["launch_rank"] == 2 and a["rank"] == 1


def test_snapshot_and_failing_provider(rec):
    rec.emit("tick", i=1)
    rec.set_state_provider("thing", lambda: {"depth": 3})
    rec.set_state_provider("bad", lambda: 1 / 0)
    snap = rec.snapshot("unit")
    assert snap["reason"] == "unit" and snap["state"]["thing"] == {
        "depth": 3}
    assert "state provider failed" in snap["state"]["bad"]
    assert snap["events"][-1]["kind"] == "tick"
    assert "horovod_flight_recorder_events_total" in snap["metrics"]


def test_dump_paths_are_the_jax_packages(rec, tmp_path):
    theirs = jfr.FlightRecorder()
    rec.launch_rank = theirs.launch_rank = 3
    for target in (str(tmp_path), str(tmp_path / "x-{rank}.json"),
                   str(tmp_path / "exact.json")):
        assert rec._dump_path(target) == theirs._dump_path(target)
    assert rec._dump_path(str(tmp_path)).endswith("flight-rank-3.json")


def test_dump_writes_the_file_and_its_history(rec, tmp_path):
    rec.emit("tick", i=1)
    rec.dump("first", path=str(tmp_path))
    rec.dump("second", path=str(tmp_path))
    doc = json.load(open(tmp_path / "flight-rank-0.json"))
    assert doc["reason"] == "second"
    assert [h["reason"] for h in doc["dump_history"]] == ["first"]
    rec.dump("unit", path="/proc/does/not/exist/x.json")  # logged only


def test_dump_replaces_the_file_whole(rec, tmp_path, monkeypatch):
    """A dump goes to a hidden temp file that is then renamed over the
    last one, so a reader polling for the file never opens it half
    written (a reader once read an empty ``flight-rank-0.json``)."""
    import builtins

    rec.dump("first", path=str(tmp_path))
    written, real_open = [], builtins.open

    def spy(path, mode="r", *args, **kwargs):
        if "w" in mode:
            written.append(os.path.basename(str(path)))
        return real_open(path, mode, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", spy)
    rec.dump("second", path=str(tmp_path))
    monkeypatch.undo()
    assert written and "flight-rank-0.json" not in written
    assert all(w.startswith(".") and w.endswith(".tmp") for w in written)
    assert sorted(os.listdir(tmp_path)) == ["flight-rank-0.json"]
    assert json.load(open(tmp_path / "flight-rank-0.json"))["reason"] \
        == "second"


def test_failure_dumps_are_rate_limited(glob):
    tfr.dump_on_failure("one")
    tfr.dump_on_failure("two")  # within a second: suppressed
    assert [h["reason"] for h in glob._dump_history] == ["one"]


def test_dump_debug_state_at_the_package_root(glob, tmp_path):
    glob.dir = ""
    snap = hvd.dump_debug_state()
    assert snap["schema"] == SCHEMA and snap["reason"] == "on_demand"
    out = tmp_path / "dbg.json"
    hvd.dump_debug_state(path=str(out))
    assert tfr.load_dumps(str(tmp_path)) == []  # not a flight-rank file
    assert json.load(open(out))["reason"] == "on_demand"


def test_debug_route_serves_the_snapshot():
    from horovod_tpu_torch.metrics import MetricsRegistry

    reg = MetricsRegistry()
    port = reg.serve(0)
    try:
        tfr.emit("debug_probe", x=1)
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/debug" % port, timeout=5) as resp:
            assert resp.headers["Content-Type"] == "application/json"
            doc = json.loads(resp.read())
        assert doc["schema"] == SCHEMA and doc["reason"] == "debug_endpoint"
        assert any(e["kind"] == "debug_probe" for e in doc["events"])
    finally:
        reg.stop_server()


# ---------------------------------------------------------------------------
# signals
# ---------------------------------------------------------------------------

@pytest.fixture
def signals(glob):
    assert threading.current_thread() is threading.main_thread()
    saved = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGUSR1)}
    tfr.uninstall_signal_handlers()
    yield glob
    tfr.uninstall_signal_handlers()
    for s, h in saved.items():
        signal.signal(s, h)


def test_sigusr1_dumps_and_chains_then_uninstall_restores(signals):
    seen = []

    def before(signum, frame):
        seen.append(signum)

    signal.signal(signal.SIGUSR1, before)
    signal.signal(signal.SIGTERM, before)
    tfr.install_signal_handlers()
    assert signal.getsignal(signal.SIGUSR1) is not before
    os.kill(os.getpid(), signal.SIGUSR1)
    assert seen == [signal.SIGUSR1]
    assert [h["reason"] for h in signals._dump_history] == \
        ["signal:SIGUSR1"]
    signals._last_failure_dump = 0.0
    os.kill(os.getpid(), signal.SIGTERM)  # chained: the process lives on
    assert seen == [signal.SIGUSR1, signal.SIGTERM]
    assert signals._dump_history[-1]["reason"] == "signal:SIGTERM"
    tfr.uninstall_signal_handlers()
    assert signal.getsignal(signal.SIGUSR1) is before
    assert signal.getsignal(signal.SIGTERM) is before


def test_handlers_stay_off_other_threads(signals):
    before = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=tfr.install_signal_handlers)
    t.start()
    t.join()
    assert signal.getsignal(signal.SIGTERM) is before
    assert not tfr._signals_installed


# ---------------------------------------------------------------------------
# the runtime's hooks
# ---------------------------------------------------------------------------

@pytest.fixture
def world1(monkeypatch):
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_METRICS_PORT", "HOROVOD_TIMELINE"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()


def test_init_registers_the_runtime_and_shutdown_dumps(world1, glob,
                                                       tmp_path):
    world1.setenv("HOROVOD_FLIGHT_RECORDER_DIR", str(tmp_path))
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="fr.init")
    snap = tfr.debug_state()
    for name in ("runtime", "memory", "comms", "goodput"):
        assert name in snap["state"], name
    assert any(e["kind"] == "init" for e in snap["events"])
    hvd.shutdown()
    doc = tfr.load_dumps(str(tmp_path))[0]
    assert doc["reason"] == "shutdown"
    kinds = [e["kind"] for e in doc["events"]]
    assert "runtime_stop" in kinds and kinds[-1] == "shutdown"
    assert not tfr._signals_installed


def test_cycle_abort_emits_and_dumps(world1, glob, tmp_path):
    from horovod_tpu_torch.runtime import runtime as trt

    world1.setenv("HOROVOD_FLIGHT_RECORDER_DIR", str(tmp_path))
    hvd.init(device="cpu")
    rt = trt.get_runtime()

    def boom(*a, **k):
        raise RuntimeError("injected cycle failure")

    world1.setattr(rt.controller, "compute_response_list", boom)
    h = hvd.allreduce_async(torch.ones(2), name="fr/abort")
    with pytest.raises(RuntimeError):
        hvd.synchronize(h)
    path = tmp_path / "flight-rank-0.json"
    deadline = time.monotonic() + 10
    while not path.exists() and time.monotonic() < deadline:
        time.sleep(0.05)
    doc = json.load(open(path))
    assert doc["reason"] == "cycle_abort"
    aborts = [e for e in doc["events"] if e["kind"] == "cycle_abort"]
    assert aborts and "injected cycle failure" in aborts[-1]["error"]


def test_straggler_report_and_stall_events():
    from horovod_tpu_torch import stall
    from horovod_tpu_torch.exceptions import WorkerStallError

    tr = stall.StragglerTracker(world=2, report_seconds=0.001)
    tr._last_report = time.monotonic() - 60
    tr.observe("t", {0: 1.0, 1: 1.2})
    reports = [e for e in tfr.recorder().events()
               if e["kind"] == "straggler_report"]
    assert reports and reports[-1]["leader"] == 1
    now = time.monotonic()

    class Table:
        def pending(self):
            return {"grad/x": [type("R", (), {"rank": 0})()]}

        def first_request_time(self, name):
            return now - 100

    insp = stall.StallInspector(warning_time_seconds=0.0,
                                shutdown_time_seconds=0.001, elastic=True)
    with pytest.raises(WorkerStallError):
        insp.check(Table(), world=2)
    evs = tfr.recorder().events()
    assert [e for e in evs if e["kind"] == "stall_warning"][-1][
        "missing"] == [1]
    assert [e for e in evs if e["kind"] == "stall_shutdown"][-1][
        "ranks"] == [1]


# ---------------------------------------------------------------------------
# the postmortem readers, against the JAX package's
# ---------------------------------------------------------------------------

def _dump(rank, events, offset=None, reason="test", metrics=None):
    return {"schema": SCHEMA, "rank": rank, "launch_rank": rank,
            "pid": 1000 + rank, "host": "host%d" % rank, "reason": reason,
            "wall_time": 0.0, "clock_offset_seconds": offset,
            "dump_history": [], "events": events, "state": {},
            "metrics": metrics or {}}


_LAG = {"horovod_straggler_lag_seconds": {"values": [
    {"labels": {"rank": "0"}, "value": 0.01},
    {"labels": {"rank": "2"}, "value": 0.42}]}}

_SCENARIOS = {
    "kill_wins": [
        _dump(0, [{"t": 1, "kind": "workers_down", "ranks": [2]}]),
        _dump(1, [{"t": 1, "kind": "fault_inject", "action": "kill",
                   "rank": 1}], reason="fault_inject_kill")],
    "digest_vote": [
        _dump(0, [{"t": 2, "kind": "rollback", "suspect": 3,
                   "error": "NumericalError: x"}]),
        _dump(1, [{"t": 1, "kind": "workers_down", "ranks": [2]}])],
    "workers_down_votes": [
        _dump(0, [{"t": 1, "kind": "workers_down", "ranks": [2]},
                  {"t": 2, "kind": "stall_shutdown", "ranks": [2]}]),
        _dump(1, [{"t": 1, "kind": "workers_down", "ranks": [2, 3]}])],
    "reform_membership": [
        _dump(0, [{"t": 5, "kind": "elastic_reform", "generation": 1,
                   "members": [0, 2], "old_size": 3}], offset=0.5),
        _dump(2, [{"t": 4, "kind": "elastic_reform", "generation": 1,
                   "members": [0, 2], "old_size": 3}], offset=-0.25)],
    "straggler_lag": [_dump(0, [], metrics=_LAG)],
    "none": [_dump(0, [{"t": 10.0 + i, "kind": "tick", "i": i}
                       for i in range(50)], offset=0.0)],
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_postmortem_readers_are_the_jax_packages(name):
    dumps = _SCENARIOS[name]
    assert tfr.suspect_culprit(dumps) == jfr.suspect_culprit(dumps)
    assert tfr.merge_events(dumps) == jfr.merge_events(dumps)
    for last_n in (10, 40):
        assert tfr.format_postmortem(dumps, last_n=last_n) == \
            jfr.format_postmortem(dumps, last_n=last_n)


def test_culprit_verdicts():
    assert tfr.suspect_culprit(_SCENARIOS["kill_wins"])[0] == 1
    assert tfr.suspect_culprit(_SCENARIOS["digest_vote"])[0] == 3
    assert tfr.suspect_culprit(_SCENARIOS["workers_down_votes"])[0] == 2
    assert tfr.suspect_culprit(_SCENARIOS["reform_membership"])[0] == 1
    assert tfr.suspect_culprit(_SCENARIOS["straggler_lag"])[0] == "2"
    assert tfr.suspect_culprit(_SCENARIOS["none"]) is None
    merged = tfr.merge_events(_SCENARIOS["reform_membership"])
    assert [e["rank"] for e in merged] == [2, 0]
    assert merged[1]["t_merged"] == 5.5


def test_each_package_reads_the_others_dumps(tmp_path, monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    ours, theirs = FlightRecorder(), jfr.FlightRecorder()
    ours.launch_rank, theirs.launch_rank = 0, 1
    for r in (ours, theirs):
        r.emit("fault_inject", action="kill", rank=r.launch_rank)
        r.dump("cross", path=str(tmp_path), ship=False)
    (tmp_path / "flight-rank-9.json").write_text("{truncated")
    a, b = tfr.load_dumps(str(tmp_path)), jfr.load_dumps(str(tmp_path))
    assert [d["launch_rank"] for d in a] == [0, 1]
    assert a == b
    assert tfr.format_postmortem(a) == jfr.format_postmortem(b)
    lineage = {"attempts": [{"attempt": 1, "restart_budget": 3,
                             "exit_code": 17, "started": 1.0,
                             "ended": 4.5}]}
    (tmp_path / "restart-lineage.json").write_text(json.dumps(lineage))
    assert tfr.load_restart_lineage(str(tmp_path)) == lineage
    assert tfr.format_postmortem(a, lineage=lineage) == \
        jfr.format_postmortem(a, lineage=lineage)
    assert tfr.load_dumps(str(tmp_path / "missing")) == []
