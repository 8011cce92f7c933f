"""The port's step profiler (``horovod_tpu_torch/profiler.py``) against the
JAX package's (``horovod_tpu/profiler.py``), mirroring
``tests/test_profiler.py``.

* The same ``step`` / ``annotate`` / ``auto_step`` sequence through both
  ``StepProfiler`` classes, on one scripted clock, one scripted comm clock
  and one scripted handle-wait sum: equal breakdowns (``t_start`` and
  ``peak_hbm_bytes`` aside, which read the wall clock and the device),
  equal summaries and equal step markers.
* The phases sum to the wall exactly; the rolling MFU gauge follows its
  formula; no peak, no MFU.
* The dump's keys and markers are the JAX package's; ``merge_profile_dir``
  and ``format_step_report`` give the JAX functions' output on the same
  files, byte for byte.
* The knobs, ``GET /profile``, the device trace (``HOROVOD_PROFILE_JAX``),
  the card's synchronize at each boundary, and nothing at all (no record,
  no synchronize, no wrapper) with profiling off.
"""

import json
import os
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import profiler as jprof
from horovod_tpu_torch import profiler as tprof
from horovod_tpu_torch.runtime import executor as texec
from horovod_tpu_torch.metrics import registry as metrics_registry
from horovod_tpu_torch.training import make_train_round, make_train_step
from horovod_tpu_torch.utils import env


@pytest.fixture(autouse=True)
def _pristine(monkeypatch):
    """Each test starts with the port's process profiler off and empty."""
    for knob in (env.HOROVOD_PROFILE, env.HOROVOD_PROFILE_DIR,
                 env.HOROVOD_PROFILE_JAX, env.HOROVOD_PROFILE_HISTORY):
        monkeypatch.delenv(knob, raising=False)
    hvd.shutdown()
    monkeypatch.setattr(tprof, "_profiler", tprof.StepProfiler())
    yield
    hvd.shutdown()


class _Script:
    """One scripted clock and accumulator set for both profilers: time
    moves only when the test says so."""

    def __init__(self):
        self.t = 100.0
        self.comm = {"total_seconds": 0.0, "exposed_seconds": 0.0,
                     "total_bytes": 0, "hidden_bytes": 0.0, "ops": 0}
        self.wait = 0.0
        self.time = types.SimpleNamespace(
            perf_counter=lambda: self.t, time=lambda: 1.7e9 + self.t,
            monotonic=lambda: self.t)

    def advance(self, dt, wait=0.0, comm=0.0, exposed=0.0, nbytes=0):
        self.t += dt
        self.wait += wait
        if comm:
            self.comm["total_seconds"] += comm
            self.comm["exposed_seconds"] += exposed
            self.comm["total_bytes"] += nbytes
            self.comm["hidden_bytes"] += nbytes * (1.0 - exposed / comm)
            self.comm["ops"] += 1


@pytest.fixture
def script(monkeypatch):
    s = _Script()
    for mod in (jprof, tprof):
        monkeypatch.setattr(mod, "time", s.time)
        monkeypatch.setattr(mod, "_handle_wait_seconds", lambda: s.wait)
    monkeypatch.setattr(jprof, "_comm_totals", lambda: dict(s.comm))
    monkeypatch.setattr(texec, "comm_totals", lambda: dict(s.comm))
    return s


def _drive(p, s):
    """Explicit steps, annotations, implicit steps, an explicit step that
    closes an implicit one, and a step whose annotations and waits
    overrun its wall (the proportional scale-down)."""
    p.enabled = True
    p.set_flops_per_step(3.0e9, peak_flops_per_chip=1.0e12)
    with p.step("first"):
        s.advance(0.010)
        with p.annotate("host"):
            s.advance(0.020)
        s.advance(0.030, wait=0.004, comm=0.012, exposed=0.004,
                  nbytes=4096)
        with p.annotate("optimizer"):
            s.advance(0.008)
    for _ in range(3):
        p.auto_step()
        with p.annotate("input"):
            s.advance(0.003)
        s.advance(0.025, wait=0.002, comm=0.006, exposed=0.002,
                  nbytes=1024)
        with p.annotate("optimizer"):
            s.advance(0.005)
    p.set_flops_per_step(None)
    with p.step():  # closes the open implicit step first
        with p.annotate("host"):
            s.advance(0.020)
        s.advance(0.010, wait=0.050, comm=0.050, exposed=0.050,
                  nbytes=64)
    with p.step("nested"):
        with p.step("inner"):  # a no-op level
            s.advance(0.001)
    p.auto_step()  # left open: not in the history
    s.advance(0.004)


def _strip(history):
    return [{k: v for k, v in rec.items()
             if k not in ("t_start", "peak_hbm_bytes")} for rec in history]


def test_breakdowns_equal_the_jax_profilers_on_one_clock(script):
    jp, tp = jprof.StepProfiler(), tprof.StepProfiler()
    _drive(jp, script)
    script.t, script.wait = 100.0, 0.0
    script.comm = dict.fromkeys(script.comm, 0)
    _drive(tp, script)
    want, got = jp.history(), tp.history()
    assert len(got) == len(want) == 6
    assert _strip(got) == _strip(want)
    assert [r["t_start"] for r in got] == [r["t_start"] for r in want]
    assert tp.summary() == jp.summary()
    assert list(tp._trace_events) == list(jp._trace_events)
    assert [r["auto"] for r in got] == [False, True, True, True, False,
                                        False]
    scaled = got[4]["phases"]
    assert scaled["compute"] == 0.0 and scaled["host"] > 0.0
    for rec in got:
        assert sum(rec["phases"].values()) == pytest.approx(
            rec["wall_seconds"], abs=1e-12)
    assert got[0]["comm"] == {"total_seconds": pytest.approx(0.012),
                              "exposed_seconds": pytest.approx(0.004),
                              "bytes": 4096, "dispatches": 1,
                              "hidden_fraction": pytest.approx(2 / 3),
                              "hidden_fraction_bytes": pytest.approx(2 / 3)}


def test_phases_sum_to_wall_exactly():
    p = tprof.profiler()
    p.enabled = True
    with p.step("attributed") as rec:
        with p.annotate("host"):
            time.sleep(0.02)
        time.sleep(0.03)  # unannotated: compute
        with p.annotate("optimizer"):
            time.sleep(0.01)
    b = rec.breakdown
    assert sum(b["phases"].values()) == pytest.approx(b["wall_seconds"],
                                                      abs=1e-9)
    assert b["phases"]["host"] == pytest.approx(0.02, abs=0.015)
    assert b["phases"]["optimizer"] == pytest.approx(0.01, abs=0.015)
    assert b["phases"]["compute"] > 0.02
    assert b["peak_hbm_bytes"] is None  # the CPU reports none
    with pytest.raises(ValueError):
        p.annotate("backward").__enter__()


def test_mfu_gauge_follows_the_rolling_formula():
    p = tprof.profiler()
    p.enabled = True
    flops, peak = 2.0e9, 1.0e12
    p.set_flops_per_step(flops, peak_flops_per_chip=peak)
    count0 = tprof._STEP_SECONDS.labels().count
    for _ in range(3):
        with p.step():
            time.sleep(0.002)
    steps = p.history()
    for s in steps:
        assert s["mfu"] == pytest.approx(flops / s["wall_seconds"] / peak,
                                         rel=1e-12)
    assert tprof._MFU.value == pytest.approx(
        sum(s["mfu"] for s in steps) / 3, rel=1e-12)
    assert tprof._STEP_SECONDS.labels().count == count0 + 3
    assert 0.0 <= tprof._HIDDEN_FRACTION.value <= 1.0
    q = tprof.StepProfiler()
    q.enabled = True
    q.set_flops_per_step(1e9)  # no peak: no MFU
    with q.step() as rec:
        pass
    assert rec.breakdown["mfu"] is None


def test_dump_keys_and_markers_are_the_jax_packages(tmp_path, script):
    jp, tp = jprof.StepProfiler(), tprof.StepProfiler()
    for p in (jp, tp):
        script.t = 100.0
        p.enabled = True
        with p.step("dumped"):
            script.advance(0.001)
    want = jp.dump(str(tmp_path / "jax" / "profile-rank-0.json"),
                   ship=False)
    got = tp.dump(str(tmp_path / "port" / "profile-rank-0.json"))
    doc = json.load(open(tmp_path / "port" / "profile-rank-0.json"))
    assert set(doc) == set(want) == set(got)
    assert doc["schema"] == "horovod-profiler-v1"
    assert doc["trace_events"] == want["trace_events"]
    assert _strip(doc["steps"]) == _strip(want["steps"])


def _fake_dump(rank, t0, offset=0.0, n_steps=3):
    """tests/test_profiler.py's fake dump, with every plane's events."""
    events, steps = [], []
    for i in range(n_steps):
        start = t0 + 0.1 * i
        steps.append({"step": i + 1, "name": f"step {i}", "auto": False,
                      "t_start": start, "wall_seconds": 0.05 * (rank + 1),
                      "phases": {"host": 0.01, "compute": 0.03,
                                 "exposed_comm": 0.005 * (rank + 1),
                                 "optimizer": 0.005},
                      "comm": {"total_seconds": 0.01,
                               "exposed_seconds": 0.005, "bytes": 1024,
                               "hidden_fraction": 0.5,
                               "hidden_fraction_bytes": 0.5},
                      "mfu": 0.4 if rank == 0 else None})
        events.append({"ph": "X", "pid": 0, "tid": 0, "ts": start * 1e6,
                       "dur": 0.05 * 1e6, "name": f"step {i}"})
    return {"schema": "horovod-profiler-v1", "rank": rank,
            "launch_rank": rank, "clock_offset_seconds": offset,
            "steps": steps, "trace_events": events,
            "flight_events": [{"t": t0, "kind": "init", "rank": rank}],
            "memory_samples": [[t0 + 0.01, 100, 90], ["bad"]],
            "comms_samples": [[t0 + 0.02, 12.5, "device"]],
            "goodput_samples": [[t0 + 0.03, 0.9]],
            "goodput_incidents": [{"wall_time": t0 + 0.04,
                                   "cause": "stall", "generation": 1}],
            "request_spans": [{"t": t0 + 0.05 * rank, "dur": 0.01,
                               "name": "request.serve",
                               "trace_id": "abc"}]}


def test_merge_and_report_equal_the_jax_functions(tmp_path):
    t0 = 1700000000.0
    for rank, offset in ((0, 0.0), (1, 2.5)):
        with open(tmp_path / f"profile-rank-{rank}.json", "w") as f:
            json.dump(_fake_dump(rank, t0, offset), f)
        with open(tmp_path / f"timeline-rank-{rank}.json", "w") as f:
            f.write(json.dumps([
                {"ph": "B", "pid": 9, "tid": 3, "ts": t0 * 1e6,
                 "name": "ALLREDUCE"},
                {"ph": "E", "pid": 9, "tid": 3,
                 "ts": (t0 + 0.01) * 1e6}])[:-1] + ",")
    dev = tmp_path / "jax-rank-1"
    dev.mkdir()
    with open(dev / tprof.DEVICE_TRACE, "w") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "pid": 0, "tid": 7, "ts": t0 * 1e6 + 5, "dur": 3,
             "name": "kernel"}]}, f)
    out_j, n_j = jprof.merge_profile_dir(str(tmp_path),
                                         str(tmp_path / "j.out"))
    out_t, n_t = tprof.merge_profile_dir(str(tmp_path),
                                         str(tmp_path / "t.out"))
    assert n_t == n_j > 0
    assert open(out_t).read() == open(out_j).read()
    labels = {e["args"]["labels"] for e in json.load(open(out_t))
              ["traceEvents"] if e.get("name") == "process_labels"}
    assert {"rank 0 steps", "rank 1 steps", "rank 0 timeline",
            "rank 1 device", "rank 0 requests"} <= labels
    dumps = tprof.load_dumps(str(tmp_path))
    assert dumps == jprof.load_dumps(str(tmp_path))
    report = tprof.format_step_report(dumps)
    assert report == jprof.format_step_report(dumps)
    assert "slowest: rank 1" in report
    assert tprof.format_step_report([]) == jprof.format_step_report([])


def test_knobs_defaults_and_profile_dir_implies_enable(monkeypatch):
    cfg = env.Config.from_env()
    assert (cfg.profile, cfg.profile_dir, cfg.profile_history,
            cfg.profile_jax) == (False, "", env.DEFAULT_PROFILE_HISTORY,
                                 False)
    assert env.DEFAULT_PROFILE_HISTORY == \
        jprof.DEFAULT_PROFILE_HISTORY == 64
    monkeypatch.setenv(env.HOROVOD_PROFILE_DIR, "/tmp/prof")
    monkeypatch.setenv(env.HOROVOD_PROFILE_HISTORY, "5")
    cfg = env.Config.from_env()
    assert cfg.profile is True and cfg.profile_dir == "/tmp/prof"
    p = tprof.StepProfiler()
    p.configure(config=cfg)
    assert p.enabled and p.history_cap == 5 and p._steps.maxlen == 5


def test_profile_endpoint_serves_the_state(monkeypatch):
    monkeypatch.setenv(env.HOROVOD_PROFILE, "1")
    monkeypatch.setenv("HOROVOD_METRICS_PORT", "0")
    hvd.init(device="cpu")
    assert tprof.enabled()
    with hvd.profiler.step("served"):
        pass
    port = metrics_registry().http_port
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/profile",
                                timeout=5) as resp:
        assert resp.headers["Content-Type"].startswith("application/json")
        doc = json.loads(resp.read())
    assert doc["schema"] == "horovod-profiler-v1" and doc["enabled"]
    assert [s["name"] for s in doc["steps"]] == ["served"]
    assert set(doc) == {"schema", "rank", "launch_rank", "enabled",
                        "summary", "steps"}


def test_allreduce_moves_the_comm_clock_and_the_exposed_counter(monkeypatch):
    monkeypatch.setenv(env.HOROVOD_PROFILE, "1")
    hvd.init(device="cpu")
    exposed0 = texec._COMM_EXPOSED.value
    c0 = texec.comm_totals()
    with hvd.profiler.step() as rec:
        hvd.allreduce(torch.ones(256), name="prof.clock")
    c1 = texec.comm_totals()
    comm = rec.breakdown["comm"]
    assert (comm["bytes"], comm["dispatches"]) == (1024, 1)
    assert c1["ops"] - c0["ops"] == 1
    assert c1["total_seconds"] > c0["total_seconds"]
    assert texec._COMM_EXPOSED.value - exposed0 == pytest.approx(
        c1["exposed_seconds"] - c0["exposed_seconds"], abs=1e-12)


def test_off_by_default_no_record_no_sync_no_wrapper(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    hvd.init(device="cpu")
    assert not hvd.profiler.enabled()
    p = tprof.profiler()
    p.device = torch.device("cuda", 0)  # a card would not be touched either
    with hvd.profiler.step("off") as rec:
        with hvd.profiler.annotate("host"):
            pass
    hvd.profiler.auto_step()
    assert rec is None and hvd.profiler.history() == [] and not syncs
    model = torch.nn.Linear(4, 2)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1))
    for build in (make_train_step, make_train_round):
        step = build(model, opt)
        assert not hasattr(step, "__wrapped__")
        step(torch.ones(3, 4), torch.zeros(3, dtype=torch.long))
    assert hvd.profiler.history() == [] and not syncs


def test_on_the_card_each_boundary_waits_for_the_device(monkeypatch):
    """One synchronize where a step opens and one where it closes (an
    implicit step's close is the next one's open); the peak is the
    allocator's."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: 12345)
    p = tprof.profiler()
    p.enabled, p.device = True, torch.device("cuda", 0)
    with p.step():
        assert len(syncs) == 1
    assert len(syncs) == 2
    p.auto_step()
    p.auto_step()
    p.auto_step()
    assert len(syncs) == 5
    p.dump()  # closes the open implicit step
    assert len(syncs) == 6 and set(syncs) == {p.device}
    assert [r["peak_hbm_bytes"] for r in p.history()] == [12345] * 4


def test_device_trace_is_written_and_merged(monkeypatch, tmp_path):
    """``HOROVOD_PROFILE_JAX`` with a profile dir: a torch.profiler trace
    from init() to shutdown() lands under ``jax-rank-0`` and merges as
    rank 0's device lane beside its step markers."""
    monkeypatch.setenv(env.HOROVOD_PROFILE_DIR, str(tmp_path))
    monkeypatch.setenv(env.HOROVOD_PROFILE_JAX, "1")
    hvd.init(device="cpu")
    with hvd.profiler.step("traced"):
        torch.ones(64).sum()
    hvd.shutdown()
    assert (tmp_path / "jax-rank-0" / tprof.DEVICE_TRACE).exists()
    assert [d["steps"][0]["name"] for d in tprof.load_dumps(
        str(tmp_path))] == ["traced"]
    out, n = tprof.merge_profile_dir(str(tmp_path))
    events = json.load(open(out))["traceEvents"]
    labels = {e["args"]["labels"] for e in events
              if e.get("name") == "process_labels"}
    assert {"rank 0 steps", "rank 0 device"} <= labels
    (marker,) = [e for e in events
                 if e.get("name") == "traced" and e.get("ph") == "X"]
    # the device lane is on the markers' clock (epoch us), with int pids
    device_pids = {e["pid"] for e in events
                   if e.get("name") == "process_labels"
                   and e["args"]["labels"] == "rank 0 device"}
    device = [e for e in events if e.get("pid") in device_pids
              and e.get("ph") == "X"]
    assert device and all(isinstance(e["pid"], int) for e in events)
    assert all(abs(e["ts"] - marker["ts"]) < 60e6 for e in device)


def test_failed_device_trace_raises(monkeypatch, tmp_path):
    """The JAX package only warns; the port raises."""
    monkeypatch.setenv(env.HOROVOD_PROFILE_DIR, str(tmp_path))
    monkeypatch.setenv(env.HOROVOD_PROFILE_JAX, "1")

    def refuse(*args, **kwargs):
        raise RuntimeError("no tracer")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with pytest.raises(RuntimeError, match="no tracer"):
        tprof.StepProfiler().configure()


def test_history_knob_and_rank_reach_the_dump(monkeypatch, tmp_path):
    monkeypatch.setenv(env.HOROVOD_PROFILE_DIR, str(tmp_path))
    monkeypatch.setenv(env.HOROVOD_PROFILE_HISTORY, "2")
    hvd.init(device="cpu")
    for _ in range(3):
        with hvd.profiler.step():
            pass
    hvd.shutdown()
    (dump,) = tprof.load_dumps(str(tmp_path))
    assert [s["step"] for s in dump["steps"]] == [2, 3]
    assert dump["rank"] == dump["launch_rank"] == 0
    assert np.isfinite([s["wall_seconds"] for s in dump["steps"]]).all()
