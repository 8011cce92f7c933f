"""The port's goodput ledger against the JAX package's (mirrors
tests/test_goodput.py, but for its bench cases, which wait for the port's
bench): fractions, spans, the startup gap, the over-attribution scale, the
frontier guard between the profiler's and ``State.commit``'s step
sources, incidents, the replay countdown, the serving plane's calls (their
names only), the knobs, the epoch kept across ``reinit()``, the
``/goodput`` route, the profiler's trails and the postmortem report.

Each scenario runs the same calls on both trackers on one frozen clock and
gives bit-equal ledgers, samples and incidents."""

import json
import os
import sys
import urllib.request

import pytest

from horovod_tpu import flight_recorder as jfr
from horovod_tpu import goodput as jgp
from horovod_tpu_torch import flight_recorder as tfr
from horovod_tpu_torch import goodput


class _Clock:
    def __init__(self):
        self.mono, self.wall = 1000.0, 1700000000.0

    def advance(self, s):
        self.mono += s
        self.wall += s


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr("time.monotonic", lambda: c.mono)
    monkeypatch.setattr("time.time", lambda: c.wall)
    return c


def _pair(rank=0, world=2):
    out = []
    for cls in (goodput.GoodputTracker, jgp.GoodputTracker):
        t = cls()
        t.enabled, t.rank, t.world = True, rank, world
        t.start_epoch()
        out.append(t)
    return out


# each scenario: a list of (advance seconds, method, args, kwargs)
_SCENARIOS = {
    "steps_and_spans": [
        (3600, "record_step", (0.5,), {}),
        (1, "record_span", ("ckpt_stall", 0.2), {}),
        (1, "record_span", ("collective_stall", 0.1), {}),
        (0.5, "record_step", (0.3,), {"exposed_comm": 0.1}),
        (0, "record_span", ("coffee_break", 5.0), {}),
        (0, "record_span", ("straggler_wait", -1.0), {})],
    "startup_gap": [(0.05, "record_step", (0.01,), {})],
    "all_startup": [(0.02, "record_span", ("unknown", 1.0), {})],
    "over_attribution": [
        (1, "record_span", ("ckpt_stall", 3600.0), {}),
        (0, "record_span", ("rollback", 3600.0), {})],
    "profiler_clamped": [
        (10, "record_step", (1e-4,), {}),
        (0.01, "record_step", (3600.0,), {})],
    "commit_source": [
        (1, "record_step", (1e-4,), {}),
        (0.03, "record_span", ("elastic_reform", 0.025), {}),
        (0, "record_step", (), {"step": 4}),
        (0.2, "record_step", (), {}),
        (0.0, "record_step", (0.1,), {})],
    "replay_countdown": [
        (3600, "record_step", (0.1,), {}),
        (0, "note_incident", ("rollback", 0.5),
         {"replay_steps": 2, "culprit_rank": 1,
          "linked_events": ["rollback", "integrity_violation"]}),
        (1, "record_step", (0.2,), {}),
        (1, "record_step", (0.2,), {}),
        (1, "record_step", (0.1,), {})],
    "reform_incident": [
        (3600, "record_step", (0.1,), {}),
        (0, "note_incident", ("elastic_reform", 2.5),
         {"generation": 1, "culprit_rank": 3, "replay_steps": 1,
          "linked_events": ["elastic_reform", "workers_down"],
          "detail": "rank 3 lost"}),
        (3, "record_step", (0.3,), {}),
        (0, "note_incident", ("meteor_strike", 1.0), {})],
    "serving_calls": [
        (3600, "record_serve_step", (0.4,), {"tokens": 4}),
        (0, "record_serve_step", (9.0,), {"tokens": 0}),
        (0, "note_serve_preempted", (2,), {}),
        (0, "note_serve_preempted", (1000,), {})],
}


def _run(t, clock, script):
    for adv, meth, args, kw in script:
        clock.advance(adv)
        getattr(t, meth)(*args, **kw)
    clock.advance(0.5)
    return t.ledger(), t.samples(), t.incidents()


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_scenario_is_the_jax_packages(clock, name):
    ours, theirs = _pair()
    start = (clock.mono, clock.wall)
    a = _run(ours, clock, _SCENARIOS[name])
    clock.mono, clock.wall = start
    b = _run(theirs, clock, _SCENARIOS[name])
    assert a == b
    led = a[0]
    total = led["productive_seconds"] + sum(led["badput_seconds"].values())
    assert total == pytest.approx(led["wall_seconds"], abs=1e-4)
    assert 0.0 <= led["accounted_fraction"] <= 1.0 + 1e-9


def test_scenarios_account_as_the_reference_says(clock):
    ours, _ = _pair()
    led, _, incs = _run(ours, clock, _SCENARIOS["replay_countdown"])
    assert (led["steps_productive"], led["steps_replayed"]) == (2, 2)
    assert led["badput_seconds"]["rollback"] == pytest.approx(0.9, abs=1e-4)
    assert incs[0]["steps_replayed"] == 2 and incs[0]["culprit_rank"] == 1
    ours, _ = _pair()
    led, _, _ = _run(ours, clock, _SCENARIOS["commit_source"])
    assert led["badput_seconds"]["elastic_reform"] == pytest.approx(0.025)
    assert led["steps_productive"] == 3
    ours, _ = _pair()
    led, _, _ = _run(ours, clock, _SCENARIOS["startup_gap"])
    assert led["badput_seconds"]["startup_compile"] == pytest.approx(0.04)


def test_disabled_and_bounded(clock):
    t, _ = _pair()
    t.set_incident_capacity(4)
    for i in range(10):
        t.note_incident("rollback", 0.01, detail="inc %d" % i)
    assert len(t.incidents()) == 4 and t.incidents()[-1]["detail"] == \
        "inc 9"
    assert t.ledger()["incident_counts"]["rollback"] == 10
    t.reset()
    t.enabled = False
    t.record_step(0.5)
    t.note_incident("rollback", 1.0)
    led = t.ledger()
    assert led["steps_productive"] == 0 and led["incidents"] == []
    assert goodput.CATEGORIES == jgp.CATEGORIES


def test_incident_is_a_flight_event():
    t, _ = _pair()
    before = len(tfr.recorder().events())
    t.note_incident("rollback", 0.5, culprit_rank=1, replay_steps=2)
    ev = [e for e in tfr.recorder().events()[before:]
          if e["kind"] == "goodput_incident"]
    assert len(ev) == 1 and ev[0]["cause"] == "rollback"
    assert ev[0]["culprit_rank"] == 1 and ev[0]["replay_steps"] == 2


@pytest.fixture
def singleton(monkeypatch):
    t = goodput.tracker()
    saved = (t.enabled, t.rank, t.world, t.report_seconds)
    monkeypatch.setattr(tfr._recorder, "_providers",
                        dict(tfr._recorder._providers))
    t.reset()
    t.enabled = True
    t.start_epoch()
    yield t
    t.reset()
    t.set_incident_capacity(goodput.DEFAULT_INCIDENT_CAPACITY)
    t.enabled, t.rank, t.world, t.report_seconds = saved


def test_knobs_and_provider_registration(singleton, monkeypatch):
    monkeypatch.setenv("HOROVOD_GOODPUT", "1")
    monkeypatch.setenv("HOROVOD_GOODPUT_INCIDENTS", "7")
    monkeypatch.setenv("HOROVOD_GOODPUT_REPORT_SECONDS", "30")
    goodput.configure(rank=3, world=4)
    assert (singleton.rank, singleton.world, singleton.report_seconds) == \
        (3, 4, 30.0)
    assert singleton._incidents.maxlen == 7
    assert "goodput" in tfr._recorder._providers
    monkeypatch.setenv("HOROVOD_GOODPUT", "0")
    goodput.configure()
    assert not singleton.enabled and "goodput" not in tfr._recorder._providers


def test_epoch_is_the_first_inits_and_stays_across_reinit(singleton,
                                                          monkeypatch):
    import torch

    import horovod_tpu_torch as hvd

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_GOODPUT"):
        monkeypatch.delenv(k, raising=False)
    singleton.reset()
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        epoch = singleton._epoch
        assert epoch is not None
        hvd.allreduce(torch.ones(2), name="gp.reinit")
        hvd.reinit()
        assert singleton._epoch == epoch
    finally:
        hvd.shutdown()


def test_goodput_route_and_the_jax_top_panel(singleton):
    from horovod_tpu_torch.metrics import MetricsRegistry

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import hvd_top

    singleton.record_step(0.05)
    singleton.note_incident("rollback", 0.2, culprit_rank=1)
    reg = MetricsRegistry()
    port = reg.serve(0)
    try:
        ep = "127.0.0.1:%d" % port
        with urllib.request.urlopen("http://%s/goodput" % ep,
                                    timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["steps_productive"] == 1 and doc["samples"]
        assert 0.0 <= doc["goodput_fraction"] <= 1.0
        panel = hvd_top.render_goodput([ep])
        assert "last incident: rollback" in panel
        routes = hvd_top.discover_routes([ep])
        assert {"/goodput", "/comms", "/memory", "/debug"} <= set(routes)
    finally:
        reg.stop_server()


def test_the_profilers_dump_carries_the_trails(singleton, tmp_path):
    from horovod_tpu import profiler as jprof
    from horovod_tpu_torch import profiler

    p = profiler.profiler()
    singleton.note_incident("elastic_reform", 0.1, culprit_rank=2)
    saved = p.enabled
    p.enabled = True
    try:
        with p.step("gp"):
            pass
        snap = p.snapshot()
    finally:
        p.enabled = saved
    assert singleton.ledger()["steps_productive"] >= 1
    assert snap["goodput_samples"]
    assert snap["goodput_incidents"][-1]["cause"] == "elastic_reform"
    assert any(e["kind"] == "profiler_step" for e in snap["flight_events"])
    snap["launch_rank"] = 0
    (tmp_path / "profile-rank-0.json").write_text(json.dumps(snap))
    out, _ = profiler.merge_profile_dir(str(tmp_path))
    ours = json.load(open(out))["traceEvents"]
    out, _ = jprof.merge_profile_dir(str(tmp_path))
    theirs = json.load(open(out))["traceEvents"]
    names = {e.get("name") for e in ours}
    assert {"goodput fraction", "incident: elastic_reform"} <= names
    key = sorted(json.dumps(e, sort_keys=True) for e in ours
                 if e.get("name") in ("goodput fraction",
                                      "incident: elastic_reform"))
    assert key == sorted(json.dumps(e, sort_keys=True) for e in theirs
                         if e.get("name") in ("goodput fraction",
                                              "incident: elastic_reform"))


def _gp_state(rank, wall, productive, badput, incidents=(), replayed=0):
    return {"rank": rank, "world": 2, "wall_time": 0.0,
            "epoch_wall_time": 0.0, "enabled": True, "wall_seconds": wall,
            "goodput_fraction": productive / wall,
            "accounted_fraction": 1.0, "productive_seconds": productive,
            "badput_seconds": badput, "steps_productive": 10,
            "steps_replayed": replayed, "serve_blocks": 0,
            "incident_counts": {}, "incidents": list(incidents)}


def _dump(rank, state):
    return {"schema": tfr.SCHEMA, "rank": rank, "launch_rank": rank,
            "pid": 1, "host": "h", "reason": "test", "wall_time": 0.0,
            "clock_offset_seconds": 0.0, "dump_history": [], "events": [],
            "state": {"goodput": state}, "metrics": {}}


def test_report_is_the_jax_packages():
    dumps = [
        _dump(0, _gp_state(0, 100.0, 80.0,
                           {"ckpt_stall": 5.0, "input_idle": 15.0})),
        _dump(1, _gp_state(1, 100.0, 60.0,
                           {"elastic_reform": 30.0, "input_idle": 10.0},
                           incidents=[{"cause": "elastic_reform",
                                       "wall_time": 1.0, "duration_s": 30.0,
                                       "generation": 1, "culprit_rank": 2,
                                       "steps_replayed": 3,
                                       "replayed_seconds": 6.0,
                                       "linked_events": [],
                                       "detail": None}], replayed=3)),
    ]
    text = goodput.format_goodput_report(dumps)
    assert text == jgp.format_goodput_report(dumps)
    assert "fleet goodput: 70.0% (time-weighted across 2 ranks)" in text
    assert ("costliest incident: elastic_reform on rank 1 — 36.0s "
            "(gen 1, 3 step(s) replayed, culprit rank 2)") in text
    assert tfr.format_postmortem(dumps) == jfr.format_postmortem(dumps)
    empty = [_dump(0, None)]
    empty[0]["state"] = {}
    assert goodput.format_goodput_report(empty) == ""
