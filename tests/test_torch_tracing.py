"""The port's tracing and SLO plane (``horovod_tpu_torch/tracing.py``)
against the JAX package's (``horovod_tpu/tracing.py``), case by case after
tests/test_tracing.py.

* The span ring and the ``HOROVOD_TRACE`` grammar, trace ids, the KV wire
  format (byte for byte the JAX package's, its pre-tracing form included),
  the SLO math and burn-rate alerting, the postmortem's SLO report, the
  Chrome conversion and flow arrows (equal to the JAX functions' output on
  the same spans), the ``/healthz`` and ``/slo`` routes, and the merged
  trace's request lanes.
* A runtime allreduce in a world-1 gloo ``hvd.init(device="cpu")`` records
  its ``collective:<name>`` span (the JAX test's eager single-controller
  ``stack_per_worker`` case has no counterpart: the port decided that mode
  out).
* The replica loop records every phase's span under the request's trace id
  and scores the SLO tracker.
"""

import json
import urllib.error
import urllib.request

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import tracing as jtracing
from horovod_tpu.serve.queue import Completion as JCompletion
from horovod_tpu.serve.queue import Request as JRequest
from horovod_tpu.utils.env import parse_trace as jparse_trace
from horovod_tpu_torch import flight_recorder, profiler, tracing
from horovod_tpu_torch.metrics import registry
from horovod_tpu_torch.serve.queue import Completion, Request, RequestQueue
from horovod_tpu_torch.utils.env import (HOROVOD_SLO_AVAILABILITY,
                                         HOROVOD_SLO_LATENCY_MS,
                                         HOROVOD_SLO_TTFT_MS,
                                         HOROVOD_SLO_WINDOW, HOROVOD_TRACE,
                                         parse_trace)

from test_torch_serve import _FakeEngine, _replica


@pytest.fixture
def world1(monkeypatch):
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()


# ---------------------------------------------------------------- span ring

def test_parse_trace_grammar_is_the_jax_packages():
    for value in (None, "", "1", "0", "off", "no", "128", "2", "-5",
                  "junk", "true"):
        assert parse_trace(value) == jparse_trace(value), value
    assert parse_trace("128") == (True, 128)
    assert parse_trace("0") == (False, 4096)


def test_span_ring_bounded_oldest_evicted(monkeypatch):
    monkeypatch.setenv(HOROVOD_TRACE, "16")
    t = tracing.Tracer()
    assert t.capacity == 16
    for i in range(40):
        t.record("s", t0=float(i), dur=0.001, trace_id="t%d" % i)
    assert [s["trace_id"] for s in t.spans()] == \
        ["t%d" % i for i in range(24, 40)]
    monkeypatch.setenv(HOROVOD_TRACE, "8")
    t.configure(rank=3)
    assert t.capacity == 8 and t.rank == 3
    assert [s["trace_id"] for s in t.spans()] == \
        ["t%d" % i for i in range(32, 40)]


def test_disabled_tracer_records_nothing(monkeypatch):
    monkeypatch.setenv(HOROVOD_TRACE, "0")
    t = tracing.Tracer()
    t.record("s", t0=0.0, dur=0.001)
    assert t.spans() == []


def test_new_trace_ids_unique_and_wire_sized():
    ids = {tracing.new_trace_id() for _ in range(64)}
    assert len(ids) == 64 and all(len(i) == 16 for i in ids)


# ------------------------------------------------------- context on the wire

def test_trace_context_survives_kv_roundtrip():
    """Both ways between the packages: the port's records are the JAX
    package's bytes, and each parses the other's."""
    kw = dict(uid="r1", prompt=[1, 2, 3], max_new_tokens=4,
              trace_id="abcdef0123456789", requeues=2)
    req, jreq = Request(**kw), JRequest(**kw)
    assert req.to_json() == jreq.to_json()
    back = Request.from_json(jreq.to_json())
    assert back.trace_id == "abcdef0123456789" and back.requeues == 2
    ckw = dict(uid="r1", tokens=[5], prompt_len=3, rank=1, ttft_s=0.25,
               latency_s=0.5, trace_id="abcdef0123456789", requeues=2)
    done, jdone = Completion(**ckw), JCompletion(**ckw)
    assert done.to_json() == jdone.to_json()
    back = Completion.from_json(jdone.to_json())
    assert back == done
    assert JCompletion.from_json(done.to_json()) == jdone


def test_pre_tracing_wire_format_still_parses():
    raw = json.dumps({"uid": "r1", "prompt": [1], "max_new_tokens": 2})
    req = Request.from_json(raw.encode())
    assert req.trace_id == "" and req.requeues == 0


def test_queue_submit_mints_trace_and_records_spans():
    q = RequestQueue()
    uid = q.submit([1, 2, 3], max_new_tokens=4)
    req = q.pull(rank=0, max_n=1)[0]
    assert req.trace_id
    q.complete(Completion(uid=uid, tokens=[5], prompt_len=3, rank=0,
                          trace_id=req.trace_id))
    names = [s["name"] for s in tracing.spans()
             if s.get("trace_id") == req.trace_id]
    assert "request.submit" in names and "request.response" in names


def test_runtime_allreduce_records_collective_span(world1):
    """A world-1 gloo runtime: the executor's completed response records
    one ``collective:<name>`` span with its op, bytes and lineage."""
    hvd.init(device="cpu")
    before = tracing.tracer().spans_recorded()
    out = hvd.allreduce(torch.ones(4) * 3, name="traced_probe")
    assert torch.equal(out, torch.full((4,), 3.0))
    spans = [s for s in tracing.spans()
             if s["name"] == "collective:traced_probe"]
    assert spans, [s["name"] for s in tracing.spans()][-10:]
    span = spans[-1]
    assert span["op"] == "ALLREDUCE" and span["bytes"] == 16
    assert span["dur"] >= 0 and span["rank"] == 0
    assert {"dispatch_ms", "overlap_ms", "drain_ms"} <= set(span)
    assert tracing.tracer().spans_recorded() > before


# ----------------------------------------------------------------- SLO math

def _slo_tracker(monkeypatch, *, window=10, availability=0.9,
                 latency_ms=100.0, ttft_ms=50.0, burn_alert=14.0):
    monkeypatch.setenv(HOROVOD_SLO_WINDOW, str(window))
    monkeypatch.setenv(HOROVOD_SLO_AVAILABILITY, str(availability))
    monkeypatch.setenv(HOROVOD_SLO_LATENCY_MS, str(latency_ms))
    monkeypatch.setenv(HOROVOD_SLO_TTFT_MS, str(ttft_ms))
    monkeypatch.setenv("HOROVOD_SLO_BURN_ALERT", str(burn_alert))
    return tracing.SLOTracker(), jtracing.SLOTracker()


def _both(slo, jslo, *args, **kw):
    slo.record_request(*args, **kw)
    jslo.record_request(*args, **kw)


def _state_equal(slo, jslo):
    ours, theirs = slo.state(), jslo.state()
    for doc in (ours, theirs):
        doc.pop("spans_recorded")
        doc.pop("rank")
    assert ours == theirs


def test_burn_rate_math(monkeypatch):
    slo, jslo = _slo_tracker(monkeypatch)
    for _ in range(9):
        _both(slo, jslo, ttft_s=0.01, latency_s=0.05)
    assert slo.burn_rate("latency") == 0.0
    assert slo.error_budget_remaining("latency") == 1.0
    _both(slo, jslo, ttft_s=0.01, latency_s=0.5)
    assert slo.burn_rate("latency") == pytest.approx(1.0)
    assert slo.error_budget_remaining("latency") == pytest.approx(0.0)
    assert slo.burn_rate("ttft") == 0.0
    st = slo.state()
    assert st["slo"]["latency"]["bad_total"] == 1
    assert st["requests_scored"] == 10
    _state_equal(slo, jslo)


def test_budget_clamps_at_zero(monkeypatch):
    slo, jslo = _slo_tracker(monkeypatch)
    for _ in range(5):
        _both(slo, jslo, ttft_s=0.01, latency_s=9.9)
    assert slo.burn_rate("latency") > 1.0
    assert slo.error_budget_remaining("latency") == 0.0
    _state_equal(slo, jslo)


def test_failed_request_scores_only_availability(monkeypatch):
    slo, jslo = _slo_tracker(monkeypatch)
    _both(slo, jslo, 0.0, 0.0, ok=False)
    st = slo.state()["slo"]
    assert st["availability"]["window_observed"] == 1
    assert st["availability"]["bad_total"] == 1
    assert st["ttft"]["window_observed"] == 0
    assert st["latency"]["window_observed"] == 0
    assert slo.state()["latency_ms_percentiles"]["p50"] is None
    _state_equal(slo, jslo)


def test_burn_alert_emits_once_then_rearms(monkeypatch):
    slo, _ = _slo_tracker(monkeypatch, window=4, availability=0.5,
                          burn_alert=1.5)

    def alert_events():
        return [e for e in flight_recorder.recorder().events()
                if e.get("kind") == "slo_burn_rate"
                and e.get("objective") == "latency"]

    n0 = len(alert_events())
    for _ in range(4):
        slo.record_request(ttft_s=0.01, latency_s=9.9)
    assert len(alert_events()) == n0 + 1
    slo.record_request(ttft_s=0.01, latency_s=9.9)
    assert len(alert_events()) == n0 + 1
    assert slo.state()["slo"]["latency"]["alerting"]
    for _ in range(4):
        slo.record_request(ttft_s=0.01, latency_s=0.05)
    assert not slo.state()["slo"]["latency"]["alerting"]
    for _ in range(4):
        slo.record_request(ttft_s=0.01, latency_s=9.9)
    assert len(alert_events()) == n0 + 2


def test_slow_request_exemplars_keep_the_slowest(monkeypatch):
    slo, jslo = _slo_tracker(monkeypatch, window=64, latency_ms=1e9,
                             ttft_ms=1e9)
    for i in range(12):
        _both(slo, jslo, ttft_s=0.01, latency_s=0.1 * (i + 1),
              trace_id="t%d" % i,
              phases={"queue_wait": 0.01, "decode": 0.09 * (i + 1)})
    ex = slo.state()["slow_request_exemplars"]
    assert len(ex) == 8
    assert ex[0]["trace_id"] == "t11"
    assert ex[0]["slowest_phase"] == "decode"
    assert ex[0]["latency_ms"] == pytest.approx(1200.0)
    _state_equal(slo, jslo)


def test_format_slo_report_is_the_jax_packages(monkeypatch):
    slo, _ = _slo_tracker(monkeypatch)
    slo.record_request(ttft_s=0.01, latency_s=0.9, trace_id="deadbeef",
                       phases={"decode": 0.8})
    dumps = [{"launch_rank": 0, "state": {"slo": slo.state()}},
             {"launch_rank": 1, "state": {}}]
    report = tracing.format_slo_report(dumps)
    assert "=== SLO report ===" in report
    assert "rank 0" in report and "deadbeef" in report
    assert report == jtracing.format_slo_report(dumps)
    assert tracing.format_slo_report([{"state": {}}]) == ""
    # the postmortem carries it after the memory report
    text = flight_recorder.format_postmortem(
        [dict(d, rank=d["launch_rank"], events=[]) for d in dumps])
    assert "=== SLO report ===" in text and "deadbeef" in text


# ------------------------------------------------------------- HTTP routes

def test_healthz_and_slo_routes(monkeypatch):
    port = registry().serve(0)

    def get(route):
        try:
            with urllib.request.urlopen(
                    "http://127.0.0.1:%d%s" % (port, route),
                    timeout=5.0) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read().decode())

    try:
        monkeypatch.setattr(tracing, "_init_ready", False)
        monkeypatch.setattr(tracing, "_serve_started", False)
        monkeypatch.setattr(tracing, "_serve_heartbeat_seen", False)
        code, doc = get("/healthz")
        assert code == 503 and not doc["ready"]
        tracing.mark_initialized(True)
        code, doc = get("/healthz")
        assert code == 200 and doc["ready"]
        tracing.note_serve_started()
        code, doc = get("/healthz")
        assert code == 503 and doc["serving"]
        tracing.note_replica_heartbeat()
        code, doc = get("/healthz")
        assert code == 200 and doc["first_replica_heartbeat"]
        code, doc = get("/slo")
        assert code == 200 and doc["schema"] == tracing.SCHEMA
        assert set(doc["slo"]) == {"ttft", "latency", "availability"}
        for rec in doc["slo"].values():
            assert 0.0 <= rec["error_budget_remaining"] <= 1.0
        code, doc = get("/serve")
        assert code == 200 and doc["count"] == 0
    finally:
        registry().stop_server()


# --------------------------------------------- Chrome conversion + merging

def test_spans_to_chrome_is_the_jax_function():
    spans = [{"trace_id": "t1", "name": "request.prefill", "t": 100.0,
              "dur": 0.25, "rank": 1, "uid": "r1"},
             {"name": "bad", "t": "nan"}]
    (ev,) = tracing.spans_to_chrome(spans)
    assert ev["ph"] == "X" and ev["cat"] == "request"
    assert ev["ts"] == pytest.approx(100.0 * 1e6)
    assert ev["args"]["trace_id"] == "t1" and ev["args"]["uid"] == "r1"
    assert tracing.spans_to_chrome(spans) == jtracing.spans_to_chrome(spans)
    assert tracing.spans_to_chrome(spans, tid=5) == \
        jtracing.spans_to_chrome(spans, tid=5)


def test_flow_events_are_the_jax_functions():
    def anchors():
        return [
            {"trace_id": "t1", "pid": 0, "tid": 2, "ts": 100.0, "dur": 5.0},
            {"trace_id": "t1", "pid": 4, "tid": 2, "ts": 200.0, "dur": 9.0},
            {"trace_id": "t1", "pid": 4, "tid": 2, "ts": 300.0, "dur": 1.0},
            {"trace_id": "solo", "pid": 0, "tid": 2, "ts": 50.0,
             "dur": 1.0}]

    flows = tracing.flow_events(anchors())
    assert [f["ph"] for f in flows] == ["s", "t", "f"]
    assert flows[0]["ts"] == pytest.approx(105.0)
    assert flows[2]["bp"] == "e"
    assert flows == jtracing.flow_events(anchors())


def test_merge_profile_dir_corrects_clocks_and_draws_flows(tmp_path):
    trace_id = "feedface00000001"
    base = 1000.0
    dump0 = {"launch_rank": 0, "clock_offset_seconds": 0.0,
             "trace_events": [], "flight_events": [],
             "request_spans": [
                 {"trace_id": trace_id, "name": "request.submit",
                  "t": base, "dur": 0.001, "rank": 0}]}
    dump1 = {"launch_rank": 1, "clock_offset_seconds": -0.5,
             "trace_events": [], "flight_events": [],
             "request_spans": [
                 {"trace_id": trace_id, "name": "request.serve",
                  "t": base + 0.6, "dur": 0.05, "rank": 1}]}
    for rank, dump in ((0, dump0), (1, dump1)):
        with open(tmp_path / f"profile-rank-{rank}.json", "w") as f:
            json.dump(dump, f)
    out, _ = profiler.merge_profile_dir(str(tmp_path))
    with open(out) as f:
        merged = json.load(f)["traceEvents"]
    labels = [e["args"]["labels"] for e in merged
              if e.get("name") == "process_labels"]
    assert "rank 0 requests" in labels and "rank 1 requests" in labels
    xs = {e["name"]: e for e in merged
          if e.get("ph") == "X" and e.get("cat") == "request"}
    assert xs["request.submit"]["ts"] == pytest.approx(base * 1e6)
    assert xs["request.serve"]["ts"] == pytest.approx((base + 0.1) * 1e6)
    assert xs["request.submit"]["pid"] != xs["request.serve"]["pid"]
    flows = [e for e in merged if e.get("ph") in ("s", "t", "f")
             and e.get("id") == trace_id]
    assert [f["ph"] for f in sorted(flows, key=lambda f: f["ts"])] == \
        ["s", "f"]


def test_profiler_dump_carries_the_request_spans(tmp_path):
    tracing.record("request.serve", 123.0, 0.5, trace_id="dumped-span")
    doc = profiler.dump(str(tmp_path / "profile-rank-0.json"))
    assert any(s.get("trace_id") == "dumped-span"
               for s in doc["request_spans"])


# ------------------------------------------------------- replica lifecycle

def test_replica_records_lifecycle_spans_and_scores_slo(monkeypatch):
    slo, _ = _slo_tracker(monkeypatch, window=16, latency_ms=1e9,
                          ttft_ms=1e9)
    monkeypatch.setattr(tracing, "_slo", slo)
    q = RequestQueue()
    uid = q.submit([1, 2], max_new_tokens=3)
    rep = _replica(_FakeEngine(), q)
    for _ in range(4):
        rep._iterate()
    done = q.result(uid, timeout=1.0)
    assert done.trace_id
    names = {s["name"] for s in tracing.spans()
             if s.get("trace_id") == done.trace_id}
    assert {"request.submit", "request.queue_wait", "request.prefill",
            "request.decode_block", "request.serve",
            "request.response"} <= names
    st = slo.state()
    assert st["requests_scored"] == 1
    (ex,) = st["slow_request_exemplars"]
    assert ex["trace_id"] == done.trace_id
    assert set(ex["phases_ms"]) == {"queue_wait", "prefill", "decode"}


def test_rejected_request_is_an_availability_bad_event(monkeypatch):
    slo, _ = _slo_tracker(monkeypatch, window=16)
    monkeypatch.setattr(tracing, "_slo", slo)
    q = RequestQueue()
    uid = q.submit(list(range(100)), max_new_tokens=4)
    rep = _replica(_FakeEngine(), q)
    rep._iterate()
    assert q.result(uid, timeout=1.0).finish == "rejected"
    st = slo.state()["slo"]
    assert st["availability"]["bad_total"] == 1
    assert st["latency"]["window_observed"] == 0
