"""The port's timeline (``horovod_tpu_torch/timeline.py``) against the JAX
package's (mirrors ``tests/test_timeline.py``).

The same calls to both ``Timeline``s give the same events apart from
``ts`` (``ph``, ``name``, ``pid``, ``args``, ``s``), for each writer on each
side; names that need escaping and a stress of many events give valid
JSON with the drop count written at close; ``merge_traces`` writes the JAX
package's output on the same files, a truncated one included; and the
runtime's trace carries cycle markers and counter events.
"""

import gzip
import json

import pytest
import torch

import horovod_tpu.timeline as jtl
import horovod_tpu_torch as hvd
from horovod_tpu_torch import timeline as ttl

NAMES = ("grad/w", 'q"uote', "back\\slash", "new\nline", "wé✓ight")


def _script(tl) -> None:
    """Every kind of call the runtime makes, over names that need
    escaping."""
    for i, name in enumerate(NAMES):
        tl.mark_cycle_start()
        tl.negotiate_start(name, "ALLREDUCE")
        tl.negotiate_rank_ready(name, 0)
        tl.negotiate_rank_ready(name, 1)
        tl.negotiate_end(name)
        tl.start(name, "ALLREDUCE")
        tl.activity_start(name, "MEMCPY_IN_FUSION_BUFFER")
        tl.activity_end(name)
        tl.activity_start(name, "NCCL_ALLREDUCE")
        tl.counters({"queue_depth": i, "cache_hits": 2 * i,
                     "fusion_bytes": 1024 * i + 0.5})
        tl.activity_end(name)
        tl.end(name, "ALLREDUCE")
    tl.close()


def _events(path) -> list:
    """The trace's events without their times, and without the drop count
    the port writes at close (the JAX package writes it only when events
    were dropped)."""
    events = json.loads(open(path).read())
    assert events[-1] == {}
    return [{k: v for k, v in e.items() if k != "ts"} for e in events[:-1]
            if e.get("name") != "dropped_events"]


def _drop_record(path) -> dict:
    return [e for e in json.loads(open(path).read())
            if e.get("name") == "dropped_events"]


@pytest.mark.parametrize("jax_native", [True, False], ids=["jax-native",
                                                            "jax-python"])
@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_same_calls_give_the_jax_packages_events(tmp_path, monkeypatch,
                                                 native, jax_native):
    if not jax_native:
        monkeypatch.setattr(jtl, "_make_writer", jtl._Writer)
    theirs, ours = tmp_path / "jax.json", tmp_path / "port.json"
    _script(jtl.Timeline(str(theirs), mark_cycles=True))
    tl = ttl.Timeline(str(ours), mark_cycles=True, native_engine=native)
    assert isinstance(tl._writer,
                      ttl._NativeWriter if native else ttl._Writer)
    _script(tl)
    assert _events(ours) == _events(theirs)
    assert len(_events(ours)) == len(NAMES) * 15
    assert _drop_record(ours) == [{"ph": "M", "pid": 0,
                                   "name": "dropped_events",
                                   "args": {"count": 0}}]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_cycle_markers_only_when_asked(tmp_path, native):
    path = tmp_path / "t.json"
    tl = ttl.Timeline(str(path), native_engine=native)
    tl.mark_cycle_start()
    tl.start("a", "ALLREDUCE")
    tl.end("a")
    tl.close()
    assert not [e for e in _events(path)
                if str(e.get("name", "")).startswith("CYCLE_")]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_many_events_give_valid_json_and_an_honest_drop_count(tmp_path,
                                                              native):
    """More events than the native ring holds in flight: whatever is
    dropped is counted, in the trace and on the timeline, and the rest is
    valid JSON."""
    path = tmp_path / "stress.json"
    tl = ttl.Timeline(str(path), native_engine=native)
    n = 30_000
    for i in range(n):
        tl.start(f"t{i % 50}", "ALLREDUCE" + "_" * (i % 7))
    tl.counters({f"c{i}": i for i in range(100)})
    tl.close()
    events = json.loads(path.read_text())
    (record,) = _drop_record(path)
    assert record["args"]["count"] == tl.dropped
    kept = [e for e in events if e.get("ph") in ("B", "C")]
    assert len(kept) + tl.dropped == n + 100
    assert tl.dropped == 0 or native


def _write_rank(path, native: bool) -> None:
    tl = ttl.Timeline(str(path), mark_cycles=True, native_engine=native)
    tl.mark_cycle_start()
    tl.negotiate_start("g", "ALLREDUCE")
    tl.negotiate_rank_ready("g", 0)
    tl.negotiate_end("g")
    tl.start("g", "ALLREDUCE")
    tl.counters({"cycles": 1})
    tl.end("g")
    tl.close()


@pytest.mark.parametrize("align", [False, True])
def test_merge_traces_equals_the_jax_packages(tmp_path, align):
    """Two ranks' traces, a gzipped device-style trace on other pids and a
    truncated one (a killed writer's): byte-equal merged files."""
    r0, r1 = tmp_path / "rank0.json", tmp_path / "rank1.json"
    _write_rank(r0, True)
    _write_rank(r1, False)
    dev = tmp_path / "device.json.gz"
    with gzip.open(dev, "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "X", "pid": 7, "ts": 1.5e15, "dur": 3, "name": "k"},
            {"ph": "X", "pid": 9, "ts": 1.5e15 + 1, "dur": 1, "name": "m"},
            {"name": "no phase"}]}, f)
    cut = tmp_path / "cut.json"
    cut.write_text(r0.read_text().rsplit("{}]", 1)[0])
    inputs = [str(p) for p in (r0, r1, dev, cut)]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    n = ttl.merge_traces(str(ours), inputs, align=align)
    assert n == jtl.merge_traces(str(theirs), inputs, align=align)
    assert ours.read_bytes() == theirs.read_bytes()
    merged = json.loads(ours.read_text())["traceEvents"]
    assert len(merged) == n
    assert sum(e.get("ph") == "C" for e in merged) == 3
    labels = {e["args"]["labels"] for e in merged
              if e.get("name") == "process_labels"}
    assert labels == {"[rank0.json]", "[rank1.json]", "[device.json.gz]",
                      "[cut.json]"}


@pytest.fixture
def world1(monkeypatch):
    hvd.shutdown()
    yield monkeypatch
    hvd.shutdown()


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "python"])
def test_runtime_trace_marks_cycles_and_counts(world1, tmp_path, native):
    """Through the runtime: ``HOROVOD_TIMELINE_MARK_CYCLES`` puts a
    ``CYCLE_<n>`` marker at each cycle, and each cycle adds one counter
    event a series."""
    path = tmp_path / "trace.json"
    world1.setenv("HOROVOD_TIMELINE", str(path))
    world1.setenv("HOROVOD_TIMELINE_MARK_CYCLES", "1")
    world1.setenv("HOROVOD_NATIVE_CYCLE", native)
    hvd.init(device="cpu")
    for step in range(3):
        hvd.grouped_allreduce([torch.ones(3), torch.ones(5)], name="tl")
    hvd.shutdown()
    events = json.loads(path.read_text())
    marks = [e["name"] for e in events
             if str(e.get("name", "")).startswith("CYCLE_")]
    assert marks and marks == [f"CYCLE_{i + 1}" for i in range(len(marks))]
    series = {}
    for e in events:
        if e.get("ph") == "C":
            series.setdefault(e["name"], []).append(e["args"]["value"])
    assert set(series) == {"queue_depth", "cache_hits", "cache_misses",
                           "fusion_bytes", "cycles"}
    assert len({len(v) for v in series.values()}) == 1
    assert len(series["cycles"]) >= 3
    assert "NEGOTIATE_ALLREDUCE" in {e.get("name") for e in events}
    (record,) = _drop_record(path)
    assert record["args"]["count"] == 0
