"""The port's memory ledger against the JAX package's (mirrors
tests/test_memory.py): subsystems and watermarks, providers, the sampler,
ownership by weakref (a freed or replaced tensor leaves), views of one
storage counted once, the OOM record at the executor's boundary for a
``torch.cuda.OutOfMemoryError`` built on the CPU, the ``/memory`` route,
and the postmortem report.

On the CPU there is no allocator: the device figures are empty, the drift
stays unset, and the ledger stands alone. The same ``set_bytes`` calls on
both trackers give equal ledgers (times aside), and
``format_memory_report`` of each package gives the same text on the same
dumps, the port's own dumps included."""

import gc
import json
import os
import sys
import time
import urllib.request

import pytest
import torch

from horovod_tpu import flight_recorder as jfr
from horovod_tpu import memory as jmem
from horovod_tpu_torch import flight_recorder as tfr
from horovod_tpu_torch import memory

_OOM_MSG = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a "
            "total capacity of 79.11 GiB")


def _fresh(t):
    t.stop()
    knobs = (t.sample_seconds, t.topk)
    with t._lock:
        saved = (dict(t._claimed), dict(t._peaks), dict(t._providers),
                 dict(t._owned), list(t._samples), t._last_oom)
        t._claimed.clear()
        t._peaks.clear()
        t._samples.clear()
        t._last_oom = None
    return saved + knobs, t.enabled


def _restore(t, saved, enabled):
    t.stop()
    with t._lock:
        for store, old in zip((t._claimed, t._peaks, t._providers,
                               t._owned), saved[:4]):
            store.clear()
            store.update(old)
        t._samples.clear()
        t._samples.extend(saved[4])
        t._last_oom = saved[5]
    t.sample_seconds, t.topk = saved[6], saved[7]
    t.enabled = enabled


@pytest.fixture
def tracker():
    """The port's process-wide tracker, its state put back after."""
    t = memory.tracker()
    saved, enabled = _fresh(t)
    t.enabled = True
    yield t
    _restore(t, saved, enabled)


@pytest.fixture
def both(tracker):
    """Both packages' process-wide trackers, fresh."""
    j = jmem.tracker()
    saved, enabled = _fresh(j)
    j.enabled = True
    yield tracker, j
    _restore(j, saved, enabled)


def _stable(led):
    """A ledger without its clocks and the process's own RSS."""
    out = {k: v for k, v in led.items() if k != "wall_time"}
    out["subsystems"] = {k: v for k, v in led["subsystems"].items()
                         if k != "host_rss"}
    out["total_claimed_bytes"] = led["total_claimed_bytes"]
    out["device"] = {k: led["device"][k] for k in
                     ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")}
    return out


@pytest.mark.parametrize("calls", [
    [("params", 1000), ("params", 400)],
    [("grads", 7), ("optimizer_shards", 3 << 20), ("grad_shards", 0)],
    [("param_shards", 5), ("param_shards", 9), ("fusionish", 12)],
])
def test_ledger_is_the_jax_packages(both, calls):
    ours, theirs = both
    for name, n in calls:
        ours.set_bytes(name, n)
        theirs.set_bytes(name, n)
    a, b = _stable(ours.ledger()), _stable(theirs.ledger())
    pushed = {n for n, _ in calls}
    assert {n: a["subsystems"][n] for n in pushed} == \
        {n: b["subsystems"][n] for n in pushed}
    # the rest are pulls: the slabs whatever ran before in this process
    # holds, the serving plane's caches (each package's live engines), and
    # the JAX package's XLA-program subsystem, which the port has none of
    pulls = {"fusion", "ckpt_staging", "serve_kv", "kv_pages",
             "program_cache"}
    assert set(a["subsystems"]) - pushed <= pulls - {"program_cache"}
    assert {"serve_kv", "kv_pages"} <= set(a["subsystems"])
    assert set(b["subsystems"]) - pushed <= pulls

    # the serving pulls count as device bytes in both; each package's own
    # live engines hold them
    def serving(led):
        return sum(led["subsystems"].get(n, {}).get("bytes", 0)
                   for n in ("serve_kv", "kv_pages"))

    assert a["claimed_device_bytes"] - serving(a) == \
        b["claimed_device_bytes"] - serving(b)
    assert a["device"] == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                           "bytes_limit": 0}
    assert a["reconcile_drift_ratio"] is None  # no allocator on the CPU
    assert memory.DEVICE_SUBSYSTEMS == jmem.DEVICE_SUBSYSTEMS
    assert set(ours.ledger()) == set(theirs.ledger())


def test_peaks_and_keys(tracker):
    tracker.set_bytes("params", 1000)
    tracker.set_bytes("params", 400)
    led = tracker.ledger()
    assert led["subsystems"]["params"] == {"bytes": 400, "peak_bytes": 1000}
    assert led["subsystems"]["host_rss"]["bytes"] > 0
    assert led["claimed_device_bytes"] <= led["total_claimed_bytes"]
    assert led["device"]["reconciled_against"] is None
    assert tracker.peak_hbm_bytes() == 1000  # the claimed watermark


def test_note_tree_bytes_counts_a_storage_once(tracker):
    flat = torch.zeros(100)
    views = {"a": flat[:40].view(4, 10), "b": flat[40:]}
    tracker.note_tree_bytes("params", views)
    assert tracker.ledger()["subsystems"]["params"]["bytes"] == 400
    tracker.note_tree_bytes("grads", [torch.ones(8, 16),
                                      torch.ones(16, dtype=torch.bfloat16)])
    assert tracker.ledger()["subsystems"]["grads"]["bytes"] == \
        8 * 16 * 4 + 16 * 2
    idx = torch.tensor([[0, 2]])
    sparse = torch.sparse_coo_tensor(idx, torch.ones(2, 3), (5, 3))
    tracker.note_tree_bytes("grads", {"emb": sparse})
    assert tracker.ledger()["subsystems"]["grads"]["bytes"] == 16 + 24
    meta = torch.empty(1024, 1024, device="meta")
    assert memory.tree_bytes((meta,)) == 4 << 20


def test_providers_and_a_failing_one(tracker):
    tracker.register("custom_pool", lambda: 12345)
    tracker.register("dying", lambda: 1 / 0)
    led = tracker.ledger()
    assert led["subsystems"]["custom_pool"]["bytes"] == 12345
    assert "dying" not in led["subsystems"]
    tracker.register("custom_pool", None)
    tracker.register("dying", None)
    assert "custom_pool" not in tracker._providers


def test_disabled_tracker_skips_pushes(tracker):
    tracker.enabled = False
    tracker.set_bytes("params", 999)
    tracker.note_tree_bytes("grads", {"x": torch.ones(4)})
    tracker.adopt("grads", {"x": torch.ones(4)})
    assert "params" not in tracker._claimed and "grads" not in \
        tracker._claimed


def test_sampler_fills_the_ring(tracker):
    tracker.start(interval=0.02)
    deadline = time.monotonic() + 5.0
    while not tracker.samples() and time.monotonic() < deadline:
        time.sleep(0.02)
    tracker.stop()
    wall, claimed, actual = tracker.samples()[0]
    assert wall > 0 and claimed >= 0 and actual == 0


def test_checkpoint_and_fusion_slabs_are_pulled(tracker):
    from horovod_tpu_torch.ckpt import writer
    from horovod_tpu_torch.runtime.fusion_buffer import FusionBufferManager

    mgr = FusionBufferManager(64, 256, 1)
    lease = mgr.acquire(10, torch.float32, torch.device("cpu"))
    slabs = writer._HostSlabs()
    slabs.acquire(100, torch.float32, False)
    led = tracker.ledger()["subsystems"]
    assert led["fusion"]["bytes"] >= mgr.usage()[0] > 0
    assert led["ckpt_staging"]["bytes"] >= slabs.bytes > 0
    mgr.release(lease)


# ---------------------------------------------------------------------------
# ownership
# ---------------------------------------------------------------------------

def test_adopt_owner_and_top_live_arrays(tracker):
    big = torch.ones(61, 67)  # a shape no other test leaves behind
    view = big[:8]
    tracker.adopt("params", {"w": big})
    assert tracker.owner_of(big) == "params"
    assert tracker.owner_of(view) is None and tracker.owner_of(
        torch.ones(3)) is None
    top = tracker.top_live_arrays(k=10 ** 6)
    mine = [r for r in top if r["shape"] == [61, 67]]
    assert len(mine) == 1 and mine[0]["owner"] == "params"
    assert mine[0]["bytes"] == 61 * 67 * 4 and mine[0]["dtype"] == "float32"
    # the view is the same storage: one row, not two
    assert not [r for r in top if r["shape"] == [8, 67]]
    del view


def _owned(t, subsystem):
    return sorted(r().numel() for r, s in t._owned.values()
                  if s == subsystem and r() is not None)


def test_freed_and_replaced_tensors_leave(tracker):
    a, b = torch.ones(5), torch.ones(6)
    tracker.adopt("optimizer_shards", [a, b])
    assert _owned(tracker, "optimizer_shards") == [5, 6]
    del a
    gc.collect()
    assert _owned(tracker, "optimizer_shards") == [6]
    c = torch.ones(7)
    tracker.adopt("optimizer_shards", [c], replace=True)
    assert _owned(tracker, "optimizer_shards") == [7]
    assert tracker.owner_of(b) is None and tracker.owner_of(c) == \
        "optimizer_shards"


# ---------------------------------------------------------------------------
# OOM
# ---------------------------------------------------------------------------

def test_is_oom_matrix():
    oom = torch.cuda.OutOfMemoryError(_OOM_MSG)
    assert memory.is_oom(oom)
    assert memory.is_oom(RuntimeError("CUDA out of memory. Tried ..."))
    assert memory.is_oom(ValueError("RESOURCE_EXHAUSTED: pool"))
    assert memory.is_oom(MemoryError())
    assert not memory.is_oom(ValueError("shape mismatch"))
    assert not memory.is_oom(RuntimeError("CUDA error: illegal address"))
    assert not memory.is_oom(None)
    # the JAX package's own cases
    for exc in (ValueError("RESOURCE_EXHAUSTED: x"), MemoryError(),
                ValueError("shape mismatch")):
        assert memory.is_oom(exc) == jmem.is_oom(exc)


@pytest.fixture
def flight_dir(tmp_path, monkeypatch, tracker):
    monkeypatch.setenv("HOROVOD_FLIGHT_RECORDER_DIR", str(tmp_path))
    monkeypatch.setattr(tfr._recorder, "_last_failure_dump", 0.0)
    monkeypatch.setattr(tfr._recorder, "_providers",
                        dict(tfr._recorder._providers))
    tfr.configure(rank=0)
    tfr.set_state_provider("memory", tracker.ledger)
    yield tmp_path
    monkeypatch.delenv("HOROVOD_FLIGHT_RECORDER_DIR")
    tfr.configure(rank=0)


def test_record_oom_names_the_dominant_subsystem(tracker, flight_dir):
    assert memory.maybe_record_oom(ValueError("benign"), "executor") is False
    tracker.set_bytes("grads", 5 * 10 ** 9)
    tracker.set_bytes("params", 10 ** 9)
    keep = torch.ones(256, 256)
    tracker.adopt("grads", [keep])
    assert memory.maybe_record_oom(torch.cuda.OutOfMemoryError(_OOM_MSG),
                                   where="elastic") is True
    oom = tracker.last_oom()
    assert oom["where"] == "elastic" and oom["dominant_subsystem"] == "grads"
    assert any(r["owner"] == "grads" and r["shape"] == [256, 256]
               for r in oom["top_live_arrays"])
    dump = json.loads((flight_dir / "flight-rank-0.json").read_text())
    assert dump["reason"] == "oom"
    assert dump["state"]["memory"]["last_oom"]["dominant_subsystem"] == \
        "grads"
    assert any(e["kind"] == "oom" for e in dump["events"])


def test_executor_boundary_records_oom(tracker, flight_dir):
    from horovod_tpu_torch.runtime import executor as ex_mod
    from horovod_tpu_torch.runtime import types

    tracker.set_bytes("params", 7 * 10 ** 9)
    ex = ex_mod.Executor(torch.device("cpu"), None, 1, 1 << 20, 64, 1)
    entry = types.TensorTableEntry(name="oom/x", tensor=torch.ones(4))
    tok = ex_mod._PendingOp(ex, types.ALLREDUCE, [entry], None)
    tok.fail_exc(torch.cuda.OutOfMemoryError(_OOM_MSG))
    oom = tracker.last_oom()
    assert oom is not None and oom["where"] == "executor"
    assert oom["dominant_subsystem"] == "params"
    dump = json.loads((flight_dir / "flight-rank-0.json").read_text())
    assert isinstance(dump["state"]["memory"]["last_oom"][
        "top_live_arrays"], list)
    assert any(e["kind"] == "oom" for e in dump["events"])


# ---------------------------------------------------------------------------
# configure, the route, the report
# ---------------------------------------------------------------------------

def test_knobs_and_provider_registration(tracker, monkeypatch):
    monkeypatch.setattr(tfr._recorder, "_providers",
                        dict(tfr._recorder._providers))
    monkeypatch.setenv("HOROVOD_MEMORY", "1")
    monkeypatch.setenv("HOROVOD_MEMORY_SAMPLE_SECONDS", "99")
    monkeypatch.setenv("HOROVOD_MEMORY_TOPK", "3")
    memory.configure(rank=5, device="cpu")
    assert (tracker.enabled, tracker.rank, tracker.sample_seconds,
            tracker.topk) == (True, 5, 99.0, 3)
    assert "memory" in tfr._recorder._providers
    assert tracker._sampler is None  # no allocator, no sampler thread
    monkeypatch.setenv("HOROVOD_MEMORY", "0")
    memory.configure(rank=5)
    assert tracker.enabled is False
    assert "memory" not in tfr._recorder._providers


def test_memory_route_and_the_jax_top_tool(tracker):
    from horovod_tpu_torch.metrics import MetricsRegistry

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import hvd_top

    tracker.set_bytes("params", 2 ** 20)
    reg = MetricsRegistry()
    port = reg.serve(0)
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/memory" % port, timeout=5) as r:
            doc = json.loads(r.read().decode())
        assert doc["subsystems"]["params"]["bytes"] == 2 ** 20
        assert {"device", "samples", "top_live_arrays",
                "sample_seconds"} <= set(doc)
        table = hvd_top.render(["127.0.0.1:%d" % port])
        assert "params" in table.splitlines()[0] and "1.0M" in table
    finally:
        reg.stop_server()


def _mem_state(rank, subsystems, in_use, limit=0, oom=None):
    return {
        "rank": rank,
        "subsystems": {n: {"bytes": b, "peak_bytes": b}
                       for n, b in subsystems.items()},
        "claimed_device_bytes": sum(b for n, b in subsystems.items()
                                    if n != "host_rss"),
        "device": {"bytes_in_use": in_use, "peak_bytes_in_use": in_use,
                   "bytes_limit": limit, "live_array_bytes": 0},
        "reconcile_drift_ratio": 0.01, "last_oom": oom,
    }


def _dump(rank, mem_state):
    return {"schema": tfr.SCHEMA, "rank": rank, "launch_rank": rank,
            "pid": 1000 + rank, "host": "host%d" % rank, "reason": "test",
            "wall_time": 0.0, "clock_offset_seconds": 0.0,
            "dump_history": [], "events": [], "state": {"memory": mem_state},
            "metrics": {}}


def test_cross_rank_report_is_the_jax_packages():
    gib = 1024 ** 3
    dumps = [
        _dump(0, _mem_state(0, {"params": 4 * gib, "grads": 2 * gib,
                                "host_rss": gib}, 7 * gib, 16 * gib)),
        _dump(1, _mem_state(1, {"params": 4 * gib, "grads": 9 * gib,
                                "host_rss": gib}, 15 * gib, 16 * gib,
                            oom={"where": "executor",
                                 "dominant_subsystem": "grads",
                                 "top_live_arrays": [
                                     {"bytes": 3 * gib,
                                      "shape": [1024, 786432],
                                      "dtype": "float32",
                                      "owner": "grads"}]})),
    ]
    text = memory.format_memory_report(dumps)
    assert text == jmem.format_memory_report(dumps)
    assert "rank 1: OOM at executor — dominant subsystem grads" in text
    assert "nearest HBM ceiling: rank 1" in text and "93.8% full" in text
    empty = [_dump(0, None)]
    empty[0]["state"] = {}
    assert memory.format_memory_report(empty) == "" == \
        jmem.format_memory_report(empty)


def test_the_ports_dump_reads_in_both_packages(tracker, flight_dir):
    tracker.set_bytes("optimizer_shards", 6 << 30)
    tfr.recorder().dump("unit", ship=False)
    dumps = tfr.load_dumps(str(flight_dir))
    assert dumps == jfr.load_dumps(str(flight_dir))
    text = memory.format_memory_report(dumps)
    assert text == jmem.format_memory_report(dumps)
    assert "dominant subsystem: optimizer_shards" in text
    assert tfr.format_postmortem(dumps) == jfr.format_postmortem(dumps)


def test_distributed_optimizer_notes_params_and_grads(tracker, monkeypatch):
    """The hooks path's step notes ``params`` (each storage once) and
    ``grads``, a sparse gradient by its indices and values."""
    import horovod_tpu_torch as hvd

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        emb = torch.nn.Embedding(10, 4, sparse=True)
        lin = torch.nn.Linear(4, 2)
        model = torch.nn.ModuleList([emb, lin])
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        lin(emb(torch.tensor([1, 3]))).sum().backward()
        opt.step()
        grads = [emb.weight.grad, lin.weight.grad, lin.bias.grad]
        led = tracker.ledger()["subsystems"]
        assert led["params"]["bytes"] == 4 * (40 + 8 + 2)
        assert led["grads"]["bytes"] == sum(memory.tensor_bytes(g)
                                            for g in grads)
        assert led["grads"]["bytes"] == memory.tree_bytes(grads)
    finally:
        hvd.shutdown()
