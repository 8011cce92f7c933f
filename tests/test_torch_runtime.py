"""The port's enqueue runtime (``horovod_tpu_torch/runtime/``) against the
JAX package's framework-free runtime modules, and at world 1 in process.

Differential: the same inputs, from seeds, through both packages' wire
codec (the bytes), ``construct_response`` (responses and error strings),
``ResponseCache`` (bits, evictions, recycled bits), ``CacheCoordinator``,
``fuse_responses_py`` (the bins at thresholds 0, 1 KiB and 64 MiB) and the
tensor queue (mirroring ``tests/test_runtime.py`` and
``tests/test_data_plane.py::TestBucketPolicy``/``TestFusionBufferManager``).
Then the port alone: its fusion slabs, and at world 1 on the CPU a
duplicate in-flight name, shutdown with a pending handle, a cycle that
raises, the pipeline depth and the timeline.
"""

import json
import random

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.runtime import controller as jctrl
from horovod_tpu.runtime import fusion as jfusion
from horovod_tpu.runtime import fusion_buffer as jfb
from horovod_tpu.runtime import message as jmsg
from horovod_tpu.runtime import response_cache as jrc
from horovod_tpu.runtime import tensor_queue as jtq
from horovod_tpu.runtime import types as jtypes
from horovod_tpu_torch.runtime import controller as tctrl
from horovod_tpu_torch.runtime import fusion as tfusion
from horovod_tpu_torch.runtime import fusion_buffer as tfb
from horovod_tpu_torch.runtime import message as tmsg
from horovod_tpu_torch.runtime import response_cache as trc
from horovod_tpu_torch.runtime import runtime as trt
from horovod_tpu_torch.runtime import tensor_queue as ttq
from horovod_tpu_torch.runtime import types as ttypes

KINDS = ("ALLREDUCE", "ALLGATHER", "BROADCAST", "REDUCESCATTER",
         "ALLTOALL")


def _req(pkg, name, rank=0, rtype="ALLREDUCE", dtype="float32",
         shape=(4,), root=0, op="average"):
    return pkg.Request(rank, rtype, name, dtype, tuple(shape), root, op)


@pytest.mark.parametrize("rtype", KINDS + ("INVALIDATE",))
def test_request_bytes_equal_the_jax_packages(rtype):
    rng = random.Random(rtype)
    for i in range(8):
        shape = tuple(rng.randint(0, 2**40) for _ in range(rng.randint(0, 4)))
        args = dict(name=f"layer.{i}/wéight", rank=rng.randint(0, 7),
                    rtype=rtype, dtype=rng.choice(["float32", "bfloat16",
                                                   "int32", ""]),
                    shape=shape, root=rng.randint(0, 7),
                    op=rng.choice(jtypes.REDUCE_OPS))
        ours, theirs = _req(tmsg, **args), _req(jmsg, **args)
        assert ours.pack() == theirs.pack()
        assert tmsg.Request.unpack(theirs.pack())[0] == ours
    reqs = [_req(tmsg, f"t{i}", rtype=rtype) for i in range(3)]
    assert tmsg.pack_request_list(reqs) == jmsg.pack_request_list(
        [_req(jmsg, f"t{i}", rtype=rtype) for i in range(3)])
    assert tmsg.unpack_request_list(tmsg.pack_request_list(reqs)) == reqs


@pytest.mark.parametrize("rtype", KINDS + ("ERROR", "INVALIDATE"))
def test_response_bytes_equal_the_jax_packages(rtype):
    for names, err, sizes in ((["a"], "", []),
                              (["a", "b.c", "d"], "boom ✓", [3, 1, 4])):
        ours = tmsg.Response(rtype, names, err, sizes)
        theirs = jmsg.Response(rtype, names, err, sizes)
        assert ours.pack() == theirs.pack()
        got = tmsg.Response.unpack(theirs.pack())[0]
        assert (got.response_type, got.tensor_names, got.error_message,
                got.tensor_sizes) == (rtype, names, err, sizes)
        assert tmsg.pack_response_list([ours, ours]) == \
            jmsg.pack_response_list([theirs, theirs])


CONSTRUCT_CASES = {  # name -> per-rank request arguments
    "allreduce_ok": [dict(), dict(rank=1)],
    "allreduce_shape": [dict(), dict(rank=1, shape=(5,))],
    "dtype": [dict(), dict(rank=1, dtype="bfloat16")],
    "op": [dict(), dict(rank=1, rtype="BROADCAST")],
    "reduce_op": [dict(), dict(rank=1, op="sum")],
    "allgather_sizes": [dict(rank=1, rtype="ALLGATHER", shape=(3, 2)),
                        dict(rtype="ALLGATHER", shape=(5, 2)),
                        dict(rank=2, rtype="ALLGATHER", shape=(1, 2))],
    "allgather_trailing": [dict(rtype="ALLGATHER", shape=(3, 2)),
                           dict(rank=1, rtype="ALLGATHER", shape=(3, 4))],
    "allgather_rank": [dict(rtype="ALLGATHER", shape=(3, 2)),
                       dict(rank=1, rtype="ALLGATHER", shape=(3, 2, 1))],
    "broadcast_root": [dict(rtype="BROADCAST"),
                       dict(rank=1, rtype="BROADCAST", root=1)],
    "broadcast_shape": [dict(rtype="BROADCAST"),
                        dict(rank=1, rtype="BROADCAST", shape=(2, 2))],
    "reducescatter_ok": [dict(rtype="REDUCESCATTER", shape=(4, 3)),
                         dict(rank=1, rtype="REDUCESCATTER", shape=(4, 3))],
    "reducescatter_indivisible": [
        dict(rtype="REDUCESCATTER", shape=(3, 3)),
        dict(rank=1, rtype="REDUCESCATTER", shape=(3, 3))],
    "reducescatter_op": [dict(rtype="REDUCESCATTER", shape=(4,)),
                         dict(rank=1, rtype="REDUCESCATTER", shape=(4,),
                              op="max")],
    "alltoall_shape": [dict(rtype="ALLTOALL", shape=(4, 3)),
                       dict(rank=1, rtype="ALLTOALL", shape=(4, 2))],
}


@pytest.mark.parametrize("case", sorted(CONSTRUCT_CASES))
def test_construct_response_matches_jax(case):
    """The same verdicts and the same error strings, for matching
    announcements and for each mismatch ``construct_response`` catches."""
    def run(pkg, ctrl):
        resp = ctrl.construct_response(
            [_req(pkg, "t", **kw) for kw in CONSTRUCT_CASES[case]])
        return (resp.response_type, resp.tensor_names, resp.error_message,
                resp.tensor_sizes)

    ours, theirs = run(tmsg, tctrl), run(jmsg, jctrl)
    assert ours == theirs
    assert (ours[0] == "ERROR") == (case.split("_")[-1] not in
                                    ("ok", "sizes"))


@pytest.mark.parametrize("capacity", [0, 3, 8])
def test_response_cache_matches_jax_over_a_seeded_sequence(capacity):
    """Puts, lookups, invalidations and bit reads in a seeded random order:
    the same states, bits, evictions and recycled bits."""
    rng = random.Random(capacity)
    ours, theirs = trc.ResponseCache(capacity), jrc.ResponseCache(capacity)
    names = [f"g{i}" for i in range(12)]
    for _ in range(600):
        name = rng.choice(names)
        kw = dict(name=name, shape=(rng.choice([2, 3]),),
                  dtype=rng.choice(["float32", "bfloat16"]))
        act = rng.choice(["put", "put", "cached", "invalidate", "bit"])
        if act == "put":
            got = (ours.put(tmsg.Response("ALLREDUCE", [name]),
                            _req(tmsg, **kw)),
                   theirs.put(jmsg.Response("ALLREDUCE", [name]),
                              _req(jmsg, **kw)))
        elif act == "cached":
            got = (ours.cached(_req(tmsg, **kw)).name,
                   theirs.cached(_req(jmsg, **kw)).name)
        elif act == "invalidate":
            got = (ours.invalidate(name), theirs.invalidate(name))
        else:
            bit = rng.randint(0, max(capacity, 1))
            a, b = ours.get_by_bit(bit), theirs.get_by_bit(bit)
            got = (a and a.tensor_names, b and b.tensor_names)
        assert got[0] == got[1], act
        assert len(ours) == len(theirs)
        assert [ours.bit_for_name(n) for n in names] == \
            [theirs.bit_for_name(n) for n in names]
    with pytest.raises(ValueError, match="single-tensor"):
        ours.put(tmsg.Response("ALLREDUCE", ["a", "b"]), _req(tmsg, "a"))


def test_cache_coordinator_matches_jax():
    rng = random.Random(0)
    for _ in range(50):
        ours, theirs = trc.CacheCoordinator(), jrc.CacheCoordinator()
        for bit in rng.sample(range(200), rng.randint(0, 20)):
            ours.record_hit(bit)
            theirs.record_hit(bit)
        for flag in ("set_uncached_in_queue", "set_invalid_in_queue",
                     "set_should_shut_down"):
            if rng.random() < 0.5:
                getattr(ours, flag)()
                getattr(theirs, flag)()
        assert ours.bitvector == theirs.bitvector
        v = ours.bitvector & rng.getrandbits(210)
        assert trc.CacheCoordinator.common_hits(v) == \
            jrc.CacheCoordinator.common_hits(v)
        assert trc.CacheCoordinator.flags(v) == jrc.CacheCoordinator.flags(v)


@pytest.mark.parametrize("threshold", [0, 1024, 64 * 1024 * 1024])
def test_fuse_responses_matches_jax(threshold):
    """The same bins from a seeded mix of allreduces (three dtypes, two
    reductions, sizes around the threshold) and unfusable responses."""
    rng = random.Random(threshold)
    for _ in range(20):
        t_resp, j_resp, t_req, j_req = [], [], {}, {}
        for i in range(rng.randint(1, 40)):
            kind = rng.choice(["ALLREDUCE"] * 6 + ["BROADCAST", "ALLGATHER"])
            kw = dict(name=f"t{i}", rtype=kind,
                      dtype=rng.choice(["float32", "bfloat16", "int32"]),
                      shape=(rng.randint(0, 3), rng.randint(1, 200)),
                      op=rng.choice(["average", "sum"]))
            t_req[kw["name"]] = _req(tmsg, **kw)
            j_req[kw["name"]] = _req(jmsg, **kw)
            t_resp.append(tmsg.Response(kind, [kw["name"]]))
            j_resp.append(jmsg.Response(kind, [kw["name"]]))
        ours = tfusion.fuse_responses_py(t_resp, t_req, threshold)
        theirs = jfusion.fuse_responses_py(j_resp, j_req, threshold)
        assert [(r.response_type, r.tensor_names) for r in ours] == \
            [(r.response_type, r.tensor_names) for r in theirs]
        if threshold == 0:
            assert all(len(r.tensor_names) == 1 or all(
                tfusion.response_bytes(tmsg.Response("ALLREDUCE", [n]),
                                       t_req) == 0
                for n in r.tensor_names[1:]) for r in ours)


def _entry(pkg, name, priority=0, calls=None):
    return pkg.TensorTableEntry(
        name=name, tensor=None, priority=priority,
        callback=None if calls is None else
        (lambda s, o, *done: calls.append((name, s.type.name))))


def test_tensor_queue_matches_jax_on_duplicates_and_priority():
    queues = {"ours": (ttq, ttypes, tmsg), "theirs": (jtq, jtypes, jmsg)}
    popped, calls = {}, {}
    for who, (tq, types, msg) in queues.items():
        q, calls[who] = tq.TensorQueue(), []
        for name, prio in (("a", 0), ("b", 5), ("c", 0), ("d", 5)):
            q.add(_entry(types, name, prio, calls[who]), _req(msg, name))
        with pytest.raises(tq.DuplicateNameError,
                           match="same name as another tensor"):
            q.add(_entry(types, "b"), _req(msg, "b"))
        # a group with one clash adds nothing
        with pytest.raises(tq.DuplicateNameError):
            q.add_group([_entry(types, "e"), _entry(types, "a")],
                        [_req(msg, "e"), _req(msg, "a")])
        assert len(q) == 4
        q.add_group([_entry(types, "f", 9, calls[who])], [_req(msg, "f")])
        popped[who] = [r.tensor_name for r in q.pop_requests()]
        assert q.pop_requests() == []
        assert [e.name for e in q.get_entries(["c", "zz", "a"])] == ["c", "a"]
        q.finalize(types.Status.Aborted("down"))
        assert len(q) == 0
    assert popped["ours"] == popped["theirs"] == ["f", "b", "d", "a", "c"]
    assert calls["ours"] == calls["theirs"] == [
        ("b", "ABORTED"), ("d", "ABORTED"), ("f", "ABORTED")]


def test_entry_completes_exactly_once():
    calls = []
    e = ttypes.TensorTableEntry(name="x", tensor=None,
                                callback=lambda *args: calls.append(args))
    e.complete(ttypes.Status.OK(), 1)
    e.complete(ttypes.Status.Aborted("late"), None)
    assert calls == [(calls[0][0], 1, None)] and calls[0][0].ok()


@pytest.mark.parametrize("args", [(10, 4, 64 * 1024), (16384, 4, 64 * 1024),
                                  (16385, 4, 64 * 1024), (40000, 4, 65536),
                                  (300, 4, 256), (400, 4, 256),
                                  (12345, 4, 0), (100, 3, 256)])
def test_bucket_policy_matches_jax(args):
    assert tfb.bucket_elems(*args) == jfb.bucket_elems(*args)


def test_fusion_slabs_are_leased_reused_and_bounded():
    """A slab is sized by the bucket of the larger of the bin and the
    threshold, reused by any bin of its key once released, and a key holds
    the pipeline depth's slabs, all made at its first lease."""
    ttypes.reset_counts()
    mgr = tfb.FusionBufferManager(quantum_bytes=256, floor_bytes=1024,
                                  max_per_key=2)
    cpu = torch.device("cpu")
    a = mgr.acquire(10, torch.float32, cpu)  # 40 B -> the 1 KiB floor
    assert a.capacity == 256 and a.tensor.dtype == torch.float32
    b = mgr.acquire(200, torch.float32, cpu)  # same key, a still leased
    assert b.tensor is not a.tensor and mgr.slabs() == 2
    with pytest.raises(RuntimeError, match="more than 2 leases"):
        mgr.acquire(1, torch.float32, cpu)
    mgr.release(a)
    mgr.release(a)  # idempotent
    c = mgr.acquire(256, torch.float32, cpu)
    assert c.tensor is a.tensor
    big = mgr.acquire(300, torch.float32, cpu)  # 1200 B -> 2 KiB bucket
    assert big.capacity == 512
    assert mgr.acquire(10, torch.bfloat16, cpu).capacity == 512
    assert ttypes.COUNTS["slabs"] == mgr.slabs() == 6  # 3 keys x 2


@pytest.fixture
def world1(monkeypatch):
    hvd.shutdown()
    trt.reset_counts()
    yield monkeypatch
    hvd.shutdown()


def test_duplicate_in_flight_name_raises_and_shutdown_fails_it(world1):
    """With a 60 s cycle time the second op waits for its cycle: enqueuing
    its name again raises, and shutdown fails the pending handle."""
    world1.setenv("HOROVOD_CYCLE_TIME", "60000")
    hvd.init(device="cpu")
    hvd.allreduce(torch.ones(2), name="warm")  # the first cycle runs at once
    h = hvd.allreduce_async(torch.ones(2), name="x")
    with pytest.raises(ValueError, match="same name as another tensor"):
        hvd.allreduce_async(torch.ones(2), name="x")
    assert not hvd.poll(h)
    hvd.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        hvd.synchronize(h)


def test_cycle_exception_fails_popped_entries(world1):
    """An exception in a cycle fails the handles it had popped instead of
    stranding them, and frees their names (mirrors
    tests/test_runtime.py::TestCycleFailureHandling)."""
    hvd.init(device="cpu")
    rt = trt.get_runtime()
    original = rt.executor.dispatch

    def boom(*a, **k):
        raise RuntimeError("injected executor failure")

    world1.setattr(rt.executor, "dispatch", boom)
    h = hvd.allreduce_async(torch.ones(4), name="cycfail/x")
    with pytest.raises(RuntimeError, match="background cycle failed"):
        hvd.synchronize(h)
    world1.setattr(rt.executor, "dispatch", original)
    out = hvd.allreduce(torch.full((4,), 3.0), name="cycfail/x")
    assert out.tolist() == [3.0] * 4
    rt.stop()
    with pytest.raises(RuntimeError, match="shut down"):
        hvd.allreduce(torch.ones(2), name="after")


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_depths_give_equal_results(world1, depth):
    """A 1 KiB threshold makes many bins in one cycle, so several are in
    flight at depths 2 and 3; every depth unpacks each tensor to its own
    values and leases at most ``depth`` slabs a key."""
    world1.setenv("HOROVOD_CYCLE_PIPELINE_DEPTH", str(depth))
    world1.setenv("HOROVOD_FUSION_THRESHOLD", "1024")
    hvd.init(device="cpu")
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(int(n), generator=g) for n in
          torch.randint(1, 200, (30,), generator=g)]
    outs = hvd.grouped_allreduce(xs, op=hvd.Sum, name="depth")
    for x, out in zip(xs, outs):
        assert torch.equal(x, out)
    assert trt.COUNTS["allreduce"] > depth
    assert trt.COUNTS["slabs"] <= depth


def test_timeline_writes_chrome_trace_with_fusion_activities(world1,
                                                             tmp_path):
    path = tmp_path / "timeline.json"
    world1.setenv("HOROVOD_TIMELINE", str(path))
    hvd.init(device="cpu")
    hvd.grouped_allreduce([torch.ones(3), torch.ones(5)], name="tl")
    hvd.broadcast(torch.ones(2), 0, name="tl.b")
    hvd.shutdown()
    events = json.loads(path.read_text())
    names = {e.get("name") for e in events}
    assert {"MEMCPY_IN_FUSION_BUFFER", "GLOO_ALLREDUCE",
            "MEMCPY_OUT_FUSION_BUFFER", "NEGOTIATE_ALLREDUCE", "ALLREDUCE",
            "GLOO_BROADCAST", "RANK_0_READY"} <= names
    lanes = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert {"tl.0", "tl.1", "tl.b"} <= lanes
    # every begun span ends
    for pid in {e["pid"] for e in events if "pid" in e}:
        ph = [e["ph"] for e in events if e.get("pid") == pid]
        assert ph.count("B") == ph.count("E")


def test_non_contiguous_tensors_reduce_in_place(world1):
    """The fusion buffer packs flat views of contiguous tensors; a
    non-contiguous input goes through a contiguous copy that the result is
    copied back from."""
    hvd.init(device="cpu")
    x = torch.arange(12.0).reshape(3, 4).t()
    want = x.clone()
    assert hvd.allreduce_(x, op=hvd.Sum, name="nc") is x
    assert not x.is_contiguous() and torch.equal(x, want)
    outs = hvd.grouped_allreduce([x, torch.ones(2, 3)[:, 1]], name="nc.g")
    assert torch.equal(outs[0], want) and torch.equal(outs[1], torch.ones(2))


def test_tensor_on_another_device_is_refused(world1):
    """No fallback: a tensor on another device than the runtime's is
    refused at enqueue, never reduced elsewhere."""
    hvd.init(device="cpu")
    with pytest.raises(ValueError, match="runtime runs on cpu"):
        hvd.allreduce(torch.ones(2, device="meta"), name="meta")
    assert trt.COUNTS["allreduce"] == 0
