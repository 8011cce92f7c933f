"""The port's native cycle engine (``horovod_tpu_torch/cpp/cycle.cc``
through ``runtime/native.py``) against its Python engine and the JAX
package's (mirrors ``tests/test_native_cycle.py``).

Seeded sequences of puts, lookups, reads and invalidations must give the
same answers and bits from three caches: the port's native cache, the
port's Python cache and ``horovod_tpu.runtime.response_cache.ResponseCache``
(eviction and bit reuse included, capacity 0 too). The native bin-packer
must give the JAX package's ``fuse_responses_py`` bins at thresholds 0,
1 KiB and 64 MiB. ``HOROVOD_NATIVE_CYCLE`` picks the engine; a library
that cannot be built raises rather than falling back; processes that
build it at once all load one good library.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from horovod_tpu.runtime import fusion as jfusion
from horovod_tpu.runtime import message as jmsg
from horovod_tpu.runtime import response_cache as jrc
import horovod_tpu_torch as hvd
from horovod_tpu_torch import timeline as ttimeline
from horovod_tpu_torch.runtime import controller as tctrl
from horovod_tpu_torch.runtime import fusion as tfusion
from horovod_tpu_torch.runtime import message as tmsg
from horovod_tpu_torch.runtime import native
from horovod_tpu_torch.runtime import response_cache as trc

REPO = Path(__file__).resolve().parents[1]


def _req(pkg, name, rtype="ALLREDUCE", dtype="float32", shape=(4,), op="average",
         rank=0):
    return pkg.Request(rank, rtype, name, dtype, tuple(shape), 0, op)


def _caches(capacity):
    return (trc.NativeResponseCache(capacity), trc.ResponseCache(capacity),
            jrc.ResponseCache(capacity))


def _put(cache, pkg, name, **kw):
    return cache.put(pkg.Response(kw.get("rtype", "ALLREDUCE"), [name]),
                     _req(pkg, name, **kw))


def _pkg(cache):
    return jmsg if isinstance(cache, jrc.ResponseCache) else tmsg


@pytest.mark.parametrize("capacity", [0, 1, 2, 3, 5, 8])
def test_three_caches_agree_over_a_seeded_sequence(capacity):
    """Every answer (put's bit, the lookup's state, a bit's response, a
    name's bit, the size) equal across the three caches at every step."""
    rng = random.Random(capacity)
    caches = _caches(capacity)
    names = [f"t{i}" for i in range(12)]
    for step in range(400):
        name = rng.choice(names)
        kw = dict(dtype=rng.choice(["float32", "bfloat16"]),
                  shape=(rng.choice([2, 4]),))
        op = rng.choice(["put", "put", "cached", "get", "invalidate", "bit"])
        if op == "put":
            got = [_put(c, _pkg(c), name, **kw) for c in caches]
        elif op == "cached":
            got = [c.cached(_req(_pkg(c), name, **kw)).name for c in caches]
        elif op == "get":
            bit = rng.randint(0, 9)
            got = [None if r is None else r.tensor_names
                   for r in (c.get_by_bit(bit) for c in caches)]
        elif op == "invalidate":
            for c in caches:
                c.invalidate(name)
            got = [len(c) for c in caches]
        else:
            got = [c.bit_for_name(name) for c in caches]
        assert got[0] == got[1] == got[2], (step, op, name, got)
        assert len(caches[0]) == len(caches[1]) == len(caches[2])


def test_eviction_and_bit_reuse_order():
    """Past capacity the least recently used entry goes and its bit is
    recycled lowest first, in all three caches."""
    for c in _caches(2):
        pkg = _pkg(c)
        assert _put(c, pkg, "a") == 0
        assert _put(c, pkg, "b") == 1
        assert c.get_by_bit(0).tensor_names == ["a"]  # "b" is now LRU
        assert _put(c, pkg, "c") == 1  # evicts b, reuses bit 1
        assert c.bit_for_name("b") is None and c.get_by_bit(1) is not None
        assert c.get_by_bit(1).tensor_names == ["c"]
        c.invalidate("a")
        assert c.get_by_bit(0) is None
        assert _put(c, pkg, "d") == 0  # reuses bit 0
        assert c.cached(_req(pkg, "d", shape=(8,))).name == "INVALID"
        assert c.cached(_req(pkg, "zz")).name == "MISS"


def test_native_hit_returns_the_response_it_was_given():
    """The native cache keeps each bit's Response on the Python side: a hit
    hands back that object, its sizes included."""
    c = trc.NativeResponseCache(4)
    resp = tmsg.Response("ALLGATHER", ["g"], tensor_sizes=[3, 1])
    bit = c.put(resp, _req(tmsg, "g", rtype="ALLGATHER"))
    assert c.get_by_bit(bit) is resp
    with pytest.raises(ValueError, match="single-tensor"):
        c.put(tmsg.Response("ALLREDUCE", ["a", "b"]), _req(tmsg, "a"))


def _fusion_case(rng):
    """Responses of mixed kinds, dtypes, ops and sizes, with errors."""
    n = rng.randint(0, 40)
    responses = {"t": [], "j": []}
    reqs = {"t": {}, "j": {}}
    for i in range(n):
        name = f"t{i}"
        kind = rng.choice(["ALLREDUCE"] * 4 + ["ALLGATHER", "BROADCAST",
                                               "ERROR"])
        kw = dict(rtype="ALLREDUCE" if kind == "ERROR" else kind,
                  dtype=rng.choice(["float32", "bfloat16", "int32"]),
                  shape=(rng.choice([1, 8, 64, 1024, 300_000]),),
                  op=rng.choice(["average", "sum"]))
        for key, pkg in (("t", tmsg), ("j", jmsg)):
            reqs[key][name] = _req(pkg, name, **kw)
            if kind == "ERROR":
                responses[key].append(pkg.Response("ERROR", [name], "boom"))
            elif kind == "ALLGATHER":
                responses[key].append(pkg.Response(kind, [name],
                                                   tensor_sizes=[1, 2]))
            else:
                responses[key].append(pkg.Response(kind, [name]))
    return responses, reqs


def _shape(resps):
    return [(r.response_type, r.tensor_names, r.error_message,
             r.tensor_sizes) for r in resps]


@pytest.mark.parametrize("threshold", [0, 1024, 64 << 20])
def test_native_bins_equal_the_jax_packages(threshold):
    """The C++ bin-packer, the port's Python one and the JAX package's
    ``fuse_responses_py``: the same bins over seeded cases."""
    rng = random.Random(threshold)
    for _ in range(60):
        responses, reqs = _fusion_case(rng)
        theirs = _shape(jfusion.fuse_responses_py(responses["j"], reqs["j"],
                                                  threshold))
        assert _shape(tfusion.fuse_responses_native(
            responses["t"], reqs["t"], threshold)) == theirs
        assert _shape(tfusion.fuse_responses_py(
            responses["t"], reqs["t"], threshold)) == theirs
        for engine in (True, False):
            assert _shape(tfusion.fuse_responses(
                responses["t"], reqs["t"], threshold, engine)) == theirs


def test_native_bins_look_ahead_past_other_dtypes():
    """A stray response that cannot join does not close the bin
    (reference: controller.cc:595-650)."""
    reqs = {"a": _req(tmsg, "a", dtype="bfloat16", shape=(8,)),
            "x": _req(tmsg, "x", dtype="float32", shape=(8,)),
            "b": _req(tmsg, "b", dtype="bfloat16", shape=(8,))}
    responses = [tmsg.Response("ALLREDUCE", [n]) for n in "axb"]
    out = tfusion.fuse_responses_native(responses, reqs, 1 << 20)
    assert [r.tensor_names for r in out] == [["a", "b"], ["x"]]
    assert tfusion.fuse_responses_native([], {}, 0) == []


def test_the_knob_picks_the_engine(monkeypatch):
    """``HOROVOD_NATIVE_CYCLE`` (default on) picks the cache, the
    bin-packer and the trace writer; off, the Python ones run."""
    monkeypatch.delenv("HOROVOD_NATIVE_CYCLE", raising=False)
    assert trc.native_cycle_enabled()
    assert isinstance(trc.make_response_cache(4), trc.NativeResponseCache)
    ctrl = tctrl.LocalController(0, 1, 4)
    assert ctrl.native_engine
    assert isinstance(ctrl.cache, trc.NativeResponseCache)
    calls = []
    real = tfusion._bins_native
    monkeypatch.setattr(tfusion, "_bins_native",
                        lambda *a: calls.append(a) or real(*a))
    reqs = {"a": _req(tmsg, "a"), "b": _req(tmsg, "b")}
    tfusion.fuse_responses([tmsg.Response("ALLREDUCE", [n]) for n in "ab"],
                           reqs, 1 << 20)
    assert len(calls) == 1
    for off in ("0", "false", "off"):
        monkeypatch.setenv("HOROVOD_NATIVE_CYCLE", off)
        assert not trc.native_cycle_enabled()
        assert type(trc.make_response_cache(4)) is trc.ResponseCache
        assert not tctrl.LocalController(0, 1, 4).native_engine
    tfusion.fuse_responses([tmsg.Response("ALLREDUCE", [n]) for n in "ab"],
                           reqs, 1 << 20)
    assert len(calls) == 1


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """A fresh build directory and no loaded library, the compiler
    replaced by ``false`` (it fails without a word)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "false")
    monkeypatch.delenv("HOROVOD_NATIVE_CYCLE", raising=False)
    yield monkeypatch
    hvd.shutdown()


def test_a_failed_build_raises_and_never_falls_back(unbuilt, tmp_path):
    with pytest.raises(native.NativeBuildError, match="false"):
        trc.make_response_cache(4)
    with pytest.raises(native.NativeBuildError):
        tctrl.LocalController(0, 1, 4)
    with pytest.raises(native.NativeBuildError):
        tfusion.fuse_responses([tmsg.Response("ALLREDUCE", ["a"])],
                               {"a": _req(tmsg, "a")}, 0)
    with pytest.raises(native.NativeBuildError):
        ttimeline.Timeline(str(tmp_path / "t.json"))
    # the runtime starts at the first enqueue, and it is that which raises
    hvd.init(device="cpu")
    with pytest.raises(native.NativeBuildError, match="exit 1"):
        hvd.allreduce(torch.ones(2), name="x")
    assert not list((tmp_path / "build").glob("*.so"))
    assert (tmp_path / "build").glob("*.log")
    hvd.shutdown()
    # only the knob turns the Python engine on
    unbuilt.setenv("HOROVOD_NATIVE_CYCLE", "0")
    hvd.init(device="cpu")
    assert hvd.allreduce(torch.ones(2), name="x").tolist() == [1.0, 1.0]


def test_a_stale_abi_version_is_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "ABI_VERSION", native.ABI_VERSION + 1)
    with pytest.raises(native.NativeBuildError, match="ABI version"):
        native.load()


_BUILD_AND_USE = """
import sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from horovod_tpu_torch.runtime import native, response_cache as rc, message
native.BUILD_DIR = Path({build!r})
c = rc.NativeResponseCache(4)
req = message.Request(0, "ALLREDUCE", "a", "float32", (2,), 0, "sum")
assert c.put(message.Response("ALLREDUCE", ["a"]), req) == 0
assert c.cached(req) is rc.CacheState.HIT
print(native.library_path())
"""


def test_concurrent_first_builds_load_one_good_library(tmp_path):
    """Processes that find no library and build it at once: the lock lets
    one compile, the others wait and load the renamed result."""
    build = tmp_path / "build"
    code = _BUILD_AND_USE.format(repo=str(REPO), build=str(build))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, CXX=""))
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in build.glob("*.so")] == [Path(*paths).name]
    assert not list(build.glob("*.tmp"))
