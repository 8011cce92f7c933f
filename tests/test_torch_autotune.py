"""The port's autotuner against the JAX package's (mirrors
tests/test_autotune.py and the probe-cache cases of tests/test_comms.py).

* The Gaussian process, the Bayesian optimization and the parameter
  manager are the JAX modules' copies: the same inputs give the same bits
  (posterior means and deviations, next samples), and one score sequence
  gives byte-equal packed blobs at every update, the same frozen point and
  the same CSV rows (timestamps aside).
* The probe cache: an artifact written by either package reads back in the
  other; another world size, a torn file, schema 1 and an unset knob read
  as none; ``probe_and_seed`` reuses the artifact and seeds the ``device``
  roofline; ``comms.configure`` seeds ``device``, ``hier_intra`` and
  ``hier_cross`` from it.
* The runtime at world 1: autotune engages, moves the knobs, keeps every
  allreduce exact and freezes, with the response cache on (swept) and off
  (not swept); the probes seed the fusion threshold; the probes measure
  positive bandwidths on the CPU.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from horovod_tpu.autotune import bayesian_optimization as jbo
from horovod_tpu.autotune import gaussian_process as jgp
from horovod_tpu.autotune import parameter_manager as jpm
from horovod_tpu.autotune import probe as jprobe
import horovod_tpu_torch as hvd
from horovod_tpu_torch import comms, flight_recorder
from horovod_tpu_torch.autotune import bayesian_optimization as tbo
from horovod_tpu_torch.autotune import gaussian_process as tgp
from horovod_tpu_torch.autotune import parameter_manager as tpm
from horovod_tpu_torch.autotune import probe as tprobe
from horovod_tpu_torch.metrics import flatten_snapshot


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_process_gives_the_jax_modules_bits(seed):
    rng = np.random.RandomState(seed)
    X = rng.rand(9, 3)
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    Q = rng.rand(5, 3)
    outs = []
    for mod in (tgp, jgp):
        gp = mod.GaussianProcessRegressor(alpha=1e-6, length_scale=0.7)
        before = gp.predict(Q)
        gp.fit(X, y)
        outs.append(before + gp.predict(Q))
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 3])
def test_bayesian_optimization_gives_the_jax_modules_samples(seed):
    bounds = [(0, 10), (0, 10), (1, 4)]
    ours = tbo.BayesianOptimization(bounds=bounds, seed=seed)
    theirs = jbo.BayesianOptimization(bounds=bounds, seed=seed)
    for _ in range(8):
        a, b = ours.next_sample(), theirs.next_sample()
        assert a.tobytes() == b.tobytes()
        y = -(a[0] - 3.0) ** 2 - (a[1] - 7.0) ** 2 + a[2]
        ours.add_sample(a, y)
        theirs.add_sample(b, y)
    assert ours.best()[1] == theirs.best()[1]


def _manager(mod, **kw):
    initial = mod.Params(
        fusion_threshold_bytes=64 * 1024 * 1024, cycle_time_ms=5.0,
        cache_enabled=True, hierarchical_allreduce=False,
        hierarchical_allgather=False, grad_bucket_bytes=4 << 20,
        cycle_pipeline_depth=2, zero_prefetch_buckets=2)
    kw.setdefault("warmup_samples", 1)
    kw.setdefault("steps_per_sample", 2)
    kw.setdefault("bayes_opt_max_samples", 5)
    return mod.ParameterManager(initial, **kw)


def _score(p) -> float:
    mb = p.fusion_threshold_bytes / (1024 * 1024)
    return max(1.0, 100.0 - (mb - 32.0) ** 2 / 50
               - (p.cycle_time_ms - 3) ** 2 + 7 * p.cache_enabled
               + 3 * p.hierarchical_allreduce
               + 2 * (p.hierarchy_compression == "fp16"))


@pytest.mark.parametrize("sweep", [
    (), ("cache_enabled",),
    ("cache_enabled", "hierarchical_allreduce", "hierarchy_compression",
     "hierarchical_allgather")])
@pytest.mark.parametrize("busbw", [None, 12.5])
def test_parameter_manager_blobs_are_byte_equal(tmp_path, sweep, busbw):
    logs = {n: str(tmp_path / f"{n}.csv") for n in ("ours", "theirs")}
    ours = _manager(tpm, sweep=sweep, log_path=logs["ours"])
    theirs = _manager(jpm, sweep=sweep, log_path=logs["theirs"])
    assert ours.swept_knobs == theirs.swept_knobs
    guard = 0
    while theirs.active and guard < 3000:
        s = _score(theirs.current)
        nbytes, secs = int(s * 1e6 * 0.001), 0.001
        assert ours.update(nbytes, secs, busbw_gbs=busbw) == \
            theirs.update(nbytes, secs, busbw_gbs=busbw)
        assert ours.params().pack() == theirs.params().pack()
        guard += 1
    assert not theirs.active and not ours.active
    assert ours.best_score == theirs.best_score
    assert dataclasses.asdict(ours.current) == \
        dataclasses.asdict(theirs.current)
    rows = {n: [line.split(",", 1)[-1] for line in open(p).read().split("\n")]
            for n, p in logs.items()}
    assert rows["ours"] == rows["theirs"] and len(rows["ours"]) > 4


@pytest.mark.parametrize("codec", ["none", "fp16", "ieee_fp16", "bf16",
                                   "float16", "bogus", ""])
def test_params_blob_format_and_codecs_are_the_jax_packages(codec):
    p = tpm.Params(12345678, 7.25, False, True, True, active=True,
                   hierarchy_group_size=3, hierarchy_compression=codec,
                   grad_bucket_bytes=9 << 20, cycle_pipeline_depth=4,
                   zero_prefetch_buckets=6)
    q = jpm.Params(12345678, 7.25, False, True, True, active=True,
                   hierarchy_group_size=3, hierarchy_compression=codec,
                   grad_bucket_bytes=9 << 20, cycle_pipeline_depth=4,
                   zero_prefetch_buckets=6)
    assert tpm.Params._FMT == "<qdBBBBBBqBB"
    assert p.pack() == q.pack()
    assert dataclasses.asdict(tpm.Params.unpack(q.pack())) == \
        dataclasses.asdict(jpm.Params.unpack(p.pack()))
    assert tpm.normalize_codec(codec) == jpm.normalize_codec(codec)


@pytest.mark.parametrize("roofline", [
    None, {}, {"allreduce_busbw_gbps": 2.0},
    {"hier_cross_busbw_gbps": 0.5, "allreduce_busbw_gbps": 9.0},
    {"allreduce_busbw_gbps": 500.0}, {"allreduce_busbw_gbps": -1.0}])
def test_search_box_is_the_jax_packages(roofline):
    assert tpm.search_box_from_roofline(roofline) == \
        jpm.search_box_from_roofline(roofline)


@pytest.mark.parametrize("args", [(100.0, 5.0), (0.001, 5.0), (1e6, 5.0),
                                  (100.0, 5.0, 0.5, 1 << 20, 256 << 20,
                                   40.0), (37.5, 12.0, 0.25)])
def test_recommended_threshold_is_the_jax_packages(args):
    assert tprobe.recommended_fusion_threshold(*args) == \
        jprobe.recommended_fusion_threshold(*args)


def _artifact(world=4):
    return {"schema": tprobe._CACHE_SCHEMA, "hbm_gbps": 123.0,
            "allreduce_gbps": 30.0, "allreduce_busbw_gbps": 45.0,
            "world": world, "fusion_threshold_bytes": 1 << 20,
            "wall_time": 1.0}


@pytest.mark.parametrize("writer", ["ours", "theirs"])
def test_probe_cache_reads_back_in_either_package(tmp_path, writer):
    path = str(tmp_path / "sub" / "roofline.json")
    (tprobe if writer == "ours" else jprobe)._persist_roofline(
        path, _artifact())
    assert os.listdir(tmp_path / "sub") == ["roofline.json"]
    for mod in (tprobe, jprobe):
        assert mod.load_cached_roofline(path=path, world=4) == _artifact()
        assert mod.load_cached_roofline(path=path, world=8) is None
        assert mod.load_cached_roofline(path=path) is not None


def test_probe_cache_torn_schema1_missing_and_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("HOROVOD_PROBE_CACHE", raising=False)
    bad = tmp_path / "bad.json"
    for text in ("{ torn", json.dumps({"schema": 99, "world": 4}),
                 json.dumps(dict(_artifact(), schema=1))):
        bad.write_text(text)
        assert tprobe.load_cached_roofline(path=str(bad)) is None
        assert jprobe.load_cached_roofline(path=str(bad)) is None
    assert tprobe.load_cached_roofline(path=str(tmp_path / "no")) is None
    assert tprobe.load_cached_roofline(path=None) is None


@pytest.fixture
def tracker():
    """The port's process-wide comms tracker with no rooflines, put back
    after."""
    t = comms.tracker()
    with t._lock:
        saved = (dict(t._roofline), dict(t._roofline_source), t.world,
                 t.enabled)
        t._roofline.clear()
        t._roofline_source.clear()
    yield t
    with t._lock:
        t._roofline.clear()
        t._roofline.update(saved[0])
        t._roofline_source.clear()
        t._roofline_source.update(saved[1])
        t.world, t.enabled = saved[2], saved[3]


def test_probe_and_seed_reuses_the_cache(tmp_path, monkeypatch, tracker):
    calls = {"hbm": 0, "ar": 0}

    def fake_hbm(*a, **k):
        calls["hbm"] += 1
        return 100.0

    def fake_ar(*a, **k):
        calls["ar"] += 1
        return {"algbw_gbps": 30.0, "busbw_gbps": 45.0, "world": 4}

    monkeypatch.setattr(tprobe, "probe_hbm_bandwidth", fake_hbm)
    monkeypatch.setattr(tprobe, "probe_allreduce_bandwidth", fake_ar)
    path = str(tmp_path / "roofline.json")
    monkeypatch.setenv("HOROVOD_PROBE_CACHE", path)
    config = types.SimpleNamespace(cycle_time_ms=5.0,
                                   fusion_threshold_bytes=0)
    first = tprobe.probe_and_seed(config, world=4, group=object())
    assert first["cached"] is False and calls == {"hbm": 1, "ar": 1}
    assert config.fusion_threshold_bytes == \
        jprobe.recommended_fusion_threshold(30.0, 5.0, hbm_gbps=100.0)
    doc = jprobe.load_cached_roofline(path=path, world=4)  # theirs reads it
    assert doc["allreduce_busbw_gbps"] == 45.0
    config2 = types.SimpleNamespace(cycle_time_ms=5.0,
                                    fusion_threshold_bytes=0)
    second = tprobe.probe_and_seed(config2, world=4, group=object())
    assert second["cached"] is True and calls == {"hbm": 1, "ar": 1}
    assert config2.fusion_threshold_bytes == config.fusion_threshold_bytes
    with tracker._lock:
        assert tracker._roofline["device"] == pytest.approx(45.0)
        assert tracker._roofline_source["device"] == "probe_cache"


def test_probe_and_seed_takes_a_float_probe(monkeypatch, tracker):
    monkeypatch.setattr(tprobe, "probe_hbm_bandwidth", lambda *a, **k: 100.0)
    monkeypatch.setattr(tprobe, "probe_allreduce_bandwidth",
                        lambda *a, **k: 10.0)
    monkeypatch.delenv("HOROVOD_PROBE_CACHE", raising=False)
    config = types.SimpleNamespace(cycle_time_ms=5.0,
                                   fusion_threshold_bytes=0)
    out = tprobe.probe_and_seed(config, world=2, group=object())
    assert out["allreduce_gbps"] == 10.0
    assert out["allreduce_busbw_gbps"] == pytest.approx(10.0)  # 2(N-1)/N
    assert out["cached"] is False


def test_configure_seeds_the_device_lane(tmp_path, monkeypatch, tracker):
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps(_artifact()))
    monkeypatch.setenv("HOROVOD_PROBE_CACHE", str(path))
    monkeypatch.setenv("HOROVOD_COMMS", "1")
    comms.configure(rank=0, world=4)
    with tracker._lock:
        assert tracker._roofline["device"] == pytest.approx(45.0)
        assert tracker._roofline_source["device"] == "probe_cache"
        assert "spmd" not in tracker._roofline
        assert "host_ring" not in tracker._roofline
    tracker._roofline.clear()
    comms.configure(rank=0, world=8)  # another world: not this artifact
    assert not tracker._roofline


def test_configure_seeds_the_hierarchy_lanes(tmp_path, monkeypatch,
                                             tracker):
    path = tmp_path / "roofline.json"
    path.write_text(json.dumps({
        "schema": tprobe._CACHE_SCHEMA, "world": 4,
        "hier_intra_busbw_gbps": 12.0, "hier_cross_busbw_gbps": 0.75,
        "wall_time": 0.0}))
    monkeypatch.setenv("HOROVOD_PROBE_CACHE", str(path))
    monkeypatch.setenv("HOROVOD_COMMS", "1")
    comms.configure(rank=0, world=4)
    with tracker._lock:
        assert tracker._roofline["hier_intra"] == pytest.approx(12.0)
        assert tracker._roofline["hier_cross"] == pytest.approx(0.75)
        assert tracker._roofline_source["hier_cross"] == "probe_cache"
        assert "device" not in tracker._roofline


@pytest.fixture
def world1(monkeypatch):
    hvd.shutdown()
    for k in list(os.environ):
        if k.startswith("HOROVOD_AUTOTUNE") or k == "HOROVOD_PROBE_CACHE":
            monkeypatch.delenv(k)
    monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", "2")
    yield monkeypatch
    hvd.shutdown()


def _commits() -> list:
    return [e for e in flight_recorder.recorder()._events
            if e["kind"] == "autotune_commit"]


@pytest.mark.parametrize("capacity", [None, "0"])
def test_world1_autotune_engages_and_freezes(world1, capacity, tmp_path):
    """The knobs move, every allreduce stays exact, the tuner freezes at
    its best; the cache knob is swept only where a cache exists; each
    applied change is an ``autotune_commit`` and moves the metrics."""
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.runtime import runtime as trt

    if capacity is not None:
        world1.setenv("HOROVOD_CACHE_CAPACITY", capacity)
    world1.setenv("HOROVOD_AUTOTUNE_LOG", str(tmp_path / "at.csv"))
    hvd.init(device="cpu")
    before = flatten_snapshot(hvd.metrics()).get(
        "horovod_autotune_commits_total", 0)
    seen = len(_commits())
    cycle_times = set()
    for i in range(200):
        x = torch.full((16 + i % 5,), float(i), dtype=torch.float32)
        out = hvd.allreduce(x, name=f"at/{i % 4}")
        assert torch.equal(out, x)
        rt = state.global_state().runtime
        cycle_times.add(round(rt._cycle_time_s, 6))
        if not rt._autotune_active:
            break
    assert not rt._autotune_active, "autotune did not freeze"
    pm = rt.param_manager
    assert ("cache_enabled" in pm.swept_knobs) is (capacity is None)
    assert "hierarchical_allreduce" not in pm.swept_knobs  # world 1
    assert len(cycle_times) > 1
    assert rt.config.fusion_threshold_bytes == \
        pm.best.fusion_threshold_bytes == rt.fusion_threshold
    events = _commits()[seen:]
    assert events and events[-1]["active"] is False
    snap = flatten_snapshot(hvd.metrics())
    assert snap["horovod_autotune_commits_total"] - before == len(events)
    assert snap["horovod_autotune_param{knob=active}"] == 0.0
    assert (tmp_path / "at.csv").read_text().startswith("# swept: ")
    # frozen: the cycle no longer syncs, the knobs stay
    frozen = dataclasses.asdict(pm.params())
    hvd.allreduce(torch.ones(3), name="after")
    assert dataclasses.asdict(pm.params()) == frozen
    assert trt.COUNTS["cycles"] > 0


def test_a_plain_init_after_an_autotuned_one_reads_the_environment(world1):
    """The tuner's committed bucket payload and prefetch window end with
    its runtime: after an autotuned ``init``/``shutdown`` in one process, a
    plain ``init`` gets the environment's defaults again."""
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.parallel import buckets, zero
    from horovod_tpu_torch.runtime import runtime as trt
    from horovod_tpu_torch.utils import env

    world1.setenv("HOROVOD_GRAD_BUCKET_BYTES", str(8 << 20))
    world1.setenv("HOROVOD_ZERO_PREFETCH_BUCKETS", "3")
    hvd.init(device="cpu")
    for i in range(200):
        hvd.allreduce(torch.ones(16 + i % 5), name=f"reset/{i % 4}")
        if not state.global_state().runtime._autotune_active:
            break
    assert buckets._autotuned_bucket_bytes > 0  # committed, from 8 MiB
    assert zero._autotuned_prefetch_buckets == 3
    hvd.shutdown()
    for k in ("HOROVOD_AUTOTUNE", "HOROVOD_GRAD_BUCKET_BYTES",
              "HOROVOD_ZERO_PREFETCH_BUCKETS"):
        world1.delenv(k)
    hvd.init(device="cpu")
    assert trt.get_runtime().param_manager is None
    assert buckets.bucket_bytes_from_env() == env.DEFAULT_GRAD_BUCKET_BYTES
    assert zero.prefetch_buckets_from_env() == \
        env.DEFAULT_ZERO_PREFETCH_BUCKETS


def test_world1_probe_seeds_the_fusion_threshold(world1, tmp_path):
    world1.setenv("HOROVOD_AUTOTUNE_PROBE", "1")
    world1.setenv("HOROVOD_PROBE_CACHE", str(tmp_path / "probe.json"))
    hvd.init(device="cpu")
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.runtime import runtime as trt

    rt = trt.get_runtime()
    m = rt.probe
    assert m["hbm_gbps"] > 0 and m["allreduce_gbps"] > 0
    assert m["allreduce_busbw_gbps"] == 0.0  # world 1 moves no bus bytes
    assert m["cached"] is False
    want = tprobe.recommended_fusion_threshold(
        m["allreduce_gbps"], 5.0, hbm_gbps=m["hbm_gbps"])
    assert state.global_state().config.fusion_threshold_bytes == want \
        == rt.param_manager.params().fusion_threshold_bytes
    doc = jprobe.load_cached_roofline(path=str(tmp_path / "probe.json"),
                                      world=1)
    assert doc["fusion_threshold_bytes"] == want
    hvd.shutdown()
    hvd.init(device="cpu")  # the next start reads the artifact back
    assert trt.get_runtime().probe["cached"] is True


def test_probes_measure_positive_bandwidth_on_the_cpu(world1):
    hvd.init(device="cpu")
    hbm = tprobe.probe_hbm_bandwidth(size_mb=4, iters=2)
    ar = tprobe.probe_allreduce_bandwidth(size_mb=2, iters=2, detail=True)
    assert np.isfinite(hbm) and hbm > 0
    assert ar["algbw_gbps"] > 0 and ar["world"] == 1
    assert ar["busbw_gbps"] == 0.0
