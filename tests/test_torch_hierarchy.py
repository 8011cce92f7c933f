"""The port's two-level collectives against the JAX package's (mirrors
tests/test_hierarchy_plan.py and tests/test_hierarchical.py).

* ``build_plan`` on both packages with one fake roster: explicit,
  host-derived, degenerate and uneven layouts give the same plans;
* the codec names and ``hierarchical_available``'s static predicate;
* a 4-process gloo world at group size 2 (tests/torch_hierarchy_worker.py
  ``parity``): int64 allreduce (Sum, Average, Min, Max; a bin of odd
  length, padded on the wire), named async enqueues, reduce-scatter and
  allgather bit-equal to the flat path's and to numpy; exactly
  representable floats bit-equal too, other floats within 1e-6 relative
  (another order of addition); a non-contiguous host-derived layout the
  same; the float payload under ``fp16`` within bf16's rounding and under
  ``ieee_fp16`` within float16's of the exact sum, the same bytes on every
  rank, the digests' CRC vote agreeing; the ``hier_intra`` and
  ``hier_cross`` lanes recorded;
* a 4-process world under ``HOROVOD_AUTOTUNE``: the sweep holds the
  hierarchy's knobs, every rank applies the same commits, and the tuner
  freezes.
"""

import os
import sys

import numpy as np
import pytest
import torch

from horovod_tpu.runtime import hierarchy as jhier
from horovod_tpu_torch.runtime import hierarchy as thier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_hierarchy_worker as worker  # noqa: E402


class _Net:
    """One rank's view of a fake roster: the JAX plan gathers with
    ``allgatherv``, the port's with the controller's ``allgather_blob``."""

    def __init__(self, world, rank, hosts=None):
        self.world, self.rank = world, rank
        self.hosts = hosts or ["h"] * world

    def allgatherv(self, blob):
        return [h.encode() for h in self.hosts]

    def allgather_blob(self, blob):
        assert len(blob) == thier._HOST_BYTES
        return [h.encode().ljust(thier._HOST_BYTES, b"\0")
                for h in self.hosts]


def _common(plan) -> dict:
    return {k: getattr(plan, k) for k in (
        "world", "rank", "group_size", "num_groups", "members",
        "cross_members", "group_index", "local_index", "source")}


def _both(world, gsize, hosts=None):
    out = []
    for r in range(world):
        if hosts is not None:
            os.environ["HOROVOD_HOSTNAME"] = hosts[r]
        try:
            ours = thier.build_plan(_Net(world, r, hosts), gsize)
            theirs = jhier.build_plan(_Net(world, r, hosts), gsize)
        finally:
            os.environ.pop("HOROVOD_HOSTNAME", None)
        assert _common(ours) == _common(theirs), (world, gsize, r)
        assert ours.enabled == theirs.enabled
        assert ours.describe() == theirs.describe()
        out.append(ours)
    return out


@pytest.mark.parametrize("world,gsize", [(4, 2), (8, 2), (8, 4), (6, 3),
                                         (12, 4), (9, 3)])
def test_explicit_group_size_is_the_jax_packages_plan(world, gsize):
    plans = _both(world, gsize)
    for p in plans:
        assert p.source == "env" and p.enabled
        assert p.layout == tuple(tuple(range(k * gsize, (k + 1) * gsize))
                                 for k in range(world // gsize))


@pytest.mark.parametrize("world,gsize", [(2, 2), (3, 0), (4, 4), (4, 3),
                                         (6, 4), (8, 8), (4, 1), (5, 0)])
def test_degenerate_layouts_fall_back_flat_as_the_jax_package(world, gsize):
    for p in _both(world, gsize):
        assert not p.enabled and p.source == "flat"


@pytest.mark.parametrize("hosts", [
    ["a", "a", "b", "b"], ["a", "b", "a", "b"],
    ["x", "y", "x", "y", "z", "z"], ["b", "b", "a", "a", "c", "c"]])
def test_host_derived_groups_are_the_jax_packages(hosts):
    plans = _both(len(hosts), 0, hosts)
    for p in plans:
        assert p.source == "hosts" and p.enabled
        assert sorted(r for s in p.layout for r in s) == \
            list(range(len(hosts)))
        assert all(hosts[m] == hosts[p.layout[0][0]] for m in p.layout[0])


@pytest.mark.parametrize("hosts", [["a", "a", "a", "b"],
                                   ["a", "b", "c", "d"], ["a"] * 4,
                                   ["a", "a", "b", "b", "b", "b"]])
def test_uneven_or_one_host_falls_back_flat(hosts):
    for p in _both(len(hosts), 0, hosts):
        assert not p.enabled


def test_codec_names():
    assert thier.wire_dtype_from_name("fp16") is torch.bfloat16
    assert thier.wire_dtype_from_name("bf16") is torch.bfloat16
    assert thier.wire_dtype_from_name("ieee_fp16") is torch.float16
    for off in ("", "none", "off", None):
        assert thier.wire_dtype_from_name(off) is None
        assert jhier.wire_dtype_from_name(off) is None
    for name in ("fp16", "bf16", "ieee_fp16", "float16", "f16",
                 "bfloat16"):
        ours = thier.wire_dtype_from_name(name)
        theirs = jhier.wire_dtype_from_name(name)
        assert str(ours).replace("torch.", "") == theirs.name
    with pytest.raises(ValueError):
        thier.wire_dtype_from_name("int8")


@pytest.mark.parametrize("world,gsize,want", [
    (4, 0, True), (4, 2, True), (8, 4, True), (2, 0, False), (3, 0, False),
    (6, 4, False), (4, 4, False), (4, 1, False)])
def test_hierarchical_available_is_static(world, gsize, want):
    from horovod_tpu_torch.runtime.executor import Executor
    from horovod_tpu_torch.utils import env

    cfg = env.Config(hierarchy_group_size=gsize)
    ex = Executor(torch.device("cpu"), None, world, 1 << 20, 1 << 16, 2,
                  cfg)
    assert ex.hierarchical_available() is want


def test_permutations_of_a_non_contiguous_layout():
    """Slices {0, 2} and {1, 3}: the reduce-scatter's j-major order puts
    slot 0's cross group (0, 1) first; the allgather's blocks land out of
    rank order and are put back."""
    plan = thier.HierarchyPlan(4, 0, 2, 2, (0, 2), (0, 1), 0, 0, "hosts",
                               ((0, 2), (1, 3)))
    h = thier.HierarchyGroups.__new__(thier.HierarchyGroups)
    h.plan, h._rs_order = plan, {}
    assert h.reducescatter_order("cpu").tolist() == [0, 1, 2, 3]
    assert h.allgather_order() == [0, 2, 1, 3]
    contiguous = thier.build_plan(_Net(4, 1), 2)
    h.plan, h._rs_order = contiguous, {}
    assert h.reducescatter_order("cpu").tolist() == [0, 2, 1, 3]
    assert h.allgather_order() is None


def _reference(world=4) -> dict:
    """numpy's reductions of every rank's payloads."""
    ps = [worker._payloads(r) for r in range(world)]
    ref = {}
    red = dict(sum=np.sum, min=np.min, max=np.max)
    for kind in ("int", "exact", "float"):
        for op in worker.OPS:
            outs = []
            for i in range(len(worker.WORLD_SIZES)):
                stack = np.stack([p[kind][i] for p in ps])
                if op == "average":
                    s = stack.sum(0)
                    outs.append(np.trunc(s / world).astype(np.int64)
                                if kind == "int" else s / world)
                else:
                    outs.append(red[op](stack, 0))
            ref[f"ar_{kind}_{op}"] = outs
    ref["rs"] = np.stack([p["rs"] for p in ps]).sum(0)
    ref["rs_float"] = np.stack([p["rs_float"] for p in ps]).sum(0)
    ref["ag"] = np.concatenate([p["ag"] for p in ps])
    ref["ragged"] = np.concatenate([p["ragged"] for p in ps])
    return ref


@pytest.fixture(scope="module")
def parity_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hier_parity")
    worker.run_world("parity", tmp, env={"HOROVOD_INTEGRITY": "1",
                                  "HOROVOD_INTEGRITY_INTERVAL": "1"})
    return [torch.load(tmp / f"parity-r{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.mark.parametrize("tag", ["hier.", "hosts."])
@pytest.mark.parametrize("kind", ["int", "exact"])
@pytest.mark.parametrize("op", worker.OPS)
def test_fused_allreduce_is_bit_equal_to_the_flat_path(parity_world, tag,
                                                       kind, op):
    ref = _reference()[f"ar_{kind}_{op}"]
    for r, res in enumerate(parity_world):
        for got, flat, want in zip(res[f"{tag}ar_{kind}_{op}"],
                                   res[f"flat.ar_{kind}_{op}"], ref):
            assert got.tobytes() == flat.tobytes(), (r, tag, kind, op)
            np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("op", worker.OPS)
def test_float_allreduce_within_rounding_of_the_flat_path(parity_world, op):
    """Another order of addition: float32 rounding, 1e-6 relative to the
    payload's scale; Min and Max exact."""
    ref = _reference()[f"ar_float_{op}"]
    first = parity_world[0]
    for res in parity_world:
        for tag in ("hier.", "hosts."):
            for got, flat, want in zip(res[f"{tag}ar_float_{op}"],
                                       res[f"flat.ar_float_{op}"], ref):
                if op in ("min", "max"):
                    assert got.tobytes() == flat.tobytes()
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * 4)
                np.testing.assert_allclose(got, flat, rtol=0, atol=1e-6 * 4)
        # every rank holds the same bytes
        for k in ("hier.ar_float_sum", "hosts.ar_float_sum"):
            for a, b in zip(res[k], first[k]):
                assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tag", ["hier.", "hosts."])
@pytest.mark.parametrize("key", ["async", "rs_sum", "rs_average", "ag",
                                 "ragged"])
def test_async_reducescatter_and_allgather_match_the_flat_path(
        parity_world, tag, key):
    ref = _reference()
    for r, res in enumerate(parity_world):
        got, flat = res[f"{tag}{key}"], res[f"flat.{key}"]
        if key == "async":
            for g, f, want in zip(got, flat, ref["ar_int_sum"]):
                assert g.tobytes() == f.tobytes()
                np.testing.assert_array_equal(g, want)
            continue
        assert got.tobytes() == flat.tobytes(), (r, key)
        if key.startswith("rs"):
            want = ref["rs"][2 * r:2 * r + 2]
            if key == "rs_average":
                want = np.trunc(want / 4).astype(np.int64)
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_equal(got, ref[key])  # rank order


def test_float_reducescatter_within_rounding(parity_world):
    ref = _reference()["rs_float"]
    for r, res in enumerate(parity_world):
        for tag in ("hier.", "hosts."):
            np.testing.assert_allclose(res[f"{tag}rs_float_sum"],
                                       ref[2 * r:2 * r + 2], rtol=0,
                                       atol=4e-6)


@pytest.mark.parametrize("codec,eps", [("fp16", 2.0 ** -8),
                                       ("ieee_fp16", 2.0 ** -11)])
def test_compressed_cross_hop_within_the_wire_types_rounding(parity_world,
                                                             codec, eps):
    """The cross hop casts this rank's reduced chunk (two ranks' sum) to
    the wire type and sums two of them there: three roundings of the
    wire type's unit (bf16 2^-8, float16 2^-11) on values of the sum's
    scale. Every rank ends with the same bytes."""
    ref = _reference()["ar_float_sum"]
    for res in parity_world:
        for got, want in zip(res[f"{codec}_float"], ref):
            scale = np.maximum(np.abs(want), 1.0)
            assert np.all(np.abs(got - want) <= 3 * eps * 2 * scale), codec
        for a, b in zip(res[f"{codec}_float"],
                        parity_world[0][f"{codec}_float"]):
            assert a.tobytes() == b.tobytes()
        exact = _reference()["rs_float"]
    for r, res in enumerate(parity_world):
        want = exact[2 * r:2 * r + 2]
        scale = np.maximum(np.abs(want), 1.0)
        assert np.all(np.abs(res[f"{codec}_rs"] - want)
                      <= 3 * eps * 2 * scale)


def test_the_world_recorded_its_hops_plans_and_digests(parity_world):
    for r, res in enumerate(parity_world):
        lanes = res["lanes"]
        for lane in ("hier_intra", "hier_cross", "device"):
            assert lanes[lane]["bytes_total"] > 0, (r, lane)
            assert lanes[lane]["peak_busbw_gbs"] > 0, (r, lane)
        # group size 2, then 0 (hosts), then 2 again: three plans, the
        # first two's groups destroyed as the next was built
        assert [p["source"] for p in res["plans"]] == ["env", "hosts", "env"]
        assert res["stats"] == {"built": 6, "destroyed": 6}
        assert res["hosts_plan"] == ((0, 2), (1, 3))
        # HOROVOD_INTEGRITY at interval 1: every allreduce and
        # reduce-scatter was voted on, compressed ones included
        assert res["digests"] > 40


def test_autotune_at_four_ranks_sweeps_the_hierarchy(tmp_path):
    worker.run_world("autotune", tmp_path, env={
        "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "2",
        "HOROVOD_HIERARCHY_GROUP_SIZE": "2", "HOROVOD_CYCLE_TIME": "2",
        "HOROVOD_AUTOTUNE_PROBE": "1",
        "HOROVOD_PROBE_CACHE": str(tmp_path / "probe.json")})
    res = [torch.load(tmp_path / f"autotune-r{r}.pt", weights_only=False)
           for r in range(4)]
    assert res[0]["swept"][-4:] == ("cache_enabled",
                                    "hierarchical_allreduce",
                                    "hierarchy_compression",
                                    "hierarchical_allgather")
    assert all(r["swept"] is None for r in res[1:])  # the coordinator tunes
    for r in res:
        assert r["frozen"]
        assert r["events"] == res[0]["events"]
    events = res[0]["events"]
    # the start's probes: the data group's allreduce and the two hops
    # over the plan's groups seeded the fusion threshold and the lanes
    for r in res:
        p = r["probe"]
        assert p["allreduce_busbw_gbps"] > 0 and p["world"] == 4
        assert p["hier_intra_busbw_gbps"] > 0
        assert p["hier_cross_busbw_gbps"] > 0
        assert set(r["rooflines"]) >= {"device", "hier_intra", "hier_cross"}
    assert all(r["probe"]["fusion_threshold_bytes"]
               == res[0]["probe"]["fusion_threshold_bytes"] for r in res)
    assert any(e["hierarchical_allreduce"] for e in events)
    assert any(e["hierarchy_compression"] == "fp16" for e in events)
    assert events[-1]["active"] is False
