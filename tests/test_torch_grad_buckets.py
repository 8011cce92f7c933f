"""The port's bucket-wise gradient release (``parallel/buckets.py``)
against the JAX package.

Mirrors ``tests/test_grad_buckets.py``'s ``TestPartition``,
``TestBitParity``, ``TestAccumulation``, ``TestFailureCleanup`` and
``TestIntegration``:

* the partition (reverse-topological, cut at the bucket bytes) equals the
  JAX ``GradReleasePlan.zero_partition`` on the same shapes;
* one spawned 2-rank gloo world (``tests/torch_grad_buckets_worker.py``):
  the allreduce release is uint8-view bit-equal to the plain allreduce
  (float32 and bfloat16, average and sum); the reduce-scatter release is
  bit-equal to ``scatter_gradients`` and leaves no full gradient behind;
  ``make_train_step`` with a plan is bit-equal to one without, for the
  hooks' ``DistributedOptimizer(AdamW)`` and for a partition-aligned
  ``sharded_adamw``; a plan beside a ``DistributedOptimizer`` sends each
  gradient once; every released collective comes from the response cache
  from the second step;
* at world 1: ``every_k``, drain-and-reset on a failed bucket, ``abort``,
  the auto plan following ``HOROVOD_ZERO_STAGE``, ``prereduced``, and the
  grouped allreduce the plan rides on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
import torch_grad_buckets_worker
from horovod_tpu.parallel import buckets as jbuckets
from horovod_tpu_torch import training
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel import buckets as tbuckets


def _plan(**kw):
    kw.setdefault("bucket_bytes", 1024)
    return hvd.GradReleasePlan(**kw)


# -- the partition --------------------------------------------------------------

def test_reverse_topological_order():
    plan = _plan(bucket_bytes=1)  # one bucket a leaf
    plan.zero_partition({k: torch.zeros(4) for k in "abc"})
    assert [i for b in plan.buckets() for i in b] == [2, 1, 0]


def test_bucket_sizing():
    plan = _plan(bucket_bytes=64 * 4)  # 64 f32 elements a bucket
    plan.zero_partition({f"p{i}": torch.zeros(32) for i in range(6)})
    assert [len(b) for b in plan.buckets()] == [2, 2, 2]


def test_tree_shape_change_rejected():
    plan = _plan()
    plan.zero_partition({"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="changed shape"):
        plan.zero_partition({"a": torch.zeros(4), "b": torch.zeros(4)})


def test_quantum_rounding(monkeypatch):
    monkeypatch.setenv("HOROVOD_GRAD_BUCKET_BYTES", "100000")
    got = tbuckets.bucket_bytes_from_env()
    assert got % (64 * 1024) == 0 and got >= 100000
    assert got == jbuckets.bucket_bytes_from_env()
    monkeypatch.delenv("HOROVOD_GRAD_BUCKET_BYTES")
    assert tbuckets.bucket_bytes_from_env() \
        == jbuckets.bucket_bytes_from_env() == 4 * 1024 * 1024


SHAPES = [(3,), (5, 14), (11,), (64, 64), (9,), (128,), (2, 3, 4), (300,)]


@pytest.mark.parametrize("bucket_bytes", [1, 64, 256, 4096, 1 << 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partition_matches_jax(bucket_bytes, dtype):
    tleaves = [torch.zeros(s, dtype=getattr(torch, dtype)) for s in SHAPES]
    jleaves = [jnp.zeros(s, dtype) for s in SHAPES]
    assert _plan(bucket_bytes=bucket_bytes).zero_partition(tleaves) \
        == jbuckets.GradReleasePlan(
            bucket_bytes=bucket_bytes).zero_partition(jleaves)


def test_frozen_parameters_form_no_bucket():
    params = {k: torch.nn.Parameter(torch.zeros(8)) for k in "abc"}
    params["b"].requires_grad_(False)
    plan = _plan(bucket_bytes=1)
    assert plan.zero_partition(params) == [[2], [0]]


# -- the 2-rank world ---------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grad_buckets")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_grad_buckets_worker.run,
                         args=(r, 2, str(tmp))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("case", ["float32_avg", "float32_sum",
                                  "bfloat16_avg", "bfloat16_sum"])
def test_allreduce_release_is_bit_equal_to_allreduce(world, case):
    for out in world:
        for k in ("w", "b"):
            assert np.array_equal(out[f"ar_{case}_{k}_plan"],
                                  out[f"ar_{case}_{k}_plain"]), k
    assert np.array_equal(world[0][f"ar_{case}_w_plan"],
                          world[1][f"ar_{case}_w_plan"])


def test_reduce_scatter_release_is_bit_equal_to_scatter_gradients(world):
    for out in world:
        groups = len(out["rs_part"])
        assert groups >= 3
        for gi in range(groups):
            assert np.array_equal(out[f"rs_{gi}_plan"],
                                  out[f"rs_{gi}_plain"]), gi
        # each rank holds exactly half of each padded group, and no full
        # gradient outlived its bucket
        for shard, padded, held in out["rs_lengths"]:
            assert padded == 2 * shard and held == shard
        assert int(out["rs_grads_left"]) == 0


@pytest.mark.parametrize("label", ["ar", "rs"])
def test_train_step_with_plan_is_bit_equal_to_without(world, label):
    keys = [k[len(f"step_{label}_none_"):] for k in world[0]
            if k.startswith(f"step_{label}_none_")
            and not k.endswith(("_counts", "_hits"))]
    assert len(keys) == 6
    for out in world:
        for k in keys:
            assert np.array_equal(out[f"step_{label}_plan_{k}"],
                                  out[f"step_{label}_none_{k}"]), k
    for k in keys:
        assert np.array_equal(world[0][f"step_{label}_plan_{k}"],
                              world[1][f"step_{label}_plan_{k}"])


def test_no_gradient_goes_out_twice(world):
    """A plan beside the DistributedOptimizer's hooks: one allreduce a
    gradient a step (6 x 3), as the hooks alone send; a reduce-scatter
    plan sends no allreduce at all."""
    for out in world:
        np.testing.assert_array_equal(out["step_ar_plan_counts"], [18, 0, 0])
        np.testing.assert_array_equal(out["step_ar_none_counts"], [18, 0, 0])
        ar, rs, ag = out["step_rs_plan_counts"]
        assert ar == 0 and rs == ag and rs % 3 == 0 and rs > 3
        np.testing.assert_array_equal(out["step_rs_none_counts"], [0, 3, 3])


def test_released_collectives_come_from_the_cache(world):
    """Every name on the wire is the same each step: from the second step
    the runtime answers all of them from its response cache (ZeRO-1's
    reduce-scatter and allgather too)."""
    for out in world:
        assert list(out["step_ar_plan_hits"][1:]) == [6, 6]
        rs = int(out["step_rs_plan_counts"][1]) // 3
        assert list(out["step_rs_plan_hits"][1:]) == [2 * rs, 2 * rs]
        assert list(out["step_rs_none_hits"][1:]) == [2, 2]


# -- world 1 ------------------------------------------------------------------

@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _backward(plan, params, scale):
    plan.tag(params)
    sum((p * scale).sum() for p in params.values()).backward()
    return plan.gather()


def test_only_the_final_pass_releases(world1):
    plan = _plan(bucket_bytes=256, every_k=3)
    params = {"w": torch.nn.Parameter(torch.ones(256))}
    assert _backward(plan, params, 1.0) is None
    assert _backward(plan, params, 2.0) is None
    assert plan.wire_stats()["released"] == 0
    out = _backward(plan, params, 6.0)
    assert out is not None
    torch.testing.assert_close(out["w"], torch.full((256,), 3.0))
    assert plan.wire_stats()["released"] >= 1
    assert plan.wire_stats()["completed"] == plan.wire_stats()["released"]


def test_state_resets_between_steps(world1):
    plan = _plan(bucket_bytes=256)
    params = {"w": torch.nn.Parameter(torch.ones(128))}
    for s in (1.0, 5.0):
        params["w"].grad = None
        out = _backward(plan, params, s)
        torch.testing.assert_close(out["w"], torch.full((128,), s))
    assert plan._grads == {} and plan._released == []


def test_partial_bucket_is_released(world1):
    """A parameter the forward does not use gets no hook call: its bucket
    is released at gather (the allreduce sends what arrived; the
    reduce-scatter packs zeros in its place)."""
    for rs in (False, True):
        plan = _plan(bucket_bytes=1 << 20, reduce_scatter=rs)
        params = {k: torch.nn.Parameter(torch.ones(4)) for k in "ab"}
        plan.tag(params)
        (params["a"] * 2.0).sum().backward()
        out = plan.gather()
        if rs:
            # the cell's order: b (no gradient: zeros), then a
            np.testing.assert_array_equal(out.shards[0].numpy(),
                                          [0.0] * 4 + [2.0] * 4)
        else:
            assert out["b"] is None
            torch.testing.assert_close(out["a"], torch.full((4,), 2.0))


class _Boom:
    def wait(self):
        raise RuntimeError("injected")


def test_gather_drains_and_resets_on_failure(world1):
    plan = _plan(bucket_bytes=512)
    params = {k: torch.nn.Parameter(torch.ones(512)) for k in "ab"}
    plan.tag(params)
    sum(p.sum() for p in params.values()).backward()
    assert len(plan._released) == 2  # both buckets in flight
    bucket, pairs = plan._released[0]
    plan._released[0] = (bucket, [(pairs[0][0], _Boom())] + pairs[1:])
    with pytest.raises(RuntimeError, match="injected"):
        plan.gather()
    assert plan._released == [] and plan._grads == {}
    for p in params.values():
        p.grad = None
    out = _backward(plan, params, 2.0)  # the next step works on the plan
    torch.testing.assert_close(out["a"], torch.full((512,), 2.0))


def test_abort_clears_in_flight(world1):
    for rs in (False, True):
        plan = _plan(bucket_bytes=512, reduce_scatter=rs)
        params = {"a": torch.nn.Parameter(torch.ones(512))}
        plan.tag(params)
        params["a"].sum().backward()
        assert plan._released or plan._rs_released
        plan.abort()
        assert plan._released == [] and plan._rs_released == []
        assert plan._grads == {}


@pytest.mark.parametrize("release,stage,want", [
    (None, None, None), ("0", "3", None), ("1", None, False),
    ("1", "1", False), ("1", "2", True), ("1", "3", True), ("1", "9", True)])
def test_auto_plan_follows_zero_stage(release, stage, want, monkeypatch):
    for name, value in (("HOROVOD_GRAD_BUCKET_RELEASE", release),
                        ("HOROVOD_ZERO_STAGE", stage)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    plan = training._resolve_grad_release(None)
    if want is None:
        assert plan is None
    else:
        assert isinstance(plan, hvd.GradReleasePlan)
        assert plan.reduce_scatter is want
    assert training._resolve_grad_release(False) is None
    given = _plan()
    assert training._resolve_grad_release(given) is given


def test_prereduced_scope_skips_exchange(world1):
    grads = {"w": torch.full((32,), 2.0)}
    collectives.reset_counts()
    with tbuckets.prereduced():
        assert tbuckets.is_prereduced()
        assert hvd.allreduce_gradients(grads) is grads
    assert not tbuckets.is_prereduced()
    assert collectives.COUNTS["allreduce"] == 0


def test_grouped_allreduce_async_round_trip(world1):
    seen = []
    xs = [torch.full((64,), float(j)) for j in range(3)]
    handles = collectives.grouped_allreduce_async(
        xs, [f"gaa.t{j}" for j in range(3)], op=hvd.Sum, priority=5,
        group_callback=seen.append)
    outs = [hvd.synchronize(h) for h in handles]
    for j, o in enumerate(outs):
        torch.testing.assert_close(o, torch.full((64,), float(j)))
    assert seen == [True] * 3
    with pytest.raises(ValueError, match="pair up"):
        collectives.grouped_allreduce_async(xs, ["one"])
