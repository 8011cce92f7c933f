"""The port's ZeRO stages 2 and 3 and ``sharded_update``
(``parallel/zero.py``) against the JAX package.

Mirrors ``tests/test_zero.py``'s ``TestStage2ShardedGrads``,
``TestStage3ShardedParams`` and ``TestShardedSGDParity``:

* the knobs clamp as the JAX package's do;
* ``build_spec(partition=)`` equals the JAX one field by field, at worlds
  1-3 and on BERT-Large's shapes cut by a release plan's buckets;
* one spawned 2-rank gloo world (``tests/torch_zero_stages_worker.py``):
  scatter-then-apply bit-equal to apply on whole gradients; the
  shard/gather round trip bit-exact, each rank holding half of each
  padded group; 4 stage-3 steps bit-equal to stage 1 and within the limits
  of the JAX stage 3 on a 2-device mesh fed ``stack_per_worker``
  gradients; ``iter_param_buckets`` covering each leaf once with at most
  ``prefetch`` gathers in flight; ``sharded_update(SGD)`` bit-equal to the
  replicated ``DistributedOptimizer(SGD)``, and momentum SGD and AdamW to
  the replicated torch optimizers on allreduced gradients; both within the
  limits of the JAX ``sharded_update(optax...)``;
* the errors at world 1;
* two stage-2 and two stage-3 steps of a tiny BERT at world 1 against the
  JAX ``value_and_grad`` + ``scatter_gradients`` + ``sharded_adamw``
  (one JAX run for both: its stages are bit-equal by its own tests).

Limits as ``tests/test_torch_zero.py``'s: rtol 2e-6 / atol 1e-7 for
float32, one bfloat16 unit in the last place (rtol 2**-7) for the
bfloat16 leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
import torch_zero_stages_worker
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import buckets as jbuckets
from horovod_tpu.parallel import zero as jzero
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import grads_to_flax, params_from_flax
from horovod_tpu_torch.parallel import buckets as tbuckets
from horovod_tpu_torch.parallel import zero as tzero

RTOL, ATOL = 2e-6, 1e-7
BF16_RTOL = 2.0 ** -7
LEAVES = torch_zero_stages_worker.LEAVES
SHAPES = {"a": (3,), "b": (5, 14), "c.w": (11,), "h": (9,)}


# -- the knobs ----------------------------------------------------------------

@pytest.mark.parametrize("raw", [None, "1", "2", "3", "7", "0", "-2", "x"])
def test_stage_knob_clamps_as_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("HOROVOD_ZERO_STAGE", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_ZERO_STAGE", raw)
    assert tzero.stage_from_env() == jzero.stage_from_env()


@pytest.mark.parametrize("raw", [None, "5", "1", "0", "-3", "x"])
def test_prefetch_knob_as_jax(raw, monkeypatch):
    if raw is None:
        monkeypatch.delenv("HOROVOD_ZERO_PREFETCH_BUCKETS", raising=False)
    else:
        monkeypatch.setenv("HOROVOD_ZERO_PREFETCH_BUCKETS", raw)
    jzero.set_autotuned_prefetch_buckets(0)
    assert tzero.prefetch_buckets_from_env() \
        == jzero.prefetch_buckets_from_env()


# -- the layout ---------------------------------------------------------------

UNEVEN = [((3,), "float32"), ((5, 14), "float32"), ((11,), "float32"),
          ((9,), "bfloat16"), ((4, 4), "int32"), ((), "float32"),
          ((7,), "bfloat16")]
PARTITION = [[5, 3], [1, 6, 0, 4], [2]]  # leaf 4 alone in its dtype; all
PARTIAL = [[6, 2], [0]]                  # some leaves in no cell


@pytest.mark.parametrize("world", [1, 2, 3])
def test_build_spec_partition_matches_jax(world):
    for partition in (PARTITION, PARTIAL):
        for quantum in (64 * 1024, 16):
            jleaves = [jzero.LeafMeta(s, jnp.dtype(d)) for s, d in UNEVEN]
            tleaves = [tzero.LeafMeta(s, getattr(torch, d))
                       for s, d in UNEVEN]
            jspec = jzero.build_spec(jleaves, world, world - 1, quantum,
                                     partition=partition)
            tspec = tzero.build_spec(tleaves, world, world - 1, quantum,
                                     partition=partition)
            assert len(tspec.groups) == len(jspec.groups)
            for tg, jg in zip(tspec.groups, jspec.groups):
                for field in tzero.GroupSpec._fields:
                    assert getattr(tg, field) == getattr(jg, field), field
            assert (tspec.world, tspec.rank, tspec.num_leaves) \
                == (jspec.world, jspec.rank, jspec.num_leaves)


def test_build_spec_on_bert_large_buckets_matches_jax():
    """BERT-Large's 388 shapes, cut by each package's release plan (4 MiB
    buckets): the same partition, and the same groups at worlds 1 and 2."""
    model = ttr.BertLarge(vocab_size=30522, max_seq=512, device="meta")
    shapes = [tuple(p.shape) for p in model.parameters()]
    assert len(shapes) == 388
    tplan = tbuckets.GradReleasePlan(reduce_scatter=True)
    jplan = jbuckets.GradReleasePlan(reduce_scatter=True)
    part = tplan.zero_partition(dict(model.named_parameters()))
    assert part == jplan.zero_partition(
        [np.broadcast_to(np.zeros((), np.float32), s) for s in shapes])
    assert sorted(i for cell in part for i in cell) == list(range(388))
    for world in (1, 2):
        jspec = jzero.build_spec(
            [jzero.LeafMeta(s, jnp.dtype("float32")) for s in shapes], world,
            0, 64 * 1024, partition=part)
        tspec = tzero.build_spec(
            [tzero.LeafMeta(s, torch.float32) for s in shapes], world, 0,
            64 * 1024, partition=part)
        assert tuple(map(tuple, tspec.groups)) \
            == tuple(map(tuple, jspec.groups))
        assert sum(g.n for g in tspec.groups) == 334_090_240


# -- the 2-rank world ---------------------------------------------------------

def _jax_tree(arrays, dtype_h=jnp.bfloat16):
    return {"a": arrays["a"], "b": arrays["b"], "c": {"w": arrays["c.w"]},
            "h": jnp.asarray(arrays["h"]).astype(dtype_h)}


def _flat(tree) -> dict:
    return {"a": tree["a"], "b": tree["b"], "c.w": tree["c"]["w"],
            "h": tree["h"]}


def _close(got, want, key, what):
    rtol, atol = (BF16_RTOL, 0) if key == "h" else (RTOL, ATOL)
    np.testing.assert_allclose(got, np.asarray(jnp.asarray(want)
                                               .astype(jnp.float32)),
                               rtol=rtol, atol=atol, err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the world once; every test below reads its outputs."""
    tmp = tmp_path_factory.mktemp("zero_stages")
    rng = np.random.RandomState(0)
    inputs = {"mlp_x": rng.randn(2, 4, 6).astype(np.float32)}
    for k, s in SHAPES.items():
        inputs[f"p_{k}"] = rng.randn(*s).astype(np.float32)
        for step in range(4):
            inputs[f"g{step}_{k}"] = rng.randn(2, *s).astype(np.float32)
    for key in [k for k in inputs if k.endswith("_h")]:
        inputs[key] = np.asarray(jnp.asarray(inputs[key])
                                 .astype(jnp.bfloat16).astype(jnp.float32))
    np.savez(tmp / "inputs.npz", **inputs)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_zero_stages_worker.run,
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
    return inputs, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture
def jax_world():
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2], mesh_shape=(1, 2))
    yield jhvd
    jhvd.shutdown()


def _stacked(inputs, step, dtype_h=jnp.bfloat16):
    return _jax_tree({k: jhvd.stack_per_worker(
        [inputs[f"g{step}_{k}"][0], inputs[f"g{step}_{k}"][1]])
        for k in SHAPES}, dtype_h)


def test_scatter_then_apply_is_bit_equal_to_full_gradients(world):
    _, got = world
    for out in got:
        for k in LEAVES:
            np.testing.assert_array_equal(out[f"scatter_pre_{k}"],
                                          out[f"scatter_full_{k}"], err_msg=k)


def test_scatter_then_apply_matches_jax(world, jax_world):
    inputs, got = world
    jopt = jhvd.sharded_adamw(1e-2, weight_decay=1e-3)
    jp = _jax_tree({k: jnp.asarray(inputs[f"p_{k}"]) for k in SHAPES})
    jstate = jopt.init(jp)
    sg = jhvd.scatter_gradients(_stacked(inputs, 0), spec=jstate.spec)
    assert isinstance(sg, jhvd.ShardedGrads)
    jp, _ = jopt.apply(jp, jstate, sg)
    for out in got:
        for k, want in _flat(jp).items():
            _close(out[f"scatter_pre_{k}"], want, k, "stage 2")


def test_shard_gather_round_trip_is_bit_exact(world):
    inputs, got = world
    for out in got:
        for k in LEAVES:
            want = inputs[f"p_{k}"]
            if k == "h":  # the bf16 leaf's bits, as int16
                want = torch.from_numpy(want).to(torch.bfloat16) \
                    .view(torch.int16).numpy()
            np.testing.assert_array_equal(out[f"round_{k}"], want, err_msg=k)
        # two groups (bf16, f32); each rank holds exactly half of the pad
        for shard, padded, held in out["shard_elems"]:
            assert padded == 2 * shard and held == shard


def test_stage3_steps_are_bit_equal_to_stage1(world):
    _, got = world
    for out in got:
        for step in range(4):
            for k in LEAVES:
                np.testing.assert_array_equal(
                    out[f"s3_{step}_{k}"], out[f"s1_{step}_{k}"],
                    err_msg=f"step {step} {k}")


def test_stage3_steps_match_jax_stage3(world, jax_world):
    inputs, got = world
    jopt = jhvd.sharded_adamw(1e-2, weight_decay=1e-3)
    sp = jhvd.shard_params(_jax_tree({k: jnp.asarray(inputs[f"p_{k}"])
                                      for k in SHAPES}))
    state = jopt.init(sp)
    for step in range(4):
        sg = jhvd.scatter_gradients(_stacked(inputs, step), spec=state.spec)
        sp, state = jopt.apply(sp, state, sg)
        for out in got:
            for k, want in _flat(jhvd.gather_params(sp)).items():
                _close(out[f"s3_{step}_{k}"], want, k, f"step {step}")


def test_iter_param_buckets_covers_each_leaf_once_in_its_window(world):
    inputs, got = world
    for out in got:
        assert list(out["bucket_seen"]) == [0, 1, 2, 3]
        assert int(out["bucket_most_in_flight"]) == 2
        for k in LEAVES:
            np.testing.assert_array_equal(out[f"bucket_{k}"],
                                          inputs[f"p_{k}"], err_msg=k)


def test_sharded_sgd_is_bit_equal_to_replicated(world):
    _, got = world
    keys = [k.removeprefix("mlp_rep_") for k in got[0]
            if k.startswith("mlp_rep_")]
    assert len(keys) == 4
    for out in got:
        for k in keys:
            np.testing.assert_array_equal(out[f"mlp_zero_{k}"],
                                          out[f"mlp_rep_{k}"], err_msg=k)
    for k in keys:  # and the ranks agree
        np.testing.assert_array_equal(got[0][f"mlp_zero_{k}"],
                                      got[1][f"mlp_zero_{k}"])


@pytest.mark.parametrize("label", ["sgdm", "adamw"])
def test_sharded_update_is_bit_equal_to_replicated(world, label):
    _, got = world
    for out in got:
        for step in range(4):
            for k in LEAVES:
                np.testing.assert_array_equal(
                    out[f"{label}_{step}_{k}"], out[f"{label}_rep_{step}_{k}"],
                    err_msg=f"{label} step {step} {k}")


@pytest.mark.parametrize("label", ["sgdm", "adamw"])
def test_sharded_update_matches_jax(world, jax_world, label):
    """torch's optimizers against optax's through each package's
    ``sharded_update``. Momentum SGD: the f32 limits. AdamW: optax forms
    its bias corrections in float32, where ``1 - 0.999**t`` is 1.3e-5 off
    (0.999 rounds to 0.99900001), torch in float64; its square root scales
    each step's move of at most ~3 lr by up to 6.5e-6, so after step t the
    parameters may differ by t * lr * 2.5e-5 (1e-6 at step 4) beside the
    f32 rtol."""
    inputs, got = world
    inner = (optax.sgd(0.1, momentum=0.9) if label == "sgdm"
             else optax.adamw(1e-2, weight_decay=1e-3))
    tx = jhvd.sharded_update(inner)
    jp = _jax_tree({k: jnp.asarray(inputs[f"p_{k}"]) for k in SHAPES},
                   jnp.float32)
    state = tx.init(jp)
    assert isinstance(state, jhvd.ShardedOptState)
    for step in range(4):
        upd, state = tx.update(_stacked(inputs, step, jnp.float32), state,
                               jp)
        jp = optax.apply_updates(jp, upd)
        atol = ATOL if label == "sgdm" else (step + 1) * 1e-2 * 2.5e-5
        for out in got:
            for k, want in _flat(jp).items():
                np.testing.assert_allclose(
                    out[f"{label}_{step}_{k}"], np.asarray(want), rtol=RTOL,
                    atol=atol, err_msg=f"{label} step {step} {k}")
    # each rank's inner state is over its half of the one padded group
    n = sum(int(np.prod(s)) for s in SHAPES.values())
    per = {"sgdm": 1, "adamw": 2}[label] * 4  # buffers x bytes
    for out in got:
        assert per * n / 2 <= int(out[f"{label}_state_bytes"]) < per * n


# -- errors at world 1 ----------------------------------------------------------

@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _uneven(seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in SHAPES.items()}


def test_partition_mismatch_is_actionable(world1):
    params = _uneven(24)
    plan = hvd.GradReleasePlan(reduce_scatter=True, bucket_bytes=64)
    part = plan.zero_partition(params)
    opt = hvd.sharded_adamw(1e-2)  # the default, dtype-sorted layout
    state = opt.init(params)
    sg = hvd.scatter_gradients(params, partition=part)
    assert sg.spec.groups != state.spec.groups
    with pytest.raises(ValueError, match="zero_partition"):
        opt.apply(params, state, sg)
    su = hvd.sharded_update(torch.optim.SGD(
        [torch.nn.Parameter(p) for p in params.values()], lr=0.1))
    with pytest.raises(ValueError, match="zero_partition"):
        su.step(grads=sg)


def test_backward_passes_per_step_rejected_with_sharding(world1):
    model = torch.nn.Linear(3, 2)
    with pytest.raises(ValueError, match="backward_passes_per_step"):
        hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 backward_passes_per_step=2,
                                 shard_optimizer_states=True)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   shard_optimizer_states=True)
    assert isinstance(opt, tzero.ShardedOptimizer)


def test_allreduce_gradients_rejects_sharded_grads(world1):
    params = _uneven(23)
    state = hvd.sharded_adamw(1e-2).init(params)
    sg = hvd.scatter_gradients(params, spec=state.spec)
    with pytest.raises(TypeError, match="already the reduced"):
        hvd.allreduce_gradients(sg)


def test_stage3_needs_sharded_grads_and_its_own_shards(world1):
    params = _uneven(25)
    opt = hvd.sharded_adamw(1e-2)
    sp = hvd.shard_params(params)
    state = opt.init(sp)
    with pytest.raises(TypeError, match="ShardedGrads"):
        opt.apply(sp, state, params)
    su = hvd.sharded_update(torch.optim.SGD(
        [torch.nn.Parameter(p) for p in params.values()], lr=0.1))
    other = hvd.shard_params(params)
    st = su.init(sp)
    with pytest.raises(ValueError, match="init it over these"):
        su.update(hvd.scatter_gradients(params, spec=st.spec), st, other)


# -- a tiny BERT at world 1 -------------------------------------------------------

BERT = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=4, d_ff=128,
            max_seq=32)


@pytest.fixture(scope="module")
def bert_jax():
    """The tiny BERT's data and initial weights, and two JAX steps of
    ``value_and_grad`` (jitted) + ``scatter_gradients`` + ``sharded_adamw``
    at world 1: the losses and the parameters after each step."""
    jm = jtr.BertBase(dtype=jnp.float32, **BERT)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 32)).astype(np.int32)
    pos = jtr.sample_masked_positions(np.random.default_rng(0), 2, 32, 5)
    labels = np.take_along_axis(tokens, pos, axis=1)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[:1], train=False))

    def jloss(p):
        hidden = jm.apply(p, tokens, output="hidden")
        return jtr.masked_lm_loss_gathered(
            hidden, p["params"]["token_embed"]["embedding"], pos, labels)

    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:1], mesh_shape=(1, 1))
    try:
        jopt = jhvd.sharded_adamw(1e-4)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = jopt.init(jparams)
        grad_fn = jax.jit(jax.value_and_grad(jloss))
        steps = []
        for _ in range(2):
            jl, g = grad_fn(jparams)
            sg = jhvd.scatter_gradients(g, spec=jstate.spec)
            jparams, jstate = jopt.apply(jparams, jstate, sg)
            steps.append((float(jl), jax.tree_util.tree_map(
                np.asarray, jparams["params"])))
    finally:
        jhvd.shutdown()
    return (tokens, pos, labels), params, steps


@pytest.mark.parametrize("stage", [2, 3])
def test_bert_two_steps_match_jax(bert_jax, stage):
    """Stage 2 (a reduce-scatter release plan of 4 KiB buckets feeding a
    partition-aligned ``sharded_adamw``) and stage 3 (the same, with the
    parameters sharded at rest and refilled through ``iter_param_buckets``
    before each forward) at world 1 on a tiny BERT, against the JAX
    ``value_and_grad`` + ``scatter_gradients`` + ``sharded_adamw``, held to
    ``test_torch_zero.py``'s ZeRO-1 limits (parameters 1e-6 abs; the key
    bias, whose true gradient is 0, 2 * lr per step)."""
    (tokens, pos, labels), params, steps = bert_jax
    tm = ttr.BertBase(dtype=torch.float32, device="cpu", **BERT)
    tm.load_state_dict(params_from_flax(params))
    tp = dict(tm.named_parameters())
    toks, tpos, tlab = map(torch.from_numpy, (tokens, pos, labels))
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        plan = hvd.GradReleasePlan(reduce_scatter=True, bucket_bytes=4096)
        part = plan.zero_partition(tp)
        assert len(part) > 4
        topt = hvd.sharded_adamw(1e-4, partition=part)
        tsp = hvd.shard_params(tp, partition=part) if stage == 3 else None
        tstate = topt.init(tsp if stage == 3 else tp)
        leaves = list(tp.values())
        for step, (jl, jparams) in enumerate(steps, 1):
            if stage == 3:
                with torch.no_grad():
                    for _, bucket in hvd.iter_param_buckets(tsp):
                        for i, t in bucket.items():
                            leaves[i].copy_(t)
            tm.zero_grad(set_to_none=True)
            plan.tag(tp)
            tl = ttr.masked_lm_loss_gathered(tm(toks, output="hidden"),
                                             tm.token_embed, tpos, tlab)
            tl.backward()
            tsg = plan.gather()
            assert isinstance(tsg, hvd.ShardedGrads)
            assert all(p.grad is None for p in leaves)
            if stage == 3:
                tsp, tstate = topt.apply(tsp, tstate, tsg)
                got_params = hvd.gather_params(tsp)
            else:
                _, tstate = topt.apply(tp, tstate, tsg)
                got_params = tp
            np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
            got = dict(jax.tree_util.tree_leaves_with_path(
                grads_to_flax(got_params, params)))
            for path, want in jax.tree_util.tree_leaves_with_path(jparams):
                name = jax.tree_util.keystr(path)
                tol = 2e-4 * step if "['key']['bias']" in name else 1e-6
                np.testing.assert_allclose(got[path], want, rtol=0,
                                           atol=tol, err_msg=name)
        assert tstate.count == 2 and len(tstate.master) == len(part)
    finally:
        hvd.shutdown()
