"""The port's tensor parallelism (``horovod_tpu_torch/parallel/tp.py``:
Megatron's layout with its collectives written out) against the JAX
package's GSPMD tensor parallelism (``tests/test_tp.py``).

* The rules' plan on a small model, mirroring ``tests/test_tp.py:23-43``:
  q/k/v and ``mlp.wi`` sharded along their output features (dim 0 of the
  torch ``(out, in)`` layout), ``mlp.wo`` and ``attention.out`` along their
  input features (dim 1), the token embedding over the vocab, the rest
  (``final_norm``, a fused ``qkv``) replicated; every rule names its axis.
* Two SGD(0.1, momentum 0.9) steps of ``tp_train_step`` over TP ``local``
  (2 ranks) x DP ``cross`` (2 ranks) in a 4-rank gloo world
  (``tests/torch_model_parallel_worker.py``, mode ``tp``, with the
  knobs of ``AUTOTUNE``) against two unsharded steps of the JAX model
  (``tests/test_tp.py:45-88``), float32, ``xla_attention``: the losses
  within 1e-5 relative and every parameter, its shards put back together,
  within 1e-5 absolute (the JAX test's own limits: the same sums in other
  orders). The same with a fused ``qkv`` (replicated by the rules: each
  rank runs every head, and the row-parallel output projection takes its
  slice of the attention's output), against the same JAX steps.

The same world (mode ``groups`` first) holds where the axes' groups are
made, with the autotuner sweeping the two-level hierarchy (group size 2),
whose groups the runtime's cycle thread makes at a cycle of its choosing:

* the ``local`` and ``cross`` groups are made from the caller's thread
  while the tuner sweeps (with an async allreduce in flight):
  ``new_group(use_local_synchronization=True)`` names them by a hash of
  their ranks, so the world's running group count, which the cycle
  thread's groups take their names from, does not move, and each rank's
  names agree. Ring steps on both axes (causal, 2 shards of 4) stay within
  2e-6 of the plain attention over the axis' whole sequence at every
  iteration until the tuner freezes, and the hierarchy's groups were
  built;
* the ordered-lane guard after ``tests/mp_worker.py:555-582``: clear with
  nothing in flight; on rank 0, with a named allreduce its peers have not
  joined, it raises ``OrderedLaneError`` (the other ranks, with nothing in
  flight, pass), and so do ``ring_attention``, ``ulysses_attention`` and
  ``pipeline_apply`` before any collective of theirs; once every rank has
  joined and the op is done, it is clear again. At world 1 it never
  raises.
"""

import numpy as np
import pytest
import torch

import torch_model_parallel_worker as worker

LM = worker.TP_LM
# the axes' groups are made while the autotuner sweeps the two-level
# hierarchy, whose groups the runtime's cycle thread makes
AUTOTUNE = {
    "HOROVOD_LOCAL_SIZE": "2",
    "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "0",
    "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "1",
    "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "2",
    "HOROVOD_HIERARCHY_GROUP_SIZE": "2", "HOROVOD_CYCLE_TIME": "2",
    "HOROVOD_GLOO_TIMEOUT_SECONDS": "30",
}


@pytest.fixture
def one_rank(monkeypatch):
    import horovod_tpu_torch as hvd

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR",
              "HOROVOD_LOCAL_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_rules_shard_expected_params(one_rank):
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.parallel.tp import Shard

    hvd = one_rank
    rules = hvd.transformer_tp_rules("local")
    assert {axis for _, axis, _ in rules} == {"local"}
    model = Transformer(**LM, causal=True, dtype=torch.float32,
                        device="meta")
    plan = hvd.params_shardings(dict(model.named_parameters()), "local",
                                rules)
    assert plan["layers.0.attention.query.weight"] == Shard(0, 0, 1)
    assert plan["layers.1.attention.value.bias"] == Shard(0, 0, 1)
    assert plan["layers.0.attention.out.weight"] == Shard(1, 0, 1)
    assert plan["layers.0.attention.out.bias"] is None
    assert plan["layers.0.mlp.wi.weight"].dim == 0
    assert plan["layers.0.mlp.wi.bias"].dim == 0
    assert plan["layers.0.mlp.wo.weight"].dim == 1
    assert plan["layers.0.mlp.wo.bias"] is None
    assert plan["token_embed"].dim == 0
    # non-matching params replicate, a fused qkv too
    for name in ("final_norm.weight", "pos_embed", "layers.0.ln1.bias"):
        assert plan[name] is None, name
    fused = Transformer(**LM, causal=True, fused_qkv=True, device="meta")
    fplan = hvd.params_shardings(dict(fused.named_parameters()), "local",
                                 rules)
    assert fplan["layers.0.attention.qkv.weight"] is None
    assert fplan["layers.0.attention.out.weight"].dim == 1
    # a slice of a sharded layout: rank 1 of 2 along dim 1
    t = torch.arange(12.0).view(3, 4)
    assert torch.equal(Shard(1, 1, 2).local(t), t[:, 2:])
    with pytest.raises(ValueError, match="equal slices"):
        Shard(0, 0, 2).local(t)
    assert hvd.xla_attention is not None


def _jax_model():
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import Transformer
    from horovod_tpu.parallel.tp import xla_attention

    return Transformer(**LM, causal=True, dtype=jnp.float32,
                       attention_fn=xla_attention)


def _jax_steps(params, tokens):
    """Two unsharded SGD steps of the JAX model (``tests/test_tp.py``)."""
    import jax
    import optax

    from horovod_tpu.models.transformer import causal_lm_loss

    model = _jax_model()
    opt = optax.sgd(worker.TP_LR, momentum=0.9)

    @jax.jit
    def step(p, s, x):
        loss, grads = jax.value_and_grad(lambda p: causal_lm_loss(
            model.apply({"params": p}, x, train=True), x))(p)
        updates, s = opt.update(grads, s, p)
        return loss, optax.apply_updates(p, updates), s

    p, s, losses = params, opt.init(params), []
    for _ in range(worker.TP_STEPS):
        loss, p, s = step(p, s, tokens)
        losses.append(float(loss))
    return np.array(losses), jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    import jax

    from horovod_tpu_torch.models.convert import params_from_flax

    tmp = tmp_path_factory.mktemp("tp")
    tokens = np.random.RandomState(0).randint(
        0, LM["vocab_size"], (8, LM["max_seq"])).astype(np.int32)
    init = jax.tree_util.tree_map(np.asarray, _jax_model().init(
        jax.random.PRNGKey(1), tokens, train=False)["params"])
    np.savez(tmp / "inputs.npz", tokens=tokens, **{
        f"sd.{k}": v.numpy() for k, v in params_from_flax(init).items()})
    procs = worker.start(tmp, 4, "groups,tp", env=AUTOTUNE)
    losses, stepped = _jax_steps(init, tokens)  # while the world runs
    return worker.join(procs, tmp), losses, stepped


def _whole(got, tag, name, members):
    """A parameter put back together from the TP group's shards."""
    dim = int(got[members[0]][f"{tag}.dim.{name}"])
    parts = [got[r][f"{tag}.p.{name}"] for r in members]
    return parts[0] if dim < 0 else np.concatenate(parts, axis=dim)


@pytest.mark.parametrize("tag", ["tp", "fused"])
def test_tp_training_matches_unsharded(tp_world, tag):
    """Two steps under TP(local) x DP(cross) == two steps unsharded."""
    from horovod_tpu_torch.models.convert import params_from_flax
    from horovod_tpu_torch.models.transformer import fuse_qkv_state

    got, losses, stepped = tp_world
    want = params_from_flax(stepped)
    if tag == "fused":
        want = fuse_qkv_state(want)
    for r, out in enumerate(got):
        np.testing.assert_allclose(out[f"{tag}.losses"], losses, rtol=1e-5,
                                   err_msg=f"rank {r}")
    for members in ((0, 1), (2, 3)):  # the two TP groups (local)
        for name, w in want.items():
            np.testing.assert_allclose(
                _whole(got, tag, name, members), w.numpy(), rtol=0,
                atol=1e-5, err_msg=f"{tag} {name} ranks {members}")
    # the TP shards are the local halves: 1/2 of mlp.wi's rows a rank
    wi = got[0][f"{tag}.p.layers.0.mlp.wi.weight"]
    assert wi.shape == (LM["d_ff"] // 2, LM["d_model"])


def test_axis_groups_beside_the_hierarchy_sweep(tp_world):
    got = tp_world[0]
    for r, out in enumerate(got):
        assert out["groups.count_moved"].tolist() == [0], r
        assert out["groups.ring_err"] <= 2e-6, (r, out["groups.ring_err"])
        assert out["groups.hier_built"] > 0, r
        # hashed names, not the running count's numbers
        assert not any(str(n).isdigit() for n in out["groups.names"])
    # a local pair shares its local group's name, a cross pair its cross's
    names = [list(map(str, out["groups.names"])) for out in got]
    assert names[0][0] == names[1][0] != names[2][0] == names[3][0]
    assert names[0][1] == names[2][1] != names[1][1] == names[3][1]
    its = {int(out["groups.iterations"]) for out in got}
    assert len(its) == 1 and its.pop() > 4


def test_lane_guard_raises_and_clears(tp_world):
    got = tp_world[0]
    assert "still in flight" in str(got[0]["lane.raised"])
    for name in ("ring", "ulysses", "pipeline"):
        assert bool(got[0][f"lane.{name}"]), name
    assert all("lane.raised" not in out for out in got[1:])
    assert all(bool(out["lane.cleared"]) for out in got)


def test_lane_guard_at_world_one(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import OrderedLaneError

    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert issubclass(OrderedLaneError, RuntimeError)
    assert hvd.OrderedLaneError is OrderedLaneError
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        hvd.assert_collective_lane_clear()  # before the runtime starts
        h = hvd.allreduce_async(torch.ones(2), name="lane.one")
        hvd.assert_collective_lane_clear()  # world 1: never
        hvd.synchronize(h)
    finally:
        hvd.shutdown()
