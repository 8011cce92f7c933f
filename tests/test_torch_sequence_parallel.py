"""The port's sequence parallelism (``horovod_tpu_torch/parallel/ring.py``,
``ulysses.py``) and ``merge_partials`` against the JAX package's, on the
CPU, in 2- and 3-rank gloo worlds (``tests/torch_model_parallel_worker.py``,
mode ``seq``); the JAX side runs ``shard_map`` over a mesh of the first n
virtual CPU devices, as ``tests/test_sequence_parallel.py`` does over all
of them, with the same numpy inputs (float32 throughout).

* ``merge_partials`` of three key shards' partials against JAX's, and
  merging with an empty partial (zeros, ``-inf``) gives the other partial
  back bit for bit.
* The causal ring's output within 2e-5 and its gradients of ``sum(o *
  do)`` within 1e-4 of the JAX ring's (``ring_attention`` under
  ``shard_map``; the same algorithm, float32 in other orders). The
  non-causal ring against JAX's ``attention_reference`` and its autograd
  gradients, within the same limits: XLA's CPU partitioner rejects the
  non-causal JAX ring (``tests/test_sequence_parallel.py:207-215``).
* Ulysses, causal and not, against the JAX Ulysses within the same
  limits, and the indivisible-heads ``ValueError`` with the JAX wording.
* In the 2-rank world, a 2-layer causal ``Transformer`` (d 48, 6 heads)
  with ``attention_fn`` set to each strategy and each rank's
  ``pos_offset``: the shard's logits
  within 1e-4, its causal LM loss within 1e-5 relative, and the gradients
  of the ranks' summed losses within 1e-4 of each leaf's norm of the JAX
  model's under ``shard_map`` with the JAX strategy (measured at most
  2.0e-6), plus 1e-7 absolute: the key bias' gradient is 0 in exact
  arithmetic (a softmax does not see one constant added to a row's
  scores), and both sides give float32 noise of a few 1e-9 there.
"""

import numpy as np
import pytest
import torch

import torch_model_parallel_worker as worker

TOL_O = dict(rtol=0, atol=2e-5)
TOL_GRAD = dict(rtol=0, atol=1e-4)
TOL_LOGITS = dict(rtol=0, atol=1e-4)
TOL_LEAF, TOL_ZERO = 1e-4, 1e-7
LM_RANKS = 2  # the world that also runs the transformer


def _inputs(n: int, jparams) -> dict:
    from horovod_tpu_torch.models.convert import params_from_flax

    rng = np.random.RandomState(10 + n)
    shape = (worker.B, worker.H, n * worker.S_LOCAL, worker.D)
    mk = lambda: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    inp = dict(q=mk(), k=mk(), v=mk(), do=mk())
    if n == LM_RANKS:
        inp["tokens"] = rng.randint(0, worker.LM["vocab_size"], (
            worker.B, n * worker.S_LOCAL)).astype(np.int32)
        inp.update({f"sd.{k}": v.numpy()
                    for k, v in params_from_flax(jparams).items()})
    return inp


def _jax_model(n, attention_fn):
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import Transformer

    return Transformer(**worker.LM, max_seq=n * worker.S_LOCAL, causal=True,
                       dtype=jnp.float32, attention_fn=attention_fn)


def _jax_side(inp: dict, n: int, jparams) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.models.transformer import causal_lm_loss
    from horovod_tpu.ops.pallas import attention_reference
    from horovod_tpu.parallel.ring import ring_attention
    from horovod_tpu.parallel.ulysses import ulysses_attention

    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    sp = P(None, None, "sp")
    q, k, v, do = (jnp.asarray(inp[x]) for x in ("q", "k", "v", "do"))
    out = {}

    def ring(causal):
        return lambda q, k, v: ring_attention(q, k, v, "sp", causal, None,
                                              32, 32)

    def uly(causal):
        return lambda q, k, v: ulysses_attention(
            q, k, v, "sp", causal=causal, block_q=32, block_k=32)

    def record(tag, f):
        o, vjp = jax.vjp(f, q, k, v)
        out.update({f"{tag}.o": o, **dict(zip(
            (f"{tag}.dq", f"{tag}.dk", f"{tag}.dv"), vjp(do)))})

    def sharded(local):
        return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(sp,) * 3,
                                     out_specs=sp, check_vma=False))

    record("ring.c", sharded(ring(True)))
    record("ring.n", lambda q, k, v: attention_reference(q, k, v))
    for causal in (True, False):
        record(f"uly.{'c' if causal else 'n'}", sharded(uly(causal)))

    if n != LM_RANKS:
        return jax.tree_util.tree_map(np.asarray, out)
    tokens = jnp.asarray(inp["tokens"])
    for name, fn in (("ring", lambda q, k, v, causal: ring_attention(
            q, k, v, "sp", causal, None, 32, 32)),
            ("uly", lambda q, k, v, causal: ulysses_attention(
                q, k, v, "sp", causal=causal, block_q=32, block_k=32))):
        model = _jax_model(n, fn)

        def local(p, t, model=model):
            off = jax.lax.axis_index("sp") * t.shape[1]
            logits = model.apply({"params": p}, t, pos_offset=off)
            return logits, causal_lm_loss(logits, t)[None]

        f = jax.shard_map(local, mesh=mesh, in_specs=(P(), P(None, "sp")),
                          out_specs=(P(None, "sp"), P("sp")),
                          check_vma=False)
        logits, losses = jax.jit(f)(jparams, tokens)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(f(p, tokens)[1])))(
            jparams)
        out[f"lm.{name}.logits"], out[f"lm.{name}.losses"] = logits, losses
        out[f"lm.{name}.grads"] = grads
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def world(request, tmp_path_factory):
    import jax

    n = request.param
    tmp = tmp_path_factory.mktemp(f"seq{n}")
    model = _jax_model(n, None)
    jparams = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(n), np.zeros((1, n * worker.S_LOCAL), np.int32),
        train=False)["params"])
    inp = _inputs(n, jparams)
    np.savez(tmp / "inputs.npz", **inp)
    procs = worker.start(tmp, n, "seq")  # the world runs while JAX computes
    want = _jax_side(inp, n, jparams)
    return n, worker.join(procs, tmp), want


def _shard(a, r):
    return a[:, :, r * worker.S_LOCAL:(r + 1) * worker.S_LOCAL]


def test_merge_partials_matches_jax():
    import jax.numpy as jnp

    from horovod_tpu.ops.pallas import flash_attention_partial as jpartial
    from horovod_tpu.ops.pallas import merge_partials as jmerge
    from horovod_tpu_torch.ops import flash_attention as fa

    rng = np.random.RandomState(0)
    q, k, v = (rng.normal(size=(2, 4, 96, 32)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = want = None
    for i in range(3):  # three key shards, the first in the queries' future
        sl = slice(i * 32, (i + 1) * 32)
        tp_ = fa.flash_attention_partial(
            tq[:, :, :32], tk[:, :, sl].contiguous(),
            tv[:, :, sl].contiguous(), causal=True, q_offset=32,
            k_offset=(2 - i) * 32)
        jp = jpartial(jnp.asarray(q[:, :, :32]), jnp.asarray(k[:, :, sl]),
                      jnp.asarray(v[:, :, sl]), causal=True, q_offset=32,
                      k_offset=(2 - i) * 32, block_q=32, block_k=32)
        got = tp_ if got is None else fa.merge_partials(*got, *tp_)
        want = jp if want is None else jmerge(*want, *jp)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL_O)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=0, atol=1e-5)
    # the partial whose keys all lie in the future: lse -inf, weight 0
    first = fa.flash_attention_partial(
        tq[:, :, :32], tk[:, :, :32].contiguous(), tv[:, :, :32].contiguous(),
        causal=True, q_offset=32, k_offset=64)
    assert bool(torch.isneginf(first[1]).all()) and not first[0].any()
    empty = (torch.zeros_like(got[0]), torch.full_like(got[1], -np.inf))
    for a, b in ((empty, got), (got, empty)):
        o, lse = fa.merge_partials(*a, *b)
        assert torch.equal(o, got[0]) and torch.equal(lse, got[1])


@pytest.mark.parametrize("tag", ["ring.c", "ring.n", "uly.c", "uly.n"])
def test_attention_and_gradients_match_jax(world, tag):
    n, got, want = world
    for r, out in enumerate(got):
        np.testing.assert_allclose(out[f"{tag}.o"],
                                   _shard(want[f"{tag}.o"], r),
                                   err_msg=f"{tag} o rank {r}", **TOL_O)
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(out[f"{tag}.{g}"],
                                       _shard(want[f"{tag}.{g}"], r),
                                       err_msg=f"{tag} {g} rank {r}",
                                       **TOL_GRAD)


def test_ulysses_rejects_indivisible_heads(world):
    n, got, _ = world
    for out in got:
        msg = str(out["uly.err"])
        assert msg == (f"ulysses_attention needs heads ({n + 1}) divisible "
                       f"by the 'world' axis size ({n}); use ring attention "
                       "otherwise"), msg


@pytest.mark.parametrize("world", [LM_RANKS], indirect=True,
                         ids=[f"{LM_RANKS}ranks"])
@pytest.mark.parametrize("name", ["ring", "uly"])
def test_transformer_with_attention_fn_matches_jax(world, name):
    import jax

    from horovod_tpu_torch.models.convert import params_from_flax

    n, got, want = world
    s = worker.S_LOCAL
    for r, out in enumerate(got):
        np.testing.assert_allclose(
            out[f"lm.{name}.logits"],
            want[f"lm.{name}.logits"][:, r * s:(r + 1) * s],
            err_msg=f"{name} logits rank {r}", **TOL_LOGITS)
        np.testing.assert_allclose(out[f"lm.{name}.loss"],
                                   want[f"lm.{name}.losses"][r], rtol=1e-5)
    jgrads = params_from_flax(jax.tree_util.tree_map(
        np.asarray, want[f"lm.{name}.grads"]))
    for out in got:
        for key, g in jgrads.items():
            a, b = out[f"lm.{name}.g.{key}"], g.numpy()
            err = np.linalg.norm(a - b)
            assert err <= TOL_LEAF * np.linalg.norm(b) + TOL_ZERO, (
                name, key, err, np.linalg.norm(b))
