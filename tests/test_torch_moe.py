"""The port's expert parallelism (``horovod_tpu_torch/parallel/ep.py``) and
MoE LM (``models/moe.py``) against the JAX package's, on the CPU, in 2-
and 3-rank gloo worlds (``tests/torch_moe_worker.py``, one expert a rank);
the JAX side runs ``shard_map`` over a sub-mesh of the first n virtual
CPU devices, with the same numpy inputs.

* ``switch_moe`` (``tanh`` expert, width 8, 16 tokens a rank) at an ample
  capacity and at one that drops tokens: the output, the router
  probabilities and the gradients of ``sum(y * dy)`` in the tokens, the
  logits and each rank's expert within 1e-5 (abs and rel; float32, the
  same math in other orders; the gradients cross both exchanges).
  ``load_balance_loss`` averaged over the ranks and alone, and
  ``default_capacity``, the same.
* The MoE LM (vocab 64, d 32, 2 layers, 4 heads, 2 x 16 tokens a rank),
  from the same ``RandomState`` as the JAX ``init_moe_lm``: the weights
  are bit-equal. Logits within 2e-2 of their norm and aux within 1e-4:
  the port's attention casts q, k and v to bfloat16 at the kernels' door
  (the JAX model feeds float32 to its kernel), which costs a few 1e-3 of
  the logits' norm here (measured 2.5e-3 to 3.6e-3 over the ranks of both
  worlds; aux 1.0e-5 relative).
* One Adam(3e-3) step: the shared gradients (averaged over the ranks by
  ``DistributedOptimizer``) and each rank's expert gradient (the sum over
  the ranks' tokens, scaled by 1/size by ``MoeLM``) within 3e-2 of each
  leaf's norm of JAX's ``value_and_grad`` of ``pmean(lm) + 0.01 * aux``
  (measured at most 8.0e-3, from the bfloat16 attention; a wrong scale
  would be off by 1/2 or 2/3 of the leaf); the shared and expert
  parameters after the step within 1e-5 absolute of JAX's wherever JAX's
  gradient element is above a twentieth of its leaf's RMS (measured at
  most 6.9e-7). Adam's first step moves an element by ~lr = 3e-3 in the
  direction of its gradient's sign whatever its size, so an element whose
  gradient lies within the bfloat16 attention's noise of 0 may move the
  other way: those are held to the step's own bound, 2 lr (measured: 35
  to 42 elements a rank moved apart by more than 5e-4).
* From the second step every collective the step requests (the four
  exchanges and the balance allreduces a layer, the loss's mean and the
  shared gradients) is answered from the runtime's response cache: the
  exchanges' names carry no step number.

``test_moe_across_the_cards`` (marked ``gpu``) runs the worker's
``cards`` on every card of the machine, one rank and one expert a card:
the routing within 2e-2 of a local recomputation from the allgathered
tokens, router logits and experts, and three steps with finite losses.
This file imports JAX only inside the CPU tests, so the ``gpu`` test runs
where JAX is absent (``--noconftest``).
"""

import numpy as np
import pytest
import torch

import torch_moe_worker as worker

SEED = 5
TOL_SW = dict(rtol=1e-5, atol=1e-5)
TOL_LOGITS, TOL_AUX, TOL_GRAD, TOL_STEP = 2e-2, 1e-4, 3e-2, 1e-5
NOISE = 0.05  # of a leaf's gradient RMS: below it, a sign may flip


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(n: int) -> dict:
    rng = np.random.RandomState(n)
    t, d = worker.TOKENS, worker.DIM
    tokens = rng.randint(0, worker.LM["vocab_size"],
                         (n, worker.LM_BATCH, worker.LM["max_seq"]))
    from horovod_tpu_torch.parallel.ep import default_capacity

    return dict(
        x=rng.randn(n, t, d).astype(np.float32),
        logits=rng.randn(n, t, n).astype(np.float32),
        w=(rng.randn(n, d, d) * 0.5).astype(np.float32),
        dy=rng.randn(n, t, d).astype(np.float32),
        short=np.array(max(1, t // (2 * n))),
        tokens=tokens.astype(np.int32), seed=np.array(SEED),
        capacity=np.array(default_capacity(
            worker.LM_BATCH * worker.LM["max_seq"], n)))


def _jax_side(inp: dict, n: int) -> dict:
    """The JAX package's switch_moe, load_balance_loss and MoE LM on a
    sub-mesh of the first ``n`` CPU devices."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, PartitionSpec as P

    from horovod_tpu.models import moe as jmoe
    from horovod_tpu.parallel import ep as jep

    mesh = Mesh(np.array(jax.devices()[:n]), ("e",))
    e = P("e")
    out = {}

    def flat(a):
        return jnp.asarray(a.reshape((-1,) + a.shape[2:]))

    x, logits, dy = flat(inp["x"]), flat(inp["logits"]), flat(inp["dy"])
    w = jnp.asarray(inp["w"])
    for tag, cap in (("ample", worker.TOKENS), ("short", int(inp["short"]))):
        def inner(w, x, logits, cap=cap):
            return jep.switch_moe(x, logits, lambda p, h: jnp.tanh(h @ p),
                                  w, "e", cap)

        f = jax.shard_map(inner, mesh=mesh, in_specs=(e, e, e),
                          out_specs=(e, e), check_vma=False)

        def loss(x, logits, w, f=f):
            return jnp.sum(f(w, x, logits)[0] * dy)

        y, probs = jax.jit(f)(w, x, logits)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(x, logits, w)
        out.update({f"sw.{tag}.y": y, f"sw.{tag}.probs": probs,
                    f"sw.{tag}.dx": grads[0], f"sw.{tag}.dlogits": grads[1],
                    f"sw.{tag}.dw": grads[2]})
        if tag == "ample":
            lb = jax.shard_map(
                lambda p: (jep.load_balance_loss(p, axis_name="e"),
                           jep.load_balance_loss(p)[None]),
                mesh=mesh, in_specs=(e,), out_specs=(P(), e),
                check_vma=False)
            out["lb"], out["lb_local"] = jax.jit(lb)(probs)

    lm = worker.LM
    params = jmoe.init_moe_lm(np.random.RandomState(SEED), n_experts=n,
                              **lm)
    tokens = flat(inp["tokens"])
    cap = int(inp["capacity"])

    def apply(shared, experts, tokens):
        lg, aux = jmoe.apply_moe_lm({"shared": shared, "experts": experts},
                                    tokens, "e", cap,
                                    num_heads=lm["num_heads"])
        return lg, aux

    out["lm.logits"], out["lm.aux"] = jax.jit(jax.shard_map(
        apply, mesh=mesh, in_specs=(P(), e, e), out_specs=(e, P()),
        check_vma=False))(params["shared"], params["experts"], tokens)

    def loss_fn(p, tokens):
        def inner(shared, experts, tokens):
            return jmoe.moe_lm_loss({"shared": shared, "experts": experts},
                                    tokens, "e", cap,
                                    num_heads=lm["num_heads"])

        return jax.shard_map(inner, mesh=mesh, in_specs=(P(), e, e),
                             out_specs=P(), check_vma=False)(
            p["shared"], p["experts"], tokens)

    tx = optax.adam(worker.LR)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, tokens)
    upd, _ = tx.update(grads, tx.init(params), params)
    out.update(params=params, grads=grads, loss=loss,
               stepped=optax.apply_updates(params, upd))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def world(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"moe{n}")
    inp = _inputs(n)
    np.savez(tmp / "inputs.npz", **inp)
    import jax  # noqa: F401  (the CPU mesh before the world starts)

    procs = worker.start(tmp, n)  # the world runs while JAX computes
    want = _jax_side(inp, n)
    return n, inp, worker.join(procs, tmp), want


def test_switch_moe_matches_jax(world):
    n, inp, got, want = world
    t = worker.TOKENS
    for tag in ("ample", "short"):
        for r, out in enumerate(got):
            rows = slice(r * t, (r + 1) * t)
            for k in ("y", "probs", "dx", "dlogits"):
                np.testing.assert_allclose(
                    out[f"sw.{tag}.{k}"], want[f"sw.{tag}.{k}"][rows],
                    err_msg=f"{tag} {k} rank {r}", **TOL_SW)
            np.testing.assert_allclose(out[f"sw.{tag}.dw"],
                                       want[f"sw.{tag}.dw"][r],
                                       err_msg=f"{tag} dw rank {r}",
                                       **TOL_SW)
    # the short capacity dropped tokens (their output is 0), the ample none
    ys = np.concatenate([out["sw.short.y"] for out in got])
    assert (np.abs(ys).sum(-1) == 0).any()
    ya = np.concatenate([out["sw.ample.y"] for out in got])
    assert (np.abs(ya).sum(-1) > 0).all()


def test_load_balance_loss_and_default_capacity_match_jax(world):
    n, _, got, want = world
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["lb"], want["lb"], **TOL_SW)
        np.testing.assert_allclose(out["lb_local"], want["lb_local"][r],
                                   **TOL_SW)
    from horovod_tpu.parallel.ep import default_capacity as jcap
    from horovod_tpu_torch.parallel.ep import default_capacity as tcap

    for args in ((32, n), (7, 3), (1, 8), (1024, 4, 2.0), (5, 2, 0.1)):
        assert tcap(*args) == jcap(*args), args


def _port_tree(out, prefix: str, like, rank: int) -> dict:
    from horovod_tpu_torch.models.convert import moe_to_jax

    tensors = {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
               if k.startswith(prefix)}
    return moe_to_jax(tensors, {"shared": like["shared"], "experts": {
        "layers": [{k: v[rank] for k, v in lyr.items()}
                   for lyr in like["experts"]["layers"]]}})


def _leaves(tree):
    import jax

    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_moe_lm_logits_and_aux_match_jax(world):
    n, _, got, want = world
    b = worker.LM_BATCH
    for r, out in enumerate(got):
        err = _rel(out["lm.logits"], want["lm.logits"][r * b:(r + 1) * b])
        assert err <= TOL_LOGITS, (r, err)
        np.testing.assert_allclose(out["lm.aux"], want["lm.aux"],
                                   rtol=TOL_AUX)


def test_moe_lm_weights_come_from_the_jax_draws():
    """``MoeLM(seed)`` holds the JAX ``init_moe_lm(RandomState(seed))``
    numbers, bit for bit, with rank r's expert row r; ``moe_from_jax``
    and ``moe_to_jax`` invert each other."""
    import jax

    from horovod_tpu.models import moe as jmoe
    from horovod_tpu_torch.models import moe as tmoe
    from horovod_tpu_torch.models.convert import moe_from_jax, moe_to_jax

    params = jax.tree_util.tree_map(np.asarray, jmoe.init_moe_lm(
        np.random.RandomState(SEED), n_experts=3, **worker.LM))
    mine = tmoe.init_moe_lm(np.random.RandomState(SEED), n_experts=3,
                            **worker.LM)
    assert _leaves(mine).keys() == _leaves(params).keys()
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(_leaves(mine)[k], v, err_msg=k)
    model = tmoe.MoeLM(**worker.LM, n_experts=3, rank=2, device="cpu",
                       seed=SEED)
    state = model.state_dict()
    for k, v in moe_from_jax(params, 2).items():
        assert torch.equal(state[k], v), k
    back = moe_to_jax(state, mine)
    np.testing.assert_array_equal(back["experts"]["layers"][1]["wo"],
                                  params["experts"]["layers"][1]["wo"][2])
    np.testing.assert_array_equal(back["shared"]["layers"][0]["gate"],
                                  params["shared"]["layers"][0]["gate"])


def test_one_adam_step_matches_jax(world):
    """The gradient scale of the shared and the expert parameters, and
    the parameters after one Adam step, rank by rank."""
    n, _, got, want = world
    for r, out in enumerate(got):
        grads = _leaves(_port_tree(out, "lm.g.", want["params"], r))
        stepped = _leaves(_port_tree(out, "lm.p.", want["params"], r))
        jg, js = _leaves(want["grads"]), _leaves(want["stepped"])
        assert grads.keys() == jg.keys()
        for k in jg:
            w_g, w_s = jg[k], js[k]
            if k.startswith("['experts']"):
                w_g, w_s = w_g[r], w_s[r]
            if np.linalg.norm(w_g) > 0:
                assert _rel(grads[k], w_g) <= TOL_GRAD, (r, k,
                                                         _rel(grads[k], w_g))
            firm = np.abs(w_g) > NOISE * np.sqrt(np.mean(w_g ** 2))
            np.testing.assert_allclose(stepped[k][firm], w_s[firm], rtol=0,
                                       atol=TOL_STEP, err_msg=f"{r} {k}")
            assert np.all(np.abs(stepped[k] - w_s) <= 2 * worker.LR + 1e-6)
        assert np.isfinite(out["lm.losses"]).all()
        np.testing.assert_allclose(out["lm.losses"][0], want["loss"],
                                   rtol=2e-3)


def test_exchanges_come_from_the_cache_from_step_two(world):
    n, _, got, _ = world
    layers = worker.LM["num_layers"]
    shared = sum(1 for k in got[0]["lm.names"] if k.startswith("shared."))
    # a layer: 4 exchanges (2 forward, 2 backward), 3 balance allreduces
    # (2 forward, frac_probs' backward); the loss: its mean and backward
    want = layers * (4 + 3) + 2 + shared
    for out in got:
        np.testing.assert_array_equal(out["lm.requested"],
                                      [want] * worker.STEPS)
        np.testing.assert_array_equal(out["lm.hits"][1:],
                                      [want] * (worker.STEPS - 1))
        assert out["lm.hits"][0] < want


@pytest.mark.gpu
def test_moe_across_the_cards(tmp_path):
    """Every card of the machine (four on the chip machine), one rank and
    one expert a card, NCCL data group: the worker's ``cards`` raises on a
    routing that misses the local recomputation or a non-finite loss."""
    size = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if size < 2:
        pytest.skip("needs two CUDA devices or more")
    worker.join(worker.start(tmp_path, size, device="cuda"), tmp_path,
                timeout=600)
