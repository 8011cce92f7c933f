"""The port's ZeRO-1 (``parallel/zero.py``), its collectives and its flat
state converters against the JAX package.

* ``bucket_elems`` and ``build_spec`` equal the JAX package's field by
  field: uneven leaves in three dtype groups at worlds 1, 2 and 3, and
  BERT-Large's 388 shapes (a 536,870,912-element world-1 shard).
* One spawned 2-rank gloo world (``tests/torch_zero_worker.py``) runs every
  scenario: reduce-scatter then allgather is bit-equal to allreduce; 4
  steps of ``sharded_adamw`` match the JAX ``sharded_adamw`` on a 2-device
  mesh fed ``stack_per_worker`` gradients; each rank holds half of each
  padded group; the per-rank states carried to the JAX layout equal the
  JAX state; the leaf-count and world errors.
* Two ZeRO-1 steps of a tiny BERT at world 1 against the JAX
  ``value_and_grad`` + ``sharded_adamw``.

Limits: rtol 2e-6 / atol 1e-7 for float32 (the same float32 operations in
the same order; the bias corrections come from XLA's power on one side and
numpy's on the other); one bfloat16 unit in the last place (rtol 2**-7)
for the bfloat16 leaf, whose float32 master may differ in its last bit
before the cast.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
import torch_zero_worker
from horovod_tpu.models import transformer as jtr
from horovod_tpu.parallel import zero as jzero
from horovod_tpu.runtime import fusion_buffer as jfb
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import (flat_state_from_jax,
                                              flat_state_to_jax,
                                              grads_to_flax, params_from_flax)
from horovod_tpu_torch.parallel import zero as tzero
from horovod_tpu_torch.runtime import fusion_buffer as tfb

RTOL, ATOL = 2e-6, 1e-7
BF16_RTOL = 2.0 ** -7


def test_bucket_elems_matches_jax():
    for nelems in (0, 1, 7, 16384, 16385, 65536, 334090240):
        for itemsize in (1, 2, 4, 8):
            for quantum in (0, 3, 1024, 64 * 1024):
                assert tfb.bucket_elems(nelems, itemsize, quantum) \
                    == jfb.bucket_elems(nelems, itemsize, quantum)


UNEVEN = [((3,), "float32"), ((5, 14), "float32"), ((11,), "float32"),
          ((9,), "bfloat16"), ((4, 4), "int32"), ((), "float32")]


def _specs(shapes_dtypes, world, rank, quantum=64 * 1024):
    jleaves = [jzero.LeafMeta(s, jnp.dtype(d)) for s, d in shapes_dtypes]
    tleaves = [tzero.LeafMeta(s, getattr(torch, d)) for s, d in shapes_dtypes]
    return (jzero.build_spec(jleaves, world, rank, quantum),
            tzero.build_spec(tleaves, world, rank, quantum))


@pytest.mark.parametrize("world", [1, 2, 3])
def test_build_spec_matches_jax_on_uneven_leaves(world):
    for quantum in (64 * 1024, 16):  # 16 bytes: the padding branch too
        jspec, tspec = _specs(UNEVEN, world, world - 1, quantum)
        assert len(tspec.groups) == len(jspec.groups) == 3
        for tg, jg in zip(tspec.groups, jspec.groups):
            for field in tzero.GroupSpec._fields:
                assert getattr(tg, field) == getattr(jg, field), field
        assert (tspec.world, tspec.rank, tspec.num_leaves) \
            == (jspec.world, jspec.rank, jspec.num_leaves)


def test_build_spec_matches_jax_on_bert_large():
    shapes = [tuple(p.shape) for p in ttr.BertLarge(
        vocab_size=30522, max_seq=512, device="meta").parameters()]
    assert len(shapes) == 388
    for world in (1, 2):
        jspec, tspec = _specs([(s, "float32") for s in shapes], world, 0)
        assert tuple(tspec.groups[0]) == tuple(jspec.groups[0])
        assert tspec.groups[0].n == 334_090_240
        assert tspec.groups[0].padded == 536_870_912


def _jax_tree(arrays, dtype_h=jnp.bfloat16):
    return {"a": arrays["a"], "b": arrays["b"], "c": {"w": arrays["c.w"]},
            "h": jnp.asarray(arrays["h"]).astype(dtype_h)}


def test_two_rank_gloo_world_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    shapes = {"a": (3,), "b": (5, 14), "c.w": (11,), "h": (9,)}
    inputs = {"x_float32": rng.randn(2, 6, 5).astype(np.float32),
              "x_int32": rng.randint(-50, 50, (2, 6, 5)).astype(np.int32),
              # odd sums of both signs: -5 averages to -2 by the
              # reference's rule, to -3 by floor division
              "odd_int32": np.asarray([[-3, -2, -1, 0, 1, 2, -4, 3],
                                       [-2, -1, -2, -1, 2, -5, 1, 0]],
                                      np.int32)}
    for k, s in shapes.items():
        inputs[f"p_{k}"] = rng.randn(*s).astype(np.float32)
        for step in range(4):
            inputs[f"g{step}_{k}"] = rng.randn(2, *s).astype(np.float32)
    # the bf16 leaf's values, as bf16, on both sides
    for key in [k for k in inputs if k.endswith("_h")]:
        inputs[key] = np.asarray(jnp.asarray(inputs[key])
                                 .astype(jnp.bfloat16).astype(jnp.float32))
    np.savez(tmp_path / "inputs.npz", **inputs)

    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_zero_worker.run,
                         args=(r, 2, str(tmp_path))) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]

    # reduce-scatter + allgather == allreduce, bit for bit
    for dt in ("float32", "int32"):
        x = inputs[f"x_{dt}"]
        for op in ("sum", "avg"):
            for r, out in enumerate(got):
                ar = out[f"ar_{dt}_{op}"]
                np.testing.assert_array_equal(out[f"rsag_{dt}_{op}"], ar)
                np.testing.assert_array_equal(out[f"rs_{dt}_{op}"],
                                              ar[3 * r:3 * r + 3])
            total = x.sum(0)
            # Average: divide, then cast back to the input's dtype, which
            # truncates integers toward zero (the reference's rule,
            # horovod_tpu/runtime/executor.py:927-949, 1146-1148)
            want = total if op == "sum" else (total / 2).astype(x.dtype)
            np.testing.assert_array_equal(got[0][f"ar_{dt}_{op}"], want)
        for out in got:
            np.testing.assert_array_equal(out[f"rsag_async_{dt}"],
                                          out[f"ar_{dt}_avg"])
    # an integer Average rounds toward zero in allreduce and reducescatter
    odd = inputs["odd_int32"]
    want = (odd.sum(0) / 2).astype(np.int32)
    np.testing.assert_array_equal(want, [-2, -1, -1, 0, 1, -1, -1, 1])
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["ar_odd_avg"], want)
        np.testing.assert_array_equal(out["rs_odd_avg"], want[4 * r:4 * r + 4])
    for out in got:
        assert "must divide evenly" in str(out["err_reducescatter"])
        np.testing.assert_array_equal(  # ragged: 2 rows, then 3
            out["ag_ragged"], np.repeat([0.0, 1.0], [2, 3])[:, None]
            * np.ones((1, 2)))

    # the JAX sharded_adamw on a 2-device mesh, stack_per_worker gradients
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:2], mesh_shape=(1, 2))
    try:
        jopt = jhvd.sharded_adamw(1e-2, weight_decay=1e-3)
        jp = _jax_tree({k: jnp.asarray(inputs[f"p_{k}"]) for k in shapes})
        jstate = jopt.init(jp)
        for step in range(4):
            stacked = {k: jhvd.stack_per_worker(
                [inputs[f"g{step}_{k}"][0], inputs[f"g{step}_{k}"][1]])
                for k in shapes}
            jp, jstate = jopt.apply(jp, jstate, _jax_tree(stacked))
            want = {"a": jp["a"], "b": jp["b"], "c.w": jp["c"]["w"],
                    "h": jp["h"]}
            for out in got:
                for k in shapes:
                    w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
                    rtol, atol = (BF16_RTOL, 0) if k == "h" else (RTOL, ATOL)
                    np.testing.assert_allclose(out[f"step{step}_{k}"], w,
                                               rtol=rtol, atol=atol,
                                               err_msg=f"step {step} {k}")
        jmaster = [np.asarray(m) for m in jstate.master]
        jmu = [np.asarray(m) for m in jstate.mu]
        jnu = [np.asarray(m) for m in jstate.nu]
        jspec, jcount = jstate.spec, int(jstate.count)
    finally:
        jhvd.shutdown()

    # the port's per-rank states, carried to the JAX (W, shard) layout
    leaves = [tzero.LeafMeta(shapes[k], torch.bfloat16 if k == "h"
                             else torch.float32) for k in shapes]
    states = []
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["counts"], [8, 8, 0])
        spec = tzero.build_spec(leaves, 2, r, 64 * 1024)
        for gi, g in enumerate(spec.groups):  # each rank holds one half
            assert g.padded == 2 * g.shard_elems
            np.testing.assert_array_equal(
                out[f"group{gi}"], [g.shard_elems, g.padded, g.shard_elems])
        states.append(tzero.FlatAdamState(
            spec, int(out["count"]),
            *(tuple(torch.from_numpy(out[f"{f}{gi}"])
                    for gi in range(len(spec.groups)))
              for f in ("master", "mu", "nu"))))
        assert str(out["err_leaves"]) == ("gradient tree has 3 leaves but "
                                          "the sharded state was built for 4")
        assert "built for world 1 but the current world is 2" \
            in str(out["err_world"])
    as_jax = flat_state_to_jax(states)
    assert as_jax["count"] == jcount == 4
    for field, want in (("master", jmaster), ("mu", jmu), ("nu", jnu)):
        for a, b in zip(as_jax[field], want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                       err_msg=field)
    # and back: rank r takes row r, bit for bit
    jlike = SimpleNamespace(spec=jspec, **as_jax)
    for r, st in enumerate(states):
        back = flat_state_from_jax(jlike, r, st.spec)
        assert back.spec == st.spec and back.count == st.count
        for f in ("master", "mu", "nu"):
            for a, b in zip(getattr(back, f), getattr(st, f)):
                assert torch.equal(a, b)
    with pytest.raises(ValueError, match="layout differs"):
        flat_state_from_jax(jlike, 0, tzero.build_spec(leaves[:3], 2, 0,
                                                       64 * 1024))


def test_sharded_adamw_rejects_sparse_gradients():
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        opt = hvd.sharded_adamw(1e-3)
        params = {"w": torch.zeros(4, 2)}
        state = opt.init(params)
        sparse = torch.sparse_coo_tensor([[0], [1]], [1.0], (4, 2))
        with pytest.raises(ValueError, match="sparse"):
            opt.apply(params, state, {"w": sparse})
    finally:
        hvd.shutdown()


def test_bert_two_steps_zero1_match_jax():
    """P2 at world 1 on a tiny BERT: the port's forward, backward and
    ``sharded_adamw`` (reduce-scatter, the flat kernel's plain version on
    the CPU, allgather) against the JAX ``value_and_grad`` +
    ``sharded_adamw``, held to the limits of ``test_torch_dp.py``'s AdamW
    steps (parameters 1e-6 abs; the key bias, whose true gradient is 0,
    2 * lr per step)."""
    kw = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=4,
              d_ff=128, max_seq=32)
    jm = jtr.BertBase(dtype=jnp.float32, **kw)
    tokens = np.random.RandomState(0).randint(0, 64, (2, 32)).astype(np.int32)
    pos = jtr.sample_masked_positions(np.random.default_rng(0), 2, 32, 5)
    labels = np.take_along_axis(tokens, pos, axis=1)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[:1], train=False))

    def jloss(p):
        hidden = jm.apply(p, tokens, output="hidden")
        return jtr.masked_lm_loss_gathered(
            hidden, p["params"]["token_embed"]["embedding"], pos, labels)

    tm = ttr.BertBase(dtype=torch.float32, device="cpu", **kw)
    tm.load_state_dict(params_from_flax(params))
    tp = dict(tm.named_parameters())
    toks, tpos, tlab = map(torch.from_numpy, (tokens, pos, labels))

    jhvd.shutdown()
    hvd.shutdown()
    jhvd.init(devices=jax.devices()[:1], mesh_shape=(1, 1))
    hvd.init(device="cpu")
    try:
        jopt = jhvd.sharded_adamw(1e-4)
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        jstate = jopt.init(jparams)
        topt = hvd.sharded_adamw(1e-4)
        tstate = topt.init(tp)
        for step in (1, 2):
            jl, g = jax.value_and_grad(jloss)(jparams)
            jparams, jstate = jopt.apply(jparams, jstate, g)
            tm.zero_grad(set_to_none=True)
            tl = ttr.masked_lm_loss_gathered(tm(toks, output="hidden"),
                                             tm.token_embed, tpos, tlab)
            tl.backward()
            _, tstate = topt.apply(tp, tstate,
                                   {k: p.grad for k, p in tp.items()})
            np.testing.assert_allclose(float(tl.detach()), float(jl),
                                       rtol=1e-5)
            got = dict(jax.tree_util.tree_leaves_with_path(
                grads_to_flax(tp, params)))
            for path, want in jax.tree_util.tree_leaves_with_path(
                    jparams["params"]):
                name = jax.tree_util.keystr(path)
                tol = 2e-4 * step if "['key']['bias']" in name else 1e-6
                np.testing.assert_allclose(got[path], np.asarray(want),
                                           rtol=0, atol=tol, err_msg=name)
        assert tstate.count == 2 and len(tstate.master) == 1
        assert tstate.master[0].numel() == tstate.spec.groups[0].padded
    finally:
        hvd.shutdown()
        jhvd.shutdown()
