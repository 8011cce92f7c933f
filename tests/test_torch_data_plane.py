"""The port's enqueue runtime in real 2- and 3-rank gloo worlds against the
JAX package (mirrors ``tests/test_data_plane.py``'s five reductions x
f32/bf16/i32 and ``tests/test_runtime.py``'s end-to-end cases).

Each rank (``tests/torch_runtime_worker.py``, spawned) reduces a group of
four tensors per reduction and dtype with one grouped enqueue, which the
runtime fuses into one collective; the oracle is the JAX package's eager
``allreduce`` of the same numpy inputs, stacked per worker, on its CPU
mesh of as many devices. Integers are bit-equal (an integer Average is the
JAX mean cast back, which truncates, as the reference's executor does);
f32 is bit-equal at 2 ranks (a + b, then / 2, is one rounding on both
sides) and, at 3, within 1e-6 of the sum of the ranks' magnitudes (the
order of the additions differs); bf16 within one bf16 ulp of that sum
(Min and Max exact, Product one ulp of the result). The same groups run
again on new runtimes at a 256-byte threshold, which splits each group
into several bins, at pipeline depths 2 and 1: both are held to the same
limits, and the two are bit-equal (the same bins).

The 2-rank world also trains a tiny BERT (2 layers, d 64) 4 steps under
``DistributedOptimizer(AdamW)`` on each rank's own batch; the parameters
after every step match ``optax.adamw`` applied to the mean of the two
batches' JAX gradients, as ``tests/test_torch_dp.py`` holds one rank's.
From the second step on every gradient is answered from the response
cache, every cycle that carried gradients issued one allreduce for all of
them (the fusion: how many cycles a backward spans is the host's speed,
not a guarantee), and after the first step no fusion slab or process
group is created.
Rank 0 writes ``HOROVOD_TIMELINE``: a Chrome trace with both ranks'
announcements and the three fusion activities.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
import torch_runtime_worker as worker
from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models.convert import params_from_flax

SHAPES = ((6, 5), (6, 17), (6, 3), (2, 40))
JOPS = dict(sum=jhvd.Sum, average=jhvd.Average, min=jhvd.Min, max=jhvd.Max,
            product=jhvd.Product)
BF16_ULP = 2.0 ** -7  # bf16 keeps 8 significant bits


def _inputs(size: int, rng) -> dict:
    inp = {}
    for i, shape in enumerate(SHAPES):
        f = rng.normal(size=(size,) + shape).astype(np.float32)
        inp[f"x{i}_float32"] = f
        # bf16 inputs travel as f32 values that bf16 holds exactly
        inp[f"x{i}_bfloat16"] = torch.from_numpy(f).bfloat16().float().numpy()
        inp[f"x{i}_int32"] = rng.randint(-3, 4, (size,) + shape).astype(
            np.int32)
    return inp


def _bert_inputs(rng) -> tuple:
    jm = jtr.BertBase(dtype=jnp.float32, **worker.BERT)
    tokens = rng.randint(0, 64, (2, 2, 32)).astype(np.int32)
    pos = np.stack([jtr.sample_masked_positions(np.random.default_rng(r),
                                                2, 32, 5) for r in range(2)])
    labels = np.take_along_axis(tokens, pos, axis=2)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[0, :1],
                            train=False))
    state = {f"p.{k}": v.numpy() for k, v in params_from_flax(params).items()}
    return jm, params, dict(tokens=tokens, pos=pos, labels=labels, **state)


def _world(tmp_path, size: int, bert: bool) -> list:
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run,
                         args=(r, size, str(tmp_path), bert))
             for r in range(size)]
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
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(size)]


def _jax_reductions(inp: dict, size: int) -> dict:
    want = {}
    jhvd.shutdown()
    jhvd.init(devices=jax.devices()[:size], mesh_shape=(1, size))
    try:
        for dt in worker.DTYPES:
            # the reductions are elementwise: one flat array of the four
            # tensors per rank, one call per op (a compile each)
            flat = np.concatenate([inp[f"x{i}_{dt}"].reshape(size, -1)
                                   for i in range(len(SHAPES))], axis=1)
            parts = [jnp.asarray(flat[r], getattr(jnp, dt))
                     for r in range(size)]
            for op, jop in JOPS.items():
                got = np.asarray(jhvd.allreduce(
                    jhvd.stack_per_worker(parts), op=jop), np.float64)
                if dt == "int32":  # divide and cast back: truncates
                    got = np.trunc(got)
                off = 0
                for i, shape in enumerate(SHAPES):
                    n = int(np.prod(shape))
                    want[f"{dt}_{op}_{i}"] = got[off:off + n].reshape(shape)
                    off += n
    finally:
        jhvd.shutdown()
    return want


def _check_reductions(got: dict, want: dict, inp: dict, size: int,
                      tag: str) -> None:
    for i in range(len(SHAPES)):
        for dt in worker.DTYPES:
            mag = np.abs(inp[f"x{i}_{dt}"].astype(np.float64)).sum(0)
            for op in worker.OPS:
                key = f"{dt}_{op}_{i}"
                ours = got[f"{tag}ar_{key}"].astype(np.float64)
                theirs = want[key]
                if dt == "int32" or op in ("min", "max") or (
                        dt == "float32" and size == 2):
                    np.testing.assert_array_equal(ours, theirs, err_msg=key)
                    continue
                if op == "product":
                    scale = np.abs(theirs)
                else:
                    scale = mag / (size if op == "average" else 1)
                tol = (BF16_ULP if dt == "bfloat16" else 1e-6) * scale
                assert np.all(np.abs(ours - theirs) <= tol), key


@pytest.mark.parametrize("size", [2, 3])
def test_fused_bins_match_jax_reductions(tmp_path, size):
    rng = np.random.RandomState(size)
    inp = _inputs(size, rng)
    bert = size == 2
    if bert:
        jm, params, bert_inp = _bert_inputs(rng)
        inp.update(bert_inp)
    np.savez(tmp_path / "inputs.npz", **inp)
    got = _world(tmp_path, size, bert)
    want = _jax_reductions(inp, size)

    for r, out in enumerate(got):
        for tag in ("", "depth2_", "depth1_"):
            _check_reductions(out, want, inp, size, tag)
        for dt in worker.DTYPES:
            for op in worker.OPS:
                # one grouped enqueue, one fused collective
                assert int(out[f"calls_{dt}_{op}"]) == 1
                assert int(out[f"depth2_calls_{dt}_{op}"]) > 1
                assert out[f"depth1_calls_{dt}_{op}"] == \
                    out[f"depth2_calls_{dt}_{op}"]
                for i in range(len(SHAPES)):
                    np.testing.assert_array_equal(
                        out[f"depth1_ar_{dt}_{op}_{i}"],
                        out[f"depth2_ar_{dt}_{op}_{i}"])
            x = inp[f"x0_{dt}"]
            np.testing.assert_array_equal(out[f"bcast_{dt}"], x[size - 1])
            np.testing.assert_array_equal(
                out[f"ag_{dt}"], np.concatenate(list(inp[f"x1_{dt}"])))
            shard = SHAPES[2][0] // size
            rs = want[f"{dt}_sum_2"][r * shard:(r + 1) * shard]
            if dt == "float32" and size == 2 or dt == "int32":
                np.testing.assert_array_equal(out[f"rs_{dt}"], rs)
            else:
                mag = np.abs(inp[f"x2_{dt}"].astype(np.float64)).sum(0)
                tol = (BF16_ULP if dt == "bfloat16" else 1e-6) * mag
                assert np.all(np.abs(out[f"rs_{dt}"] - rs)
                              <= tol[r * shard:(r + 1) * shard])

    events = json.loads((tmp_path / "timeline.json").read_text())
    names = {e.get("name") for e in events}
    assert {"MEMCPY_IN_FUSION_BUFFER", "GLOO_ALLREDUCE",
            "MEMCPY_OUT_FUSION_BUFFER", "NEGOTIATE_ALLREDUCE"} <= names
    assert {f"RANK_{r}_READY" for r in range(size)} <= names
    if bert:
        _check_bert(jm, params, inp, got)


def _check_bert(jm, params, inp: dict, got: list) -> None:
    """Each step's parameters on both ranks against optax.adamw(1e-4) on
    the mean of the two batches' JAX gradients."""
    def jloss(p, tokens, pos, labels):
        hidden = jm.apply(p, tokens, output="hidden")
        return jtr.masked_lm_loss_gathered(
            hidden, p["params"]["token_embed"]["embedding"], pos, labels)

    jgrad = jax.jit(jax.grad(jloss))

    def grad(p, r):
        return jgrad(p, inp["tokens"][r], inp["pos"][r], inp["labels"][r])
    tx = optax.adamw(1e-4)
    jparams, jstate = params, tx.init(params)
    keys = [k[2:] for k in inp if k.startswith("p.")]
    for step in range(worker.STEPS):
        g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2,
                                   grad(jparams, 0), grad(jparams, 1))
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        want = {k: v.numpy() for k, v in params_from_flax(
            jax.tree_util.tree_map(np.asarray, jparams)).items()}
        for out in got:
            for k in keys:
                # the key bias's true gradient is 0: both sides hold only
                # rounding noise, which AdamW scales to moves of +-lr
                tol = 2e-4 * (step + 1) if "wk.bias" in k or \
                    "key" in k and "bias" in k else 1e-6
                np.testing.assert_allclose(out[f"step{step}.{k}"], want[k],
                                           rtol=0, atol=tol,
                                           err_msg=f"step {step} {k}")
    for out in got:
        np.testing.assert_array_equal(out["bert_cache_hits"][1:], len(keys))
        # one fused call a cycle that carried gradients (a runtime that
        # issued one call a gradient fails wherever a cycle carried two)
        assert all(0 < n <= len(keys) for n in out["bert_allreduce"])
        np.testing.assert_array_equal(out["bert_allreduce"],
                                      out["bert_busy_cycles"])
        assert not out["bert_slabs"][1:].any()
        assert not out["bert_groups"].any()
