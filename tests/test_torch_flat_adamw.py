"""The flat ZeRO AdamW (kernel B8's wrapper, ``ops/fused_optimizer.py``)
on the CPU, where it runs its plain version: the contract the kernel
keeps on the card.

* For a float32 group the new parameters are ``master`` itself (no copy,
  no ``p`` stream on the card), and over 3 steps they, mu and nu match the
  JAX package's ``flat_adamw_shard`` run through its Pallas kernel in
  interpret mode within 2e-6 relative and 1e-7 absolute (the limits of
  ``tests/test_torch_optimizer.py``), not bit for bit: XLA's CPU code for
  the interpreted kernel contracts multiplies and adds into fused ones,
  while the plain version (and the kernel on the card, bit-equal to it)
  rounds after every operation. Measured: 2.3 % of the parameters differ,
  by at most one float32 unit (4.8e-7 at |w| ~ 4), a tenth of the
  limit.
* For a bfloat16 group ``p`` is a tensor of its own, and ``master`` keeps
  the float32 values ``p`` rounds.
* ``sharded_adamw`` at world 1: stage 3 (``ShardedParams``) over 3 steps
  is bit-equal to stage 1 (dense parameters); a float32 group's shard in
  the returned ``ShardedParams`` is the optimizer's master, and the
  user's shards given to ``init`` are left as they were.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.ops.pallas import fused_optimizer as jfused_opt

RTOL, ATOL = 2e-6, 1e-7
from horovod_tpu_torch.ops import fused_adamw as tfa
from horovod_tpu_torch.ops import fused_optimizer as tfo


def _shard(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return (rng.randn(n).astype(np.float32),
            (1e-2 * rng.randn(n)).astype(np.float32),
            (1e-4 * rng.rand(n)).astype(np.float32),
            rng.randn(n).astype(np.float32))


@pytest.mark.parametrize("n", [16384 * 2, 16384 * 5])
def test_float32_group_returns_master_and_matches_jax(monkeypatch, n):
    monkeypatch.setenv("HOROVOD_SHARDED_FUSED_KERNEL", "1")
    monkeypatch.setenv("HOROVOD_PALLAS_INTERPRET", "1")
    master, mu, nu, grad = _shard(n, 11)
    tw, tm, tv = (torch.from_numpy(a.copy()) for a in (master, mu, nu))
    jw, jm, jv = (jnp.asarray(a) for a in (master, mu, nu))
    for step in (1, 2, 3):
        sc = tfa.adamw_scalars(step, 0.9, 0.999, 1e-2, 1e-3)
        want = jfused_opt.flat_adamw_shard(
            jw, jm, jv, jnp.asarray(grad), jnp.asarray(sc), eps=1e-8,
            out_dtype=jnp.float32)
        got = tfo.flat_adamw_shard(tw, tm, tv, torch.from_numpy(grad), sc,
                                   eps=1e-8, out_dtype=torch.float32)
        assert got[0] is tw and got[1] is tw and got[2] is tm \
            and got[3] is tv
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                       atol=ATOL)
        _, jw, jm, jv = want


def test_bfloat16_group_returns_a_tensor_of_its_own():
    master, mu, nu, grad = _shard(1000, 12)
    tw, tm, tv = (torch.from_numpy(a.copy()) for a in (master, mu, nu))
    g = torch.from_numpy(grad).to(torch.bfloat16)
    sc = tfa.adamw_scalars(1, 0.9, 0.999, 1e-2, 1e-3)
    p, w, m, v = tfo.flat_adamw_shard(tw, tm, tv, g, sc, eps=1e-8,
                                      out_dtype=torch.bfloat16)
    assert w is tw and m is tm and v is tv
    assert p.dtype == torch.bfloat16 and p.data_ptr() != tw.data_ptr()
    assert torch.equal(p, tw.to(torch.bfloat16))
    want = tfo.flat_adamw_reference(*(torch.from_numpy(a) for a in
                                      (master, mu, nu)), g, sc, 1e-8,
                                    torch.bfloat16)
    for a, b in zip((p, w, m, v), want):
        assert torch.equal(a, b)


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_stage3_is_bit_equal_to_stage1_and_holds_the_master(world1):
    rng = np.random.RandomState(13)
    shapes = {"a": (33, 7), "b": (5,), "c": (300,), "h": (64,)}
    base = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in shapes.items()}
    base["h"] = base["h"].to(torch.bfloat16)
    dense = {k: t.clone() for k, t in base.items()}
    opt = hvd.sharded_adamw(1e-2, weight_decay=1e-3)
    s1 = opt.init(dense)
    sp = hvd.shard_params({k: t.clone() for k, t in base.items()})
    given = [t.clone() for t in sp.shards]
    s3 = opt.init(sp)
    for step in range(3):
        grads = {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
                 .to(base[k].dtype) for k, s in shapes.items()}
        _, s1 = opt.apply(dense, s1, grads)
        sg = hvd.scatter_gradients(grads, spec=s3.spec)
        new_sp, s3 = opt.apply(sp, s3, sg)
        if step == 0:  # init copied them: the first shards are untouched
            for a, b in zip(sp.shards, given):
                assert torch.equal(a, b)
        sp = new_sp
        full = hvd.gather_params(sp)
        for k in shapes:
            assert torch.equal(full[k], dense[k]), (step, k)
        for g, shard, master in zip(s3.spec.groups, sp.shards, s3.master):
            f32 = g.dtype == "float32"
            assert (shard.data_ptr() == master.data_ptr()) == f32
