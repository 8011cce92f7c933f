"""The port's public collective surface in real 2- and 3-rank gloo worlds
(mirrors ``tests/test_torch.py``, the JAX package's test of its PyTorch
binding).

The JAX binding runs one process over an 8-device mesh, so its workers all
hold the same values; here each rank (``tests/torch_binding_worker.py``,
spawned) holds values of its own, and each result is held against what
the JAX binding's rules give on them, computed here:

* the dtype x op matrix over the JAX test's nine dtypes (64-bit payloads
  past 2**40): allreduce (Sum, Average, Min, Max), allgather, broadcast
  (out of place and in place), reduce-scatter (Sum, Min), alltoall; exact
  (an Average divides the exact sum in the dtype, an integer one toward
  zero); uint16, uint32 and uint64 refused with a ``TypeError`` naming the
  dtype, before anything is enqueued;
* a ragged allgather (a rank with no rows too), alltoall and its
  indivisible dim 0;
* the gradients of allreduce (grad = the allreduce of the gradient with
  the same op), allgather (this rank's rows of the summed gradient) and
  broadcast (the summed gradient on the root, zero elsewhere), as
  ``horovod_tpu/torch/mpi_ops.py:358-425`` has them;
* the sparse allreduce against the dense one, and ``DistributedOptimizer``
  on a sparse ``nn.Embedding`` by the sparse path and by
  ``sparse_as_dense``; ``backward_passes_per_step=2``;
* ``broadcast_object``, int64 at 2**40 through allreduce, allgather and
  broadcast, and the capability probes.

One world a size runs every case once (about 5 s); each test reads its
part.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_binding_worker as worker


@pytest.fixture(scope="module", params=[2, 3], ids=["2ranks", "3ranks"])
def world(request, tmp_path_factory):
    size = request.param
    tmp = tmp_path_factory.mktemp(f"binding{size}")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker.run, args=(r, size, str(tmp)))
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
    return size, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(size)]


def _t(dt: str, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a)).to(getattr(torch, dt))


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.double() if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dt", worker.DTYPES)
def test_dtype_matrix(world, dt):
    size, got = world
    xs = [worker.matrix_input(dt, r, size) for r in range(size)]
    exact = sum(x.double() if x.is_floating_point() else x for x in xs)
    total = exact.to(xs[0].dtype)  # every sum is exact in the dtype
    if xs[0].is_floating_point():
        average = total / size
    else:
        average = torch.div(total, size, rounding_mode="trunc")
    for r, out in enumerate(got):
        shard = slice(2 * r, 2 * r + 2)
        want = {"ar_{}_sum": total, "ar_{}_average": average,
                "ar_{}_min": xs[0], "ar_{}_max": xs[-1],
                "ag_{}": torch.cat(xs), "bc_{}": xs[-1], "bc__{}": xs[0],
                "rs_{}_sum": total[shard], "rs_{}_min": xs[0][shard],
                "a2a_{}": torch.cat([x[shard] for x in xs])}
        for key, w in want.items():
            np.testing.assert_array_equal(out[key.format(dt)], _np(w),
                                          err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("dt", worker.REFUSED)
def test_unsigned_wide_types_are_refused_before_enqueue(world, dt):
    size, got = world
    for out in got:
        for name in ("allreduce", "allreduce_async_", "allgather",
                     "broadcast", "reducescatter", "alltoall"):
            msg = str(out[f"refused_{dt}_{name}"])
            assert msg.startswith("TypeError") and f"torch.{dt}" in msg, \
                (name, msg)
        assert int(out[f"refused_{dt}_issued"]) == 0


def test_int64_payloads_past_32_bits_stay_exact(world):
    size, got = world
    xs = [np.array([worker.BIG + r, -worker.BIG - 3], np.int64)
          for r in range(size)]
    for out in got:
        assert out["big_ar"].dtype == np.int64
        np.testing.assert_array_equal(out["big_ar"], sum(xs))
        np.testing.assert_array_equal(out["big_ag"], np.concatenate(xs))
        np.testing.assert_array_equal(out["big_bc"], xs[-1])


def test_ragged_allgather(world):
    """Rank r gives r + 1 rows (and 2r rows, none on rank 0): every rank
    gets them all, in rank order."""
    size, got = world
    for out in got:
        for dt, off in (("float32", 0), ("int64", worker.BIG)):
            want = np.concatenate([np.full((r + 1, 3), r + 1 + off)
                                   for r in range(size)])
            np.testing.assert_array_equal(out[f"ragged_{dt}"], want)
        want = np.concatenate([np.full((2 * r, 2), float(r))
                               for r in range(size)])
        np.testing.assert_array_equal(out["ragged_empty"], want)


def test_alltoall(world):
    size, got = world
    xs = [np.arange(size * 6).reshape(size * 2, 3) + 100 * r
          for r in range(size)]
    for r, out in enumerate(got):
        np.testing.assert_array_equal(
            out["a2a"], np.concatenate([x[2 * r:2 * r + 2] for x in xs]))


def test_alltoall_indivisible_raises(world):
    """The JAX binding's ValueError and message."""
    size, got = world
    for out in got:
        assert str(out["a2a_indivisible"]) == (
            f"ValueError: alltoall dim 0 ({size + 1}) must divide evenly "
            f"by size ({size})")


def test_allreduce_grad(world):
    """grad(allreduce) = allreduce(grad) with the same op."""
    size, got = world
    ws = [worker.grad_weights(r, (5,)).numpy() for r in range(size)]
    for out in got:
        np.testing.assert_allclose(out["grad_ar_average"],
                                   sum(ws) / size, rtol=1e-6)
        np.testing.assert_allclose(out["grad_ar_sum"], sum(ws), rtol=1e-6)


def test_allgather_grad(world):
    """grad(allgather) = this rank's rows of the sum-allreduce of the
    gradient (ragged: rank r has r + 1 rows)."""
    size, got = world
    total = sum(range(1, size + 1))
    summed = sum(worker.grad_weights(r, (total, 2)).numpy()
                 for r in range(size))
    for r, out in enumerate(got):
        off = sum(range(1, r + 1))
        np.testing.assert_allclose(out["grad_ag"],
                                   summed[off:off + r + 1], rtol=1e-6)
        np.testing.assert_array_equal(out["grad_ag_unnamed"],
                                      np.full(3, 2.0 * size))


def test_broadcast_grad(world):
    """grad(broadcast) = the summed gradient on the root, zero elsewhere."""
    size, got = world
    summed = sum(worker.grad_weights(r, (4,)).numpy() for r in range(size))
    for r, out in enumerate(got):
        np.testing.assert_array_equal(out["grad_bc_value"], np.ones(4))
        want = summed if r == 1 else np.zeros(4)
        np.testing.assert_allclose(out["grad_bc"], want, rtol=1e-6)


def test_sparse_allreduce_equals_the_dense_one(world):
    size, got = world
    dense = [worker.sparse_input(r).to_dense().numpy() for r in range(size)]
    for out in got:
        np.testing.assert_allclose(out["sparse"], out["sparse_dense"],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["sparse"], sum(dense) / size,
                                   rtol=1e-6)
        np.testing.assert_array_equal(out["sparse_sum"], sum(dense))


def test_sparse_gradients_by_the_sparse_path_and_as_dense(world):
    """``nn.Embedding(sparse=True)`` under ``DistributedOptimizer(SGD)``:
    two steps by the sparse allreduce and two with ``sparse_as_dense``
    both give the SGD steps on the ranks' mean gradient (rank r's loss
    weighs its rows by r + 1); the sparse path keeps the gradient sparse."""
    size, got = world
    counts = np.zeros((size, 10))
    for r in range(size):
        np.add.at(counts[r], worker.embedding_ids(r).numpy().ravel(), r + 1)
    grad = counts.mean(0)[:, None] * np.ones((1, 4))
    for out in got:
        for mode in ("sparse", "dense"):
            init = got[0][f"emb_{mode}_init"]
            np.testing.assert_array_equal(out[f"emb_{mode}_init"], init)
            np.testing.assert_allclose(out[f"emb_{mode}"],
                                       init - 2 * 0.5 * grad, rtol=1e-6,
                                       atol=1e-6)
        assert bool(out["emb_sparse_grad_sparse"])
        assert not bool(out["emb_dense_grad_sparse"])


def test_backward_passes_per_step_accumulates(world):
    """``backward_passes_per_step=2``: no allreduce after the first
    backward, one a parameter after the second; the step applies the mean
    over the ranks of each rank's accumulated gradient."""
    size, got = world
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(got[0]["bpps_init_w"]))
        lin.bias.copy_(torch.from_numpy(got[0]["bpps_init_b"]))
    for r in range(size):
        for k in range(2):
            lin(worker.bpps_input(r, k)).square().sum().backward()
    w = lin.weight.detach() - 0.1 * lin.weight.grad / size
    b = lin.bias.detach() - 0.1 * lin.bias.grad / size
    for out in got:
        assert int(out["bpps_handles_0"]) == 0
        assert int(out["bpps_handles_1"]) == 2
        np.testing.assert_allclose(out["bpps_w"], w.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(out["bpps_b"], b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_broadcast_object(world):
    size, got = world
    want = repr(sorted({"epoch": size - 1, "tag": f"r{size - 1}"}.items()))
    for out in got:
        assert str(out["object"]) == want


def test_capability_probes(world):
    """The JAX binding's probes, with the values true of the port."""
    _, got = world
    want = dict(is_homogeneous=True, mpi_built=False, gloo_built=True,
                nccl_built=dist.is_nccl_available(), xla_built=False,
                mpi_enabled=False, mpi_threads_supported=False)
    for out in got:
        for probe, value in want.items():
            assert bool(out[f"probe_{probe}"]) is value, probe
