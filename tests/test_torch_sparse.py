"""The port's sparse embedding gradients against the JAX package's
(mirrors tests/test_sparse.py).

At world 1, on the same table, ids and labels (the loss written once for
each framework): ``SparseGrad.densify`` adds duplicates as the JAX one
does; ``with_sparse_embedding_grad``'s value and rows' gradient match the
JAX function's within 1e-6, and its densified gradient autograd's dense
one; ``exchange_sparse_grad`` and ``allreduce_gradients`` give the JAX
package's dense gradient. In a 2-rank gloo world
(tests/torch_sparse_worker.py) the sparse exchange equals the dense
allreduce of the densified gradients (within 1e-6: another order of
addition), with ``sparse_as_dense`` and under accumulation too, and a
``DistributedOptimizer`` fed through ``add_sparse_grad`` trains the table
as the hooks do on the dense gradients.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import sparse as jsparse
import horovod_tpu_torch as hvd
from horovod_tpu_torch.parallel import sparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_hierarchy_worker as hworker  # noqa: E402
import torch_sparse_worker as worker  # noqa: E402

VOCAB, DIM = worker.VOCAB, worker.DIM
TOL = 1e-6


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _inputs(seed=0, n=2):
    rng = np.random.RandomState(seed)
    table = rng.rand(VOCAB, DIM).astype(np.float32)
    ids = rng.randint(0, VOCAB, (n, 4)).astype(np.int64)
    labels = rng.rand(n, 4, DIM).astype(np.float32)
    return table, ids, labels


def _jloss(rows, labels):
    return jnp.mean((rows - labels) ** 2)


def test_densify_scatter_adds_duplicates_as_the_jax_package():
    idx, vals = np.array([1, 1, 3]), np.arange(3 * DIM, dtype=np.float32)
    vals = vals.reshape(3, DIM)
    ours = sparse.SparseGrad(torch.from_numpy(idx), torch.from_numpy(vals),
                             VOCAB).densify()
    theirs = jsparse.SparseGrad(jnp.asarray(idx), jnp.asarray(vals),
                                VOCAB).densify()
    assert ours.shape == (VOCAB, DIM)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert sparse.is_sparse(sparse.SparseGrad(torch.tensor([0]),
                                              torch.ones(1, DIM), VOCAB))
    assert not sparse.is_sparse(torch.ones(2))


@pytest.mark.parametrize("seed,n", [(0, 2), (1, 5)])
def test_with_sparse_embedding_grad_is_the_jax_packages(seed, n):
    table, ids, labels = _inputs(seed, n)
    value, sg = hvd.with_sparse_embedding_grad(worker.loss_fn)(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(labels))
    jvalue, jsg = jsparse.with_sparse_embedding_grad(_jloss)(
        jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(labels))
    np.testing.assert_allclose(float(value), float(jvalue), rtol=TOL)
    np.testing.assert_array_equal(sg.indices.numpy(), np.asarray(jsg.indices))
    np.testing.assert_allclose(sg.values.numpy(), np.asarray(jsg.values),
                               atol=TOL)
    assert sg.num_rows == jsg.num_rows == VOCAB
    # the densified rows' gradient is autograd's dense one
    t = torch.from_numpy(table).requires_grad_(True)
    rows = t[torch.from_numpy(ids).reshape(-1)].reshape(ids.shape + (DIM,))
    worker.loss_fn(rows, torch.from_numpy(labels)).backward()
    np.testing.assert_allclose(sg.densify().numpy(), t.grad.numpy(),
                               atol=TOL)


def test_extra_argnums_differentiate_the_labels_too():
    table, ids, labels = _inputs(2)
    value, (sg, dlab) = hvd.with_sparse_embedding_grad(
        worker.loss_fn, extra_argnums=(1,))(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(labels))
    _, (jsg, jdlab) = jsparse.with_sparse_embedding_grad(
        _jloss, extra_argnums=(1,))(
        jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(labels))
    np.testing.assert_allclose(dlab.numpy(), np.asarray(jdlab), atol=TOL)
    np.testing.assert_allclose(sg.values.numpy(), np.asarray(jsg.values),
                               atol=TOL)
    with pytest.raises(ValueError):
        hvd.with_sparse_embedding_grad(worker.loss_fn, extra_argnums=(0,))


@pytest.mark.parametrize("average", [True, False])
@pytest.mark.parametrize("as_dense", [False, True])
def test_world1_exchange_is_the_jax_packages_dense_gradient(world1, average,
                                                            as_dense):
    table, ids, labels = _inputs(3)
    _, sg = hvd.with_sparse_embedding_grad(worker.loss_fn)(
        torch.from_numpy(table), torch.from_numpy(ids),
        torch.from_numpy(labels))
    _, jsg = jsparse.with_sparse_embedding_grad(_jloss)(
        jnp.asarray(table), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(labels))
    want = np.asarray(jsg.densify())  # world 1: the average is the sum
    got = hvd.allreduce_gradients([sg, torch.ones(3)], average=average,
                                  sparse_as_dense=as_dense)
    np.testing.assert_allclose(got[0].numpy(), want, atol=TOL)
    assert got[1].tolist() == [1.0, 1.0, 1.0]
    ex = sparse.exchange_sparse_grad(sg, average=average)
    np.testing.assert_allclose(ex.numpy(), want, atol=TOL)
    gathered = hvd.sparse_allgather(sg)
    assert torch.equal(gathered.indices, sg.indices)
    assert torch.equal(gathered.values, sg.values)


def test_world1_distributed_optimizer_trains_the_embedding(world1):
    """``add_sparse_grad`` feeds SGD the averaged gradient (COO on the
    sparse path, dense with ``sparse_as_dense``): the sparse path
    tracks the densified one to 1e-6 and the loss falls (the JAX test's
    ``optax.sgd(0.5)`` on zeros, 10 steps)."""
    _, ids, labels = _inputs(4, 16)
    ids, labels = torch.from_numpy(ids), torch.from_numpy(labels)
    results = {}
    for as_dense in (False, True):
        w = torch.nn.Parameter(torch.zeros(VOCAB, DIM))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.5), named_parameters=[("t", w)],
            sparse_as_dense=as_dense)
        losses = []
        for _ in range(10):
            loss, g = hvd.with_sparse_embedding_grad(worker.loss_fn)(
                w, ids, labels)
            opt.add_sparse_grad(w, g)
            opt.step()
            opt.zero_grad()
            losses.append(float(loss))
        results[as_dense] = (w.detach().clone(), losses)
    assert results[False][1][-1] < results[False][1][0]
    torch.testing.assert_close(results[False][0], results[True][0],
                               atol=TOL, rtol=0)
    with pytest.raises(ValueError):
        opt.add_sparse_grad(torch.nn.Parameter(torch.zeros(1)), g)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse2")
    hworker.run_world("exchange", tmp, world=2,
                      script=os.path.join(REPO, "tests",
                                          "torch_sparse_worker.py"))
    return [torch.load(tmp / f"sparse-r{r}.pt", weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize("average", [True, False])
def test_two_ranks_exchange_equals_the_dense_allreduce(two_ranks, average):
    local = [r["local_dense"] for r in two_ranks]
    want = sum(local) / (2 if average else 1)
    for res in two_ranks:
        torch.testing.assert_close(res[f"exchange_{average}"],
                                   res[f"dense_{average}"], atol=TOL, rtol=0)
        torch.testing.assert_close(res[f"exchange_{average}"], want,
                                   atol=TOL, rtol=0)


def test_two_ranks_allreduce_gradients_sparse_and_as_dense(two_ranks):
    want = sum(r["local_dense"] for r in two_ranks) / 2
    for res in two_ranks:
        torch.testing.assert_close(res["ag_sparse"], want, atol=TOL, rtol=0)
        torch.testing.assert_close(res["ag_dense"], want, atol=TOL, rtol=0)
        # fp16 (IEEE float16 values on the wire): within its rounding
        torch.testing.assert_close(res["fp16"], want, atol=2e-3, rtol=2e-3)


def test_two_ranks_sparse_allgather_in_rank_order(two_ranks):
    idx, vals = two_ranks[0]["gathered"]
    nnz = [4 * (3 + r) for r in range(2)]  # each rank's ids
    assert idx.shape == (sum(nnz),) and vals.shape == (sum(nnz), DIM)
    assert torch.equal(idx, two_ranks[1]["gathered"][0])


@pytest.mark.parametrize("mode", ["sparse", "as_dense"])
def test_two_ranks_optimizer_tracks_the_dense_hooks(two_ranks, mode):
    for res in two_ranks:
        tables, losses = res[f"train_{mode}"]
        ref, ref_losses = res["train_hooks"]
        for a, b in zip(tables, ref):
            torch.testing.assert_close(a, b, atol=TOL, rtol=0)
        np.testing.assert_allclose(losses, ref_losses, atol=TOL)
        assert losses[-1] < losses[0]
    torch.testing.assert_close(two_ranks[0][f"train_{mode}"][0][-1],
                               two_ranks[1][f"train_{mode}"][0][-1])


def test_two_ranks_accumulation_densifies_then_steps(two_ranks):
    """Two micro-steps a step: no update after the first, the dense
    path's table after the second."""
    for res in two_ranks:
        tables, _ = res["accum_sparse"]
        ref, _ = res["accum_hooks"]
        assert len(tables) == len(ref) == 6  # 2 steps x (2 passes + step)
        assert float(tables[0].abs().max()) == 0.0  # first micro-step
        assert float(tables[2].abs().max()) > 1e-6
        for a, b in zip(tables, ref):
            torch.testing.assert_close(a, b, atol=TOL, rtol=0)
