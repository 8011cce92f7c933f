"""One rank of the port's 2-rank sparse-gradient world for
tests/test_torch_sparse.py.

    python tests/torch_sparse_worker.py exchange <tmpdir>

Each rank takes its own ids and labels (``RandomState(10 + rank)``) over
one table and saves to ``sparse-r<rank>.pt``:

* the ``SparseGrad`` of ``with_sparse_embedding_grad`` exchanged by
  ``exchange_sparse_grad`` (Average and Sum), by ``allreduce_gradients``
  (sparse and ``sparse_as_dense``), and the densified gradient by the dense
  allreduce; the same rows under ``Compression.fp16``; ``sparse_allgather``;
* the table after 4 ``DistributedOptimizer(SGD(0.5))`` steps through
  ``add_sparse_grad``, with and without ``sparse_as_dense``, and the same
  steps on the densified gradients through the hooks;
* with ``backward_passes_per_step=2``: the table after each of two
  micro-steps, against the dense path's.
"""

import os
import sys

import numpy as np
import torch

VOCAB, DIM = 32, 8


def batch(rng, n):
    ids = torch.from_numpy(rng.randint(0, VOCAB, (n, 4)).astype(np.int64))
    labels = torch.from_numpy(rng.rand(n, 4, DIM).astype(np.float32))
    return ids, labels


def loss_fn(rows, labels):
    return ((rows - labels) ** 2).mean()


def exchange(hvd, rank: int, tmp: str) -> None:
    table = torch.from_numpy(
        np.random.RandomState(0).rand(VOCAB, DIM).astype(np.float32))
    rng = np.random.RandomState(10 + rank)
    ids, labels = batch(rng, 3 + rank)  # the ranks touch different nnz
    out = {}
    _, sg = hvd.with_sparse_embedding_grad(loss_fn)(table, ids, labels)
    out["local_dense"] = sg.densify()
    for average in (True, False):
        out[f"exchange_{average}"] = hvd.parallel.sparse.exchange_sparse_grad(
            sg, average=average, name=f"ex.{average}")
        out[f"dense_{average}"] = hvd.allreduce(
            sg.densify(), op=hvd.Average if average else hvd.Sum,
            name=f"dense.{average}")
    out["ag_sparse"] = hvd.allreduce_gradients({"t": sg}, name="ag1")["t"]
    out["ag_dense"] = hvd.allreduce_gradients({"t": sg}, name="ag2",
                                              sparse_as_dense=True)["t"]
    out["fp16"] = hvd.parallel.sparse.exchange_sparse_grad(
        sg, average=True, compression=hvd.Compression.fp16, name="ex.fp16")
    gathered = hvd.sparse_allgather(sg, name="gather")
    out["gathered"] = (gathered.indices, gathered.values)

    def train(mode, steps=4, passes=1):
        w = torch.nn.Parameter(torch.zeros(VOCAB, DIM))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.5), named_parameters=[(mode, w)],
            sparse_as_dense=mode == "as_dense",
            backward_passes_per_step=passes)
        trng = np.random.RandomState(20 + rank)
        tables, losses = [], []
        for _ in range(steps):
            for _ in range(passes):
                ids, labels = batch(trng, 4)
                if mode == "hooks":  # the dense gradient through autograd
                    rows = w[ids.reshape(-1)].reshape(ids.shape + (DIM,))
                    loss = loss_fn(rows, labels)
                    loss.backward()
                else:
                    loss, g = hvd.with_sparse_embedding_grad(loss_fn)(
                        w, ids, labels)
                    opt.add_sparse_grad(w, g)
                losses.append(float(loss))
                if passes > 1:
                    tables.append(w.detach().clone())
            opt.step()
            opt.zero_grad()
            tables.append(w.detach().clone())
        return tables, losses

    for mode in ("sparse", "as_dense", "hooks"):
        out[f"train_{mode}"] = train(mode)
    for mode in ("sparse", "hooks"):
        out[f"accum_{mode}"] = train(mode, steps=2, passes=2)
    torch.save(out, os.path.join(tmp, f"sparse-r{rank}.pt"))


def main() -> int:
    mode, tmp = sys.argv[1], sys.argv[2]
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        dict(exchange=exchange)[mode](hvd, hvd.rank(), tmp)
    finally:
        hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
