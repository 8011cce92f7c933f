"""Sparse (embedding) gradient exchange: allgather instead of allreduce
(port of ``horovod_tpu/parallel/sparse.py``; reference:
horovod/tensorflow/__init__.py:64-75, ``tf.IndexedSlices`` gradients go
out as allgather(values) + allgather(indices); ``sparse_as_dense``
densifies first, :200-203).

A :class:`SparseGrad` holds the touched row ids of an embedding table and
their gradient rows. For a table of V rows of which a step touches n << V,
exchanging n x d values a rank beats allreducing V x d. The exchange is
exact: the dense gradient is ``index_add_(zeros, ids, rows)``, and a
scatter-add commutes with concatenation, so densify(allgather(sparse)) ==
allreduce(densify(sparse)) up to the order of the additions.

    value_and_grad = hvd.with_sparse_embedding_grad(
        lambda rows, labels: loss(rows, labels))
    loss, table_grad = value_and_grad(table, ids, labels)
    dense = hvd.allreduce_gradients({"table": table_grad})["table"]

``allreduce_gradients`` (``parallel/dp.py``) takes ``SparseGrad`` leaves
and hands back a dense average; ``DistributedOptimizer.add_sparse_grad``
takes one as a parameter's sparse gradient. Both go out as a COO tensor
by the binding's sparse allreduce (``ops/collectives.py``
``sparse_allreduce_async``): two named allgathers through the runtime
(``<name>.indices``, ``<name>.values``), ragged when the ranks touch
different numbers of rows.
"""

from __future__ import annotations

from typing import Any

import torch

from horovod_tpu_torch.compression import Compression


class SparseGrad:
    """Gradient of an embedding table concentrated on ``indices``.

    ``indices``: (nnz,) int64 row ids (duplicates add). ``values``: (nnz,
    ...) gradient rows, one an index. ``num_rows``: the dense table's
    leading dimension."""

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 num_rows: int):
        self.indices = indices
        self.values = values
        self.num_rows = int(num_rows)

    def densify(self) -> torch.Tensor:
        """Scatter-add to the dense gradient (``index_add_``)."""
        dense = self.values.new_zeros((self.num_rows,)
                                      + tuple(self.values.shape[1:]))
        return dense.index_add_(0, self.indices.long(), self.values)

    def to_coo(self) -> torch.Tensor:
        """The same gradient as a sparse COO tensor (duplicates add on
        ``coalesce``): what the sparse allreduce and the optimizer's
        sparse path take."""
        return torch.sparse_coo_tensor(
            self.indices.long()[None], self.values,
            (self.num_rows,) + tuple(self.values.shape[1:]))

    def __repr__(self):
        return (f"SparseGrad(nnz={self.indices.shape[0]}, "
                f"num_rows={self.num_rows}, "
                f"values={tuple(self.values.shape)})")


def is_sparse(x: Any) -> bool:
    return isinstance(x, SparseGrad)


def densify_leaf(sg: SparseGrad) -> torch.Tensor:
    """The dense gradient of a ``SparseGrad`` (the JAX package's name; the
    port has no worker-stacked form)."""
    return sg.densify()


def with_sparse_embedding_grad(apply_fn, extra_argnums=()):
    """A value-and-grad function whose embedding-table gradient is a
    :class:`SparseGrad`.

    ``apply_fn(rows, *args)`` computes the scalar loss from the gathered
    rows (``ids.shape + (d,)``). The returned function is ``(table, ids,
    *args) -> (value, SparseGrad)``: ``rows = table[ids]`` is made a leaf
    of its own, so the backward never forms the dense V x d gradient. Only
    the rows are differentiated unless ``extra_argnums`` names more of
    ``apply_fn``'s arguments; then it returns ``(value, (SparseGrad,
    *extra_grads))``."""
    extra_argnums = tuple(extra_argnums)
    if 0 in extra_argnums:
        raise ValueError("argnum 0 (the rows) is always differentiated")

    def value_and_grads(table, ids, *args):
        flat_ids = ids.reshape(-1)
        rows = table.detach()[flat_ids].reshape(
            tuple(ids.shape) + tuple(table.shape[1:])).requires_grad_(True)
        args = list(args)
        extras = []
        for k in extra_argnums:
            args[k - 1] = args[k - 1].detach().requires_grad_(True)
            extras.append(args[k - 1])
        with torch.enable_grad():
            value = apply_fn(rows, *args)
            grads = torch.autograd.grad(value, [rows] + extras)
        d_rows = grads[0].reshape((flat_ids.shape[0],)
                                  + tuple(table.shape[1:]))
        sparse = SparseGrad(flat_ids, d_rows, table.shape[0])
        if extra_argnums:
            return value.detach(), (sparse,) + tuple(grads[1:])
        return value.detach(), sparse

    return value_and_grads


def sparse_allgather(sg: SparseGrad, name: str = None) -> SparseGrad:
    """Concatenate every rank's ``SparseGrad`` in rank order: the
    reference's allgather(values) + allgather(indices), ragged when the
    ranks' nnz differ."""
    from horovod_tpu_torch.ops import collectives

    name = name or "sparse_allgather"
    h_idx = collectives.allgather_async(sg.indices.contiguous(),
                                        name=f"{name}.indices")
    h_vals = collectives.allgather_async(sg.values.contiguous(),
                                         name=f"{name}.values")
    return SparseGrad(collectives.synchronize(h_idx),
                      collectives.synchronize(h_vals), sg.num_rows)


def exchange_sparse_grad(sg: SparseGrad, *, average: bool,
                         compression=Compression.none,
                         name: str = None) -> torch.Tensor:
    """Exchange one ``SparseGrad`` across the ranks and return the dense
    averaged (or summed) gradient for the optimizer: its COO form through
    ``collectives.sparse_allreduce_async``, values compressed. Wire bytes
    O(nnz x world x d), not O(V x d)."""
    from horovod_tpu_torch.ops import collectives

    return collectives.sparse_allreduce_async(
        sg.to_coo(), average=average, name=name,
        compression=compression).wait().to_dense()
