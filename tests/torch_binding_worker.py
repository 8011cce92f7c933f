"""One rank of the port's 2- and 3-rank gloo worlds for
tests/test_torch_binding.py.

Started through ``torch.multiprocessing`` (spawn). Each rank drives the
public surface of ``horovod_tpu_torch`` on values of its own (the inputs
are made from the rank, so the test computes what every rank holds) and
writes what it got to ``rank<r>.npz``; an exception an op is expected to
raise is written as its type and message. See the test for what each key
is held against.
"""

import os

import numpy as np
import torch

DTYPES = ("uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
          "float32", "float64")
REFUSED = ("uint16", "uint32", "uint64")
BIG = 1 << 40  # beyond 32 bits: a narrowing anywhere shows


def matrix_input(dtype: str, rank: int, size: int) -> torch.Tensor:
    """Position-dependent values (chunk order shows), a rank offset, and
    ``BIG`` on the 64-bit types."""
    big = BIG if dtype in ("int64", "float64") else 0
    x = torch.arange(size * 2 * 3, dtype=torch.int64).reshape(size * 2, 3)
    return (x % 7 + 1 + rank + big).to(getattr(torch, dtype))


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.is_sparse:
        t = t.to_dense()
    return (t.double() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _error(fn, *args, **kw) -> np.ndarray:
    try:
        fn(*args, **kw)
    except Exception as exc:  # the test reads the type and the message
        return np.asarray(f"{type(exc).__name__}: {exc}")
    return np.asarray("no error")


def _matrix(hvd, rank, size, out) -> None:
    ops = dict(sum=hvd.Sum, average=hvd.Average, min=hvd.Min, max=hvd.Max)
    for dt in DTYPES:
        x = matrix_input(dt, rank, size)
        for op, code in ops.items():
            got = hvd.allreduce(x, op=code, name=f"m.{dt}.{op}")
            assert got.dtype == x.dtype
            out[f"ar_{dt}_{op}"] = _np(got)
        got = hvd.allgather(x, name=f"m.{dt}.ag")
        out[f"ag_{dt}"] = _np(got)
        got = hvd.broadcast(x, root_rank=size - 1, name=f"m.{dt}.bc")
        out[f"bc_{dt}"] = _np(got)
        for op in ("sum", "min"):
            got = hvd.reducescatter(x, op=ops[op], name=f"m.{dt}.rs.{op}")
            out[f"rs_{dt}_{op}"] = _np(got)
        got = hvd.alltoall(x, name=f"m.{dt}.a2a")
        assert got.dtype == x.dtype
        out[f"a2a_{dt}"] = _np(got)
        y = x.clone()
        hvd.broadcast_(y, root_rank=0, name=f"m.{dt}.bc_")
        out[f"bc__{dt}"] = _np(y)


def _refused(hvd, runtime, out) -> None:
    for dt in REFUSED:
        x = torch.ones(6, dtype=getattr(torch, dt))  # divides by 2 and 3
        before = dict(runtime.COUNTS)
        for name, fn in (("allreduce", hvd.allreduce),
                         ("allreduce_async_", hvd.allreduce_async_),
                         ("allgather", hvd.allgather),
                         ("broadcast", lambda t: hvd.broadcast(t, 0)),
                         ("reducescatter", hvd.reducescatter),
                         ("alltoall", hvd.alltoall)):
            out[f"refused_{dt}_{name}"] = _error(fn, x)
        out[f"refused_{dt}_issued"] = np.asarray(
            runtime.COUNTS["responses"] - before["responses"])


def _ragged(hvd, rank, out) -> None:
    for dt in ("float32", "int64"):
        x = torch.full((rank + 1, 3), rank + 1, dtype=getattr(torch, dt))
        if dt == "int64":
            x += BIG
        out[f"ragged_{dt}"] = _np(hvd.allgather(x, name=f"ragged.{dt}"))
    # rank 0 gives no rows at all
    x = torch.full((2 * rank, 2), float(rank))
    out["ragged_empty"] = _np(hvd.synchronize(
        hvd.allgather_async(x, name="ragged.empty")))


def _alltoall(hvd, rank, size, out) -> None:
    x = torch.arange(size * 2 * 3).reshape(size * 2, 3) + 100 * rank
    out["a2a"] = _np(hvd.synchronize(hvd.alltoall_async(x)))
    out["a2a_indivisible"] = _error(hvd.alltoall, torch.ones(size + 1, 2))


def grad_weights(rank: int, shape) -> torch.Tensor:
    """Each rank's upstream weights of a gradient case."""
    n = int(np.prod(shape))
    return (torch.arange(n, dtype=torch.float64).reshape(shape) * 0.5
            + rank + 1).float()


def _grads(hvd, rank, size, out) -> None:
    for op, code in (("average", hvd.Average), ("sum", hvd.Sum)):
        x = torch.full((5,), float(rank), requires_grad=True)
        y = hvd.allreduce(x, op=code, name=f"grad.ar.{op}")
        (y * grad_weights(rank, (5,))).sum().backward()
        out[f"grad_ar_{op}"] = _np(x.grad)
    x = torch.full((rank + 1, 2), float(rank), requires_grad=True)
    y = hvd.allgather(x, name="grad.ag")
    (y * grad_weights(rank, tuple(y.shape))).sum().backward()
    out["grad_ag"] = _np(x.grad)
    x = torch.full((4,), float(rank), requires_grad=True)
    y = hvd.broadcast(x, root_rank=1, name="grad.bc")
    out["grad_bc_value"] = _np(y)
    (y * grad_weights(rank, (4,))).sum().backward()
    out["grad_bc"] = _np(x.grad)
    x = torch.full((3,), float(rank), requires_grad=True)  # unnamed ops
    (hvd.allgather(x) * 2).sum().backward()
    out["grad_ag_unnamed"] = _np(x.grad)


def sparse_input(rank: int) -> torch.Tensor:
    """A (6, 2) COO tensor with a duplicate index, overlapping the other
    ranks' rows."""
    idx = torch.tensor([[rank, rank + 1, rank + 1, 5], [0, 1, 1, 0]])
    vals = torch.tensor([1.0, 2.0, 3.0, 4.0]) * (rank + 1)
    return torch.sparse_coo_tensor(idx, vals, (6, 2), check_invariants=True)


def _sparse(hvd, rank, out) -> None:
    t = sparse_input(rank)
    got = hvd.synchronize(hvd.sparse_allreduce_async(t, name="sparse"))
    assert got.is_sparse
    out["sparse"] = _np(got)
    out["sparse_dense"] = _np(hvd.allreduce(t.to_dense(), name="dense"))
    out["sparse_sum"] = _np(hvd.sparse_allreduce_async(
        t, average=False).wait())


def embedding_ids(rank: int) -> torch.Tensor:
    return torch.tensor([[rank, 3, 3], [7, rank + 2, 0]])


def _optimizers(hvd, rank, out) -> None:
    for mode in ("sparse", "dense"):
        torch.manual_seed(rank)  # the broadcast makes them rank 0's
        emb = torch.nn.Embedding(10, 4, sparse=True)
        hvd.broadcast_parameters(emb.state_dict(), root_rank=0)
        out[f"emb_{mode}_init"] = _np(emb.weight)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(emb.parameters(), lr=0.5),
            named_parameters=[(f"emb.{mode}", emb.weight)],
            sparse_as_dense=mode == "dense")
        for _ in range(2):
            opt.zero_grad()
            (emb(embedding_ids(rank)) * (rank + 1)).sum().backward()
            opt.step()
        out[f"emb_{mode}"] = _np(emb.weight)
        out[f"emb_{mode}_grad_sparse"] = np.asarray(emb.weight.grad.is_sparse)

    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    out["bpps_init_w"], out["bpps_init_b"] = _np(lin.weight), _np(lin.bias)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(lin.parameters(), lr=0.1),
        named_parameters=lin.named_parameters(), backward_passes_per_step=2)
    for k in range(2):
        lin(bpps_input(rank, k)).square().sum().backward()
        out[f"bpps_handles_{k}"] = np.asarray(len(opt._handles))
    opt.step()
    out["bpps_w"], out["bpps_b"] = _np(lin.weight), _np(lin.bias)


def bpps_input(rank: int, k: int) -> torch.Tensor:
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) / 3 + rank + k


def _misc(hvd, rank, size, out) -> None:
    obj = hvd.broadcast_object({"epoch": rank, "tag": f"r{rank}"},
                               root_rank=size - 1)
    out["object"] = np.asarray(repr(sorted(obj.items())))
    for probe in ("is_homogeneous", "mpi_built", "gloo_built", "nccl_built",
                  "xla_built", "mpi_enabled", "mpi_threads_supported"):
        out[f"probe_{probe}"] = np.asarray(getattr(hvd, probe)())
    x = torch.tensor([BIG + rank, -BIG - 3], dtype=torch.int64)
    out["big_ar"] = _np(hvd.allreduce(x, op=hvd.Sum))
    out["big_ag"] = _np(hvd.allgather(x))
    out["big_bc"] = _np(hvd.broadcast(x, root_rank=size - 1))


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    torch.set_num_threads(1)  # tiny shapes: more threads only contend
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import runtime

    hvd.init(device="cpu")
    try:
        out = {}
        _matrix(hvd, rank, size, out)
        _refused(hvd, runtime, out)
        _ragged(hvd, rank, out)
        _alltoall(hvd, rank, size, out)
        _grads(hvd, rank, size, out)
        _sparse(hvd, rank, out)
        _optimizers(hvd, rank, out)
        _misc(hvd, rank, size, out)
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
