"""One rank of the port's 2-rank gloo world for tests/test_torch_zero.py.

Started through ``torch.multiprocessing`` (spawn). Reads the shared inputs
from ``inputs.npz``, joins the world through a ``FileStore``, runs every
scenario in one world (to keep the test's time down) and writes what it
got to ``rank<r>.npz``:

* reduce-scatter then allgather against allreduce, sum and average, f32
  and i32, synchronous and async, and the errors for a dim 0 that does not
  divide by the world and for a ragged allgather;
* 4 steps of ``sharded_adamw`` on uneven leaves in two dtype groups, with
  this rank's gradients, and its state's shards;
* the leaf-count and world-mismatch errors of ``apply``.
"""

import os

import numpy as np
import torch

LEAVES = ("a", "b", "c.w", "h")


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        out = {}
        for dt in ("float32", "int32"):
            x = torch.from_numpy(inp[f"x_{dt}"][rank])
            for op_name, op in (("sum", hvd.Sum), ("avg", hvd.Average)):
                shard = hvd.reducescatter(x, op=op)
                out[f"rs_{dt}_{op_name}"] = shard.numpy()
                out[f"rsag_{dt}_{op_name}"] = hvd.allgather(shard).numpy()
                out[f"ar_{dt}_{op_name}"] = hvd.allreduce(x, op=op).numpy()
            h = hvd.reducescatter_async(x)  # op omitted: Average
            out[f"rsag_async_{dt}"] = hvd.synchronize(
                hvd.allgather_async(hvd.synchronize(h))).numpy()
        for fn, arg in ((hvd.reducescatter, torch.zeros(3, 2)),
                        (hvd.allgather, torch.zeros(2 + rank, 2))):
            try:
                fn(arg)
            except ValueError as exc:
                out[f"err_{fn.__name__}"] = np.asarray(str(exc))

        params = {k: torch.from_numpy(inp[f"p_{k}"]) for k in LEAVES}
        params["h"] = params["h"].to(torch.bfloat16)
        opt = hvd.sharded_adamw(1e-2, weight_decay=1e-3)
        state = opt.init(params)
        collectives.reset_counts()
        for step in range(4):
            grads = {k: torch.from_numpy(inp[f"g{step}_{k}"][rank])
                     for k in LEAVES}
            grads["h"] = grads["h"].to(torch.bfloat16)
            got, state = opt.apply(params, state, grads)
            assert got is params
            for k in LEAVES:
                out[f"step{step}_{k}"] = params[k].float().numpy().copy()
        out["counts"] = np.asarray([collectives.COUNTS[k] for k in
                                    ("reducescatter", "allgather",
                                     "allreduce")])
        for gi, g in enumerate(state.spec.groups):
            out[f"group{gi}"] = np.asarray(
                [g.shard_elems, g.padded, state.master[gi].numel()])
            for field in ("master", "mu", "nu"):
                out[f"{field}{gi}"] = getattr(state, field)[gi].numpy()
        out["count"] = np.asarray(state.count)

        short = {k: grads[k] for k in LEAVES[:-1]}
        try:
            opt.apply(params, state, short)
        except ValueError as exc:
            out["err_leaves"] = np.asarray(str(exc))
        try:
            opt.apply(params, state._replace(
                spec=state.spec._replace(world=1)), grads)
        except ValueError as exc:
            out["err_world"] = np.asarray(str(exc))
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
