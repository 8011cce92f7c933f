"""One rank of the port's 2-rank gloo world for tests/test_torch_dp.py.

Started through ``torch.multiprocessing`` (spawn). Reads the shared inputs
from ``inputs.npz``, joins the world through a ``FileStore``, runs the
collectives and one ``DistributedOptimizer`` step, and writes what it got
to ``rank<r>.npz``.
"""

import os

import numpy as np
import torch


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        out = {}
        g = torch.from_numpy(inp["grads"][rank])
        out["mean"] = hvd.allreduce(g, average=True).numpy()
        out["sum_fp16"] = hvd.allreduce(
            g, op=hvd.Sum, compression=hvd.Compression.fp16).numpy()
        h = hvd.allreduce_async(g, op=hvd.Max)
        out["max"] = hvd.synchronize(h).numpy()
        out["g_untouched"] = g.numpy()
        inplace = g.clone()
        h = hvd.allreduce_async_(inplace, average=True)
        while not hvd.poll(h):
            pass
        assert hvd.synchronize(h) is inplace
        out["mean_inplace"] = inplace.numpy()
        out["grouped"] = hvd.allreduce_gradients(
            {"a": g, "b": 2 * g})["b"].numpy()
        out["bcast"] = hvd.broadcast_(torch.full((3,), float(rank)),
                                      root_rank=1).numpy()

        # rank 1 starts from other weights; the broadcast makes them rank 0's
        w = torch.nn.Parameter(torch.from_numpy(inp["params"] + rank))
        hvd.broadcast_parameters([("w", w)], root_rank=0)
        out["w_init"] = w.detach().numpy().copy()
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW([w], lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=1e-4),
            named_parameters=[("w", w)])
        # loss whose gradient is exactly this rank's numpy gradient
        (w * torch.from_numpy(inp["grads"][rank])).sum().backward()
        opt.step()
        out["w_step"] = w.detach().numpy().copy()

        # a diverged rank 1 state is overwritten by rank 0's
        if rank == 1:
            opt.state[w]["exp_avg"].add_(1.0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        out["exp_avg"] = opt.state[w]["exp_avg"].numpy().copy()
        out["step"] = np.asarray(float(opt.state[w]["step"]))
        out["counts"] = np.asarray([hvd.size(), hvd.rank()])
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
