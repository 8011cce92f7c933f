"""One rank of the port's 2-rank gloo world for
tests/test_torch_callbacks.py.

Started through ``torch.multiprocessing`` (spawn); joins the world through
a ``FileStore``. Each rank builds a small module from its own seed, runs
``BroadcastGlobalVariablesCallback(root_rank=1).on_train_begin`` on it and
on a dict of tensors, then ``MetricAverageCallback.on_epoch_end`` and
``average_metrics`` on its own metrics, and a
``LearningRateWarmupCallback`` whose size defaults to the world's. It
writes what it holds after each to ``rank<r>.npz``.
"""

import os

import numpy as np
import torch


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks

    hvd.init(device="cpu")
    try:
        torch.manual_seed(rank)
        model = torch.nn.Sequential(torch.nn.Linear(3, 4),
                                    torch.nn.BatchNorm1d(4))
        cb = callbacks.BroadcastGlobalVariablesCallback(root_rank=1)
        assert cb.on_train_begin(model) is model
        tensors = {"w": torch.full((2,), float(rank + 1))}
        cb.on_train_begin(tensors)
        state, avg = callbacks.MetricAverageCallback().on_epoch_end(
            0, "state", {"loss": 1.0 + rank, "acc": torch.tensor(0.5 * rank)})
        assert state == "state"
        fn = callbacks.average_metrics({"n": torch.tensor([rank, 3.0])})
        warm = callbacks.LearningRateWarmupCallback(0.1, warmup_epochs=1,
                                                    steps_per_epoch=2)
        lrs = []
        for b in range(4):
            warm.on_batch_begin(b, None)
            lrs.append(warm.lr)
        out = {f"model.{k}": v.detach().numpy().copy()
               for k, v in model.state_dict().items()}
        out.update({"dict.w": tensors["w"].numpy(),
                    "avg.loss": avg["loss"].numpy(),
                    "avg.acc": avg["acc"].numpy(),
                    "fn.n": fn["n"].numpy(), "lrs": np.asarray(lrs)})
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
