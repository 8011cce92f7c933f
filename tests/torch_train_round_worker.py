"""One rank of the port's 2-rank gloo world for
tests/test_torch_train_round.py.

Started through ``torch.multiprocessing`` (spawn); joins the world through
a ``FileStore``, with ``HOROVOD_PROFILE=1``. For each optimizer of
:data:`OPTIMIZERS` each rank builds the small MLP of
``tests/torch_train_step_worker.py`` from the weights in ``inputs.npz``
plus its rank (so rank 1 starts elsewhere), calls ``create_train_state``
(which must make them rank 0's), then takes :data:`ROUNDS` rounds of
``make_train_round(steps=STEPS)`` on its half of the batch. It writes to
``rank<r>.npz`` the parameters after ``create_train_state``
(``<opt>.init.<name>``) and after each round (``<opt>.round<i>.<name>``),
each round's loss, and the profiler records the rounds made.
"""

import os

import numpy as np
import torch

ROUNDS, STEPS = 2, 3
OPTIMIZERS = ("distributed_sgd", "fused_adamw")


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store",
                      HOROVOD_PROFILE="1")
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import (create_train_state,
                                            make_train_round)

    import torch_train_step_worker as base

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    state = {k[2:]: inp[k] + np.float32(rank) for k in inp.files
             if k.startswith("w.")}
    x = torch.from_numpy(inp["x"][rank])
    y = torch.from_numpy(inp["y"][rank])
    hvd.init(device="cpu")
    try:
        out = {}
        for name in OPTIMIZERS:
            model = base.model_from(state)
            opt = base.optimizer(name, model)
            ts = create_train_state(model, opt)
            out[f"{name}.opt_state_type"] = np.asarray(
                type(ts.opt_state).__name__)
            out.update({f"{name}.init.{k}": p.detach().numpy().copy()
                        for k, p in ts.params.items()})
            round_fn = make_train_round(model, opt, steps=STEPS)
            n0 = len(hvd.profiler.history())
            losses = []
            for i in range(ROUNDS):
                losses.append(round_fn(x, y).item())
                out.update({f"{name}.round{i}.{k}":
                            p.detach().numpy().copy()
                            for k, p in model.named_parameters()})
            hvd.profiler.dump()  # closes the last round's record
            recs = hvd.profiler.history()[n0:]
            out[f"{name}.losses"] = np.asarray(losses)
            out[f"{name}.records"] = np.asarray(len(recs))
            out[f"{name}.auto"] = np.asarray([r["auto"] for r in recs])
            out[f"{name}.dispatches"] = np.asarray(
                [r["comm"]["dispatches"] for r in recs])
            out[f"{name}.optimizer_s"] = np.asarray(
                [r["phases"]["optimizer"] for r in recs])
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
