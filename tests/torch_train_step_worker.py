"""One rank of the port's 2-rank gloo world for
tests/test_torch_train_step.py.

Started through ``torch.multiprocessing`` (spawn); joins the world through
a ``FileStore``. Each rank builds the small MLP (6 -> 16 -> 16 -> 3, tanh,
no batch norm) from the weights in ``inputs.npz`` and takes ``STEPS``
steps through ``make_train_step`` on its half of the batch, once with each
optimizer of :data:`OPTIMIZERS`. It writes to ``rank<r>.npz`` the
parameters after each step (``<opt>.step<i>.<name>``), the collectives
requested a step (``<opt>.counts``: allreduce, reducescatter, allgather)
and the response-cache hits a step (``<opt>.hits``).
"""

import os

import numpy as np
import torch

STEPS = 2
LR, WD = 1e-2, 1e-4
#: the optimizers the step is driven with: two that exchange nothing
#: themselves (the step averages for them) and three that do
OPTIMIZERS = ("fused_adamw", "sgd", "distributed_sgd", "sharded_adamw",
              "sharded_update")


def model_from(state: dict) -> torch.nn.Sequential:
    """The MLP with the weights of ``state`` (numpy, keyed as the port's
    state dict)."""
    model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 16), torch.nn.Tanh(),
                                torch.nn.Linear(16, 3))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def optimizer(name: str, model: torch.nn.Module):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fused_adamw import fused_adamw

    if name == "fused_adamw":
        return fused_adamw(LR, weight_decay=WD)
    if name == "sharded_adamw":
        return hvd.sharded_adamw(LR, weight_decay=WD)
    sgd = torch.optim.SGD(model.parameters(), lr=LR)
    if name == "sgd":
        return sgd
    return hvd.DistributedOptimizer(
        sgd, named_parameters=model.named_parameters(),
        shard_optimizer_states=name == "sharded_update")


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    torch.set_num_threads(1)  # tiny shapes: more threads only contend
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.runtime import runtime
    from horovod_tpu_torch.training import make_train_step

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    state = {k[2:]: inp[k] for k in inp.files if k.startswith("w.")}
    x = torch.from_numpy(inp["x"][rank])
    y = torch.from_numpy(inp["y"][rank])
    hvd.init(device="cpu")
    try:
        out = {}
        for name in OPTIMIZERS:
            model = model_from(state)
            step = make_train_step(model, optimizer(name, model))
            counts, hits = [], []
            for i in range(STEPS):
                collectives.reset_counts()
                before = runtime.COUNTS["cache_hits"]
                step(x, y)
                hits.append(runtime.COUNTS["cache_hits"] - before)
                counts.append([collectives.COUNTS[k] for k in
                               ("allreduce", "reducescatter", "allgather")])
                out.update({f"{name}.step{i}.{k}": p.detach().numpy().copy()
                            for k, p in model.named_parameters()})
            out[f"{name}.counts"] = np.asarray(counts)
            out[f"{name}.hits"] = np.asarray(hits)
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
