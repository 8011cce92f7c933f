"""One rank of the port's 2-rank gloo world for
tests/test_torch_integrity_guard.py.

Started through ``torch.multiprocessing`` (spawn); joins the world through
a ``FileStore``, with ``HOROVOD_INTEGRITY=1`` and a skip budget of
:data:`BUDGET`. Each rank builds the same small MLP and takes
``DistributedOptimizer(SGD(0.05, momentum 0.9))`` steps through
``make_train_step`` on its own seeded batch: :data:`CLEAN` clean steps,
then steps in which a gradient hook on rank 1 alone writes one NaN into
one gradient, until the guard raises. It writes to ``rank<r>.npz`` the
parameters and momentum buffers before and after each poisoned step, the
skipped-steps counter's moves, and the step at which ``NumericalError``
was raised.
"""

import os

import numpy as np
import torch

CLEAN = 3
BUDGET = 2


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store",
                      HOROVOD_INTEGRITY="1",
                      HOROVOD_INTEGRITY_SKIP_STEPS=str(BUDGET))
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import NumericalError
    from horovod_tpu_torch.integrity import guards
    from horovod_tpu_torch.training import make_train_step

    hvd.init(device="cpu")
    try:
        torch.manual_seed(0)
        model = torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                                    torch.nn.Linear(16, 3))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=model.named_parameters())
        step = make_train_step(model, opt)
        rng = np.random.RandomState(10 + rank)
        x = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 3, (4,)))
        for _ in range(CLEAN):
            step(x, y)
        poison = model[0].weight

        def nan_once(g):
            g = g.clone()
            g[0, 0] = float("nan")
            return g

        if rank == 1:
            poison.register_hook(nan_once)
        out, raised_at = {}, -1
        for i in range(BUDGET + 2):
            before = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            mom = {k: opt.state[p]["momentum_buffer"].clone()
                   for k, p in model.named_parameters()}
            skipped0 = guards._SKIPPED.value
            try:
                step(x, y)
            except NumericalError as exc:
                raised_at = i
                out["raised_tensor"] = np.asarray(exc.tensor)
                break
            out[f"moved{i}"] = np.asarray(guards._SKIPPED.value - skipped0)
            out[f"params_equal{i}"] = np.asarray(all(
                torch.equal(before[k], p) for k, p in
                model.named_parameters()))
            out[f"momentum_equal{i}"] = np.asarray(all(
                torch.equal(mom[k], opt.state[p]["momentum_buffer"])
                for k, p in model.named_parameters()))
        out["raised_at"] = np.asarray(raised_at)
        out["param"] = model[2].weight.detach().numpy().copy()
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
