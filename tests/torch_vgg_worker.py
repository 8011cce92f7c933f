"""One rank of the port's 2-rank gloo world for
tests/test_torch_vgg_mnist.py.

Each rank builds a VGG11 at 32 x 32 (10 classes, float32, seed 0) on the
CPU, sets ``HOROVOD_FUSION_THRESHOLD`` to one byte below ``fc1``'s
gradient, and runs one backward of its own seeded batch under
``DistributedOptimizer(SGD)``. It writes to ``rank<r>.npz`` its local
``fc1`` gradient, the averaged one, the threshold and the fusion bins the
runtime issued (each a comma-joined list of tensor names).
"""

import os

import numpy as np
import torch

SIZE, BATCH, CLASSES = 32, 2, 10


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.vgg import VGG11
    from horovod_tpu_torch.runtime import fusion

    model = VGG11(num_classes=CLASSES, dtype=torch.float32, image_size=SIZE,
                  device="cpu", seed=0)
    threshold = model.fc1.kernel.numel() * 4 - 1
    os.environ["HOROVOD_FUSION_THRESHOLD"] = str(threshold)
    bins = []
    real = fusion.fuse_responses

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        bins.extend(",".join(r.tensor_names) for r in out)
        return out

    fusion.fuse_responses = recorded
    hvd.init(device="cpu")
    try:
        rng = np.random.RandomState(rank)
        x = torch.from_numpy(rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3))
                             .astype(np.float32))
        y = torch.from_numpy(rng.randint(0, CLASSES, (BATCH,)))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9),
            named_parameters=model.named_parameters())
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        local = model.fc1.kernel.grad.detach().clone()
        opt.synchronize()
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"),
                 local_fc1=local.numpy(),
                 avg_fc1=model.fc1.kernel.grad.detach().numpy(),
                 threshold=threshold, bins=np.array(bins))
    finally:
        fusion.fuse_responses = real
        hvd.shutdown()


def spawn(tmpdir, size: int = 2) -> list:
    """Run the world in spawned processes; the ranks' outputs."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, size, str(tmpdir)))
             for r in range(size)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return [dict(np.load(os.path.join(str(tmpdir), f"rank{r}.npz")))
            for r in range(size)]
