"""One rank of the port's 2-rank gloo world for
tests/test_torch_resnet.py.

Started through ``torch.multiprocessing`` (spawn). Each rank builds the
small bottleneck ResNet (stage sizes (1, 1, 1, 1), 8 filters, 10 classes)
from the flax variables in ``inputs.npz`` (rank 1 moved off them, so that
``broadcast_parameters`` must make them rank 0's), then takes
``STEPS`` ``DistributedOptimizer(SGD(0.01 x size, momentum 0.9))`` steps
through ``make_train_step`` on its half of the batch. It writes its
parameters and running statistics after each step to ``rank<r>.npz``.
"""

import os

import numpy as np
import torch

STEPS = 2


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    torch.set_num_threads(1)  # tiny shapes: more threads only contend
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet
    from horovod_tpu_torch.training import make_train_step

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        model = resnet.ResNet(stage_sizes=(1, 1, 1, 1),
                              block_cls=resnet.BottleneckBlock,
                              num_filters=8, num_classes=10,
                              dtype=torch.float32, device="cpu")
        model.load_state_dict({k[2:]: torch.from_numpy(inp[k] + rank)
                               for k in inp.files if k.startswith("v.")})
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                            momentum=0.9),
            named_parameters=model.named_parameters())
        step = make_train_step(model, opt)
        images = torch.from_numpy(inp["images"][rank])
        labels = torch.from_numpy(inp["labels"][rank])
        out = {}
        for i in range(STEPS):
            step(images, labels)
            out.update({f"step{i}.param.{k}": v.detach().numpy().copy()
                        for k, v in model.named_parameters()})
            out.update({f"step{i}.stat.{k}": v.numpy().copy()
                        for k, v in model.named_buffers()})
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
