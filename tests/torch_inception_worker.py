"""One rank of the port's 2-rank gloo world for the Inception tests in
tests/test_torch_inception.py, and the small net they share.

Started through ``torch.multiprocessing`` (spawn). Each rank trains the
small net (a stem ``ConvBN``, one ``InceptionA``, the classifier) on its
half of one batch, read from ``inputs.npz``: one
``DistributedOptimizer(SGD)`` step after ``broadcast_parameters``. It
writes its running statistics, its averaged gradients and its parameters
after the step to ``rank<r>.npz``.
"""

import os

import numpy as np
import torch

from horovod_tpu_torch.models import inception as tinc

F32 = torch.float32
LR, MOMENTUM = 0.1, 0.9


class SmallNet(torch.nn.Module):
    """Stem ``ConvBN`` (3x3/2 VALID, 32), ``InceptionA(32, pool 32)``, the
    mean over pixels and a 10-class ``Dense``; float32 on the CPU."""

    def __init__(self, seed: int):
        super().__init__()
        self.stem = tinc.ConvBN(3, 32, (3, 3), (2, 2), "VALID", dtype=F32,
                                device="cpu")
        self.block = tinc.InceptionA(32, 32, dtype=F32, device="cpu")
        self.head = tinc.Dense(self.block.out_features, 10, F32, "cpu")
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (tinc.Conv, tinc.Dense)):
                    tinc._variance_scaling_(m.kernel, 1.0,
                                            m.kernel[0].numel(), gen)

    def forward(self, images):
        x = self.block(self.stem(images.permute(0, 3, 1, 2)))
        return self.head(x.mean(dim=(2, 3)))


def grads(model) -> dict:
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.training import default_loss_fn

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        model = SmallNet(seed=rank)  # rank 1's weights differ until the
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)  # bcast
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM),
            named_parameters=model.named_parameters())
        images = torch.from_numpy(inp["images"][rank])
        labels = torch.from_numpy(inp["labels"][rank])
        default_loss_fn(model(images), labels).backward()
        opt.synchronize()
        out = {f"grad/{k}": v for k, v in grads(model).items()}
        with opt.skip_synchronize():
            opt.step()
        out.update({f"param/{k}": v.detach().numpy().copy()
                    for k, v in model.named_parameters()})
        out.update({f"stat/{k}": v.numpy().copy()
                    for k, v in model.named_buffers()})
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
