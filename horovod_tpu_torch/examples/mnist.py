"""PyTorch MNIST on the port (port of ``examples/torch_mnist.py``;
reference: examples/pytorch_mnist.py): the training script is ordinary
PyTorch; the framework gives init, the scaled learning rate, the
hook-driven ``DistributedOptimizer`` and the rank-0 broadcasts. The data is
synthetic (seeded), so nothing is downloaded.

    python -m horovod_tpu_torch.examples.mnist [--epochs 1] [--device cpu]
"""

import argparse
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.view(-1, 320)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.01)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    device = hvd.device()
    torch.manual_seed(42)

    model = Net().to(device)
    # scale LR by world size; wrap with the hook-driven optimizer
    optimizer = torch.optim.SGD(model.parameters(),
                                lr=args.lr * hvd.size(), momentum=0.5)
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters())

    # broadcast initial parameters + optimizer state from rank 0
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

    rng = np.random.RandomState(1234)
    images = torch.tensor(rng.rand(1024, 1, 28, 28), dtype=torch.float32)
    labels = torch.tensor(rng.randint(0, 10, (1024,)), dtype=torch.long)

    # Shard the dataset by rank, the reference's input convention
    # (reference: examples/pytorch_mnist.py DistributedSampler with
    # num_replicas=hvd.size(), rank=hvd.rank()): one data-parallel worker
    # per launched process.
    multiproc = os.environ.get("HOROVOD_RANK") is not None
    data_world = hvd.size() if multiproc else 1
    data_rank = hvd.rank() if multiproc else 0
    dataset = torch.utils.data.TensorDataset(images, labels)
    sampler = torch.utils.data.distributed.DistributedSampler(
        dataset, num_replicas=data_world, rank=data_rank)
    loader = torch.utils.data.DataLoader(
        dataset, batch_size=args.batch_size, sampler=sampler)

    for epoch in range(args.epochs):
        model.train()
        sampler.set_epoch(epoch)
        losses = []
        for xb, yb in loader:
            xb, yb = xb.to(device), yb.to(device)
            optimizer.zero_grad()
            output = model(xb)
            loss = F.nll_loss(output, yb)
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {np.mean(losses):.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
