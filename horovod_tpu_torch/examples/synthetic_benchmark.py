"""PyTorch synthetic benchmark on the port (port of
``examples/torch_synthetic_benchmark.py``; reference:
examples/pytorch_synthetic_benchmark.py:37-110), with the same measurement
protocol: warm-up batches, then timed rounds, img/sec with a 95% band.

    python -m horovod_tpu_torch.examples.synthetic_benchmark [--fp16-allreduce]

The model and data live on ``hvd.device()`` (the card unless ``--device
cpu``); each timed round ends in a wait for the device, so a rate counts
the device's work and not only its queueing.
"""

import argparse
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch as hvd


class SmallConvNet(nn.Module):
    """Compact stand-in for torchvision resnet50."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 32, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, stride=2, padding=1)
        self.fc = nn.Linear(64, num_classes)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        x = F.adaptive_avg_pool2d(x, 1).flatten(1)
        return self.fc(x)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--num-warmup-batches", type=int, default=3)
    parser.add_argument("--num-batches-per-iter", type=int, default=3)
    parser.add_argument("--num-iters", type=int, default=3)
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--fp16-allreduce", action="store_true")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    device = hvd.device()
    model = SmallConvNet().to(device)
    compression = (hvd.Compression.fp16 if args.fp16_allreduce
                   else hvd.Compression.none)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size())
    optimizer = hvd.DistributedOptimizer(
        optimizer, named_parameters=model.named_parameters(),
        compression=compression)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    data = torch.randn(args.batch_size, 3, args.image_size, args.image_size,
                       device=device)
    target = torch.randint(0, 1000, (args.batch_size,), device=device)

    def benchmark_step():
        optimizer.zero_grad()
        loss = F.cross_entropy(model(data), target)
        loss.backward()
        optimizer.step()

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if hvd.rank() == 0:
        print(f"Batch size: {args.batch_size}, workers: {hvd.size()}")
    for _ in range(args.num_warmup_batches):
        benchmark_step()
    wait()

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.time()
        for _ in range(args.num_batches_per_iter):
            benchmark_step()
        wait()
        dt = time.time() - t0
        rate = args.batch_size * args.num_batches_per_iter * hvd.size() / dt
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec total")

    if hvd.rank() == 0:
        mean, conf = np.mean(img_secs), 1.96 * np.std(img_secs)
        print(f"Img/sec total: {mean:.1f} +- {conf:.1f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
