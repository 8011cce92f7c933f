#!/usr/bin/env python3
"""The ResNet-50 training step with its norm + ReLU pairs in plain PyTorch
and on kernel B10, on one card, in turns.

    python3 -m horovod_tpu_torch.tools.resnet_bn_choice [--turns 2]
        [--steps 10] [--cpu]

``models/resnet.py`` runs each norm that a ReLU follows as
``BatchNormReLU``: flax's ``nn.BatchNorm`` (``x * s + b`` in float32),
then ``F.relu``. Kernel B10 (``ops/conv_bn_act.py``) computes the same
function in one pass. This tool times the step as shipped (``plain``)
against the same model with ``BatchNormReLU.forward`` patched, for the
other runs, to ``FusedBatchNormAct``'s, B10 (``b10``). Both run
``chip_smoke.py``'s ResNet-50 phase: ``hvd.init()``, ``ResNet50`` from seed
0 (bf16, NHWC, batch 128 at 224²), ``DistributedOptimizer(SGD(0.01,
momentum 0.9))`` through the runtime, the same batch every step, 2 warm-up
and ``--steps`` timed steps a run, the runs in turns (b10, plain, plain,
b10, ...). A step is the host's clock around the step and the loss's value
on the host. It prints one JSON line a run (with B10's launches), then the
medians of each variant and the card's name and power limit. ``--cpu``
rehearses it at a tiny size.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.ops import conv_bn_act as cba
from horovod_tpu_torch.training import make_train_step
from horovod_tpu_torch.utils.measure import card_line


def run(variant: str, batch: int, size: int, classes: int, dtype,
        warmup: int, steps: int) -> dict:
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)).to(hvd.device())
    labels = torch.from_numpy(rng.randint(0, classes, (batch,))).to(
        hvd.device())
    model = resnet.ResNet50(num_classes=classes, dtype=dtype, seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    shipped = resnet.BatchNormReLU.forward
    if variant == "b10":
        resnet.BatchNormReLU.forward = cba.FusedBatchNormAct.forward
    cba.reset_launch_counts()
    times, losses = [], []
    try:
        for i in range(warmup + steps):
            t0 = time.perf_counter()
            losses.append(step(images, labels).item())
            if i >= warmup:
                times.append(1e3 * (time.perf_counter() - t0))
    finally:
        resnet.BatchNormReLU.forward = shipped
    return dict(variant=variant, step_ms=statistics.median(times),
                times=times, losses=losses, sba=cba.LAUNCHES["sba"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at a tiny size")
    args = ap.parse_args()
    if args.cpu:
        torch.set_num_threads(1)
        hvd.init(device="cpu")
        shape = dict(batch=2, size=32, classes=10, dtype=torch.float32,
                     warmup=1, steps=args.steps)
    else:
        if not torch.cuda.is_available():
            print("no CUDA device (torch.cuda.is_available() is false)")
            return 1
        hvd.init()
        shape = dict(batch=128, size=224, classes=1000, dtype=torch.bfloat16,
                     warmup=2, steps=args.steps)
    medians = {"b10": [], "plain": []}
    try:
        for turn in range(args.turns):
            order = ("b10", "plain") if turn % 2 == 0 else ("plain", "b10")
            for variant in order:
                res = run(variant, **shape)
                medians[variant].append(res["step_ms"])
                print(json.dumps(res), flush=True)
                if torch.cuda.is_available() and not args.cpu:
                    torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    where = "cpu rehearsal" if args.cpu else card_line()
    print(json.dumps({"step_ms_median": {k: statistics.median(v)
                                         for k, v in medians.items()},
                      "turns": medians, "where": where}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
