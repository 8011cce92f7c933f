#!/usr/bin/env python3
"""What each observability plane costs a training step, in turns on one
card.

    python3 -m horovod_tpu_torch.tools.planes_cost
        [--path hooks|zero|zero2] [--steps 4] [--turns 2] [--cpu]

Trains BERT-Large MLM at full width (seed-0 weights, batch 8 x 512, the
bench's data) on ``--path``: ``hooks`` is ``DistributedOptimizer(AdamW)``
(an allreduce a gradient from its hook, fused by the runtime;
``HOROVOD_FUSION_THRESHOLD=0`` gives one dispatch a tensor, 388), ``zero``
P2 (ZeRO-1 ``sharded_adamw``, one reduce-scatter and one allgather a
group), ``zero2`` P4 (stage 2 through ``make_train_step`` and a
reduce-scatter release plan: 145 groups, 290 dispatches a step). In one
process, after two warm-up steps, each turn runs the configs ``off`` (all
four planes off), one plane alone (``flight``, ``memory``, ``comms``,
``goodput``) and ``all``, the order reversed each turn, ``--steps`` steps
each. A step is read by the host's
clock around ``step().item()`` (which waits for its last kernel), and the
cycle thread's host ms a step and the dispatches a step come from
``runtime.COUNTS``. The planes are switched by their knobs and their
``configure()``, as ``init()`` does; the memory sampler runs at its
default cadence. ``--cpu`` rehearses on the CPU at a tiny size.

It prints one JSON line per config: the median step ms and cycle ms a
step over its runs, the dispatches a step, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

PLANES = {"flight": "HOROVOD_FLIGHT_RECORDER", "memory": "HOROVOD_MEMORY",
          "comms": "HOROVOD_COMMS", "goodput": "HOROVOD_GOODPUT"}
CONFIGS = ("off", "flight", "memory", "comms", "goodput", "all")


def set_planes(config: str, device) -> None:
    from horovod_tpu_torch import comms, flight_recorder, goodput, memory

    for name, knob in PLANES.items():
        os.environ[knob] = "1" if config in ("all", name) else "0"
    flight_recorder.configure()
    memory.configure(device=device)
    comms.configure()
    goodput.configure()


def build(path: str, cpu: bool):
    """The model, its data on the device and the path's step."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import (BertLarge,
                                                      masked_lm_loss_gathered,
                                                      sample_masked_positions)
    from horovod_tpu_torch.training import make_train_step

    cfg = (dict(vocab_size=1000, max_seq=64, num_layers=1, d_model=128,
                num_heads=2, d_ff=256) if cpu
           else dict(vocab_size=30522, max_seq=512))
    batch, seq = (2, 64) if cpu else (8, 512)
    dev = hvd.device()
    model = BertLarge(**cfg, device=dev, seed=0)
    params = dict(model.named_parameters())
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg["vocab_size"], (batch, seq)).astype(np.int32)
    pos = sample_masked_positions(np.random.default_rng(0), batch, seq,
                                  max(1, round(0.15 * seq)))
    labels = np.take_along_axis(tokens, pos, axis=1)
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, pos, labels))

    def loss_of(hidden):
        return masked_lm_loss_gathered(hidden, model.token_embed, pos, lab)

    if path == "hooks":
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4),
            named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss = loss_of(model(toks, output="hidden"))
            loss.backward()
            opt.step()
            return loss.detach()
        return step
    if path == "zero":
        tx = hvd.sharded_adamw(1e-4)
        box = [tx.init(params)]

        def step():
            model.zero_grad(set_to_none=True)
            loss = loss_of(model(toks, output="hidden"))
            loss.backward()
            _, box[0] = tx.apply(params, box[0],
                                 {k: p.grad for k, p in params.items()})
            return loss.detach()
        return step

    plan = hvd.GradReleasePlan(reduce_scatter=True)
    tx = hvd.sharded_adamw(1e-4, partition=plan.zero_partition(params))

    class Hidden(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, t):
            return self.model(t, output="hidden")

    train_step = make_train_step(Hidden(), tx,
                                 loss_fn=lambda hidden, _: loss_of(hidden),
                                 grad_release=plan)
    return lambda: train_step(toks, None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("hooks", "zero", "zero2"),
                    default="zero")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import runtime as hrt
    from horovod_tpu_torch.utils.measure import card_line

    if args.cpu:
        torch.set_num_threads(1)
    hvd.init(device="cpu" if args.cpu else None)
    dev = hvd.device()
    step = build(args.path, args.cpu)
    set_planes("all", dev)
    for _ in range(2):
        step().item()
    runs = {c: [] for c in CONFIGS}
    order = list(CONFIGS)
    for _ in range(args.turns):
        for config in order:
            set_planes(config, dev)
            c0 = dict(hrt.COUNTS)
            times = []
            for _ in range(args.steps):
                t0 = time.perf_counter()
                step().item()
                times.append(1e3 * (time.perf_counter() - t0))
            c1 = hrt.COUNTS
            sent = sum(c1[k] - c0[k] for k in ("allreduce", "reducescatter",
                                                "allgather"))
            runs[config].append((statistics.median(times),
                                 (c1["cycle_ms"] - c0["cycle_ms"])
                                 / args.steps, sent / args.steps))
        order.reverse()
    hvd.shutdown()
    card = "cpu (no device times)" if args.cpu else card_line()
    for config in CONFIGS:
        r = runs[config]
        print(json.dumps({
            "path": args.path, "config": config,
            "step_ms": [round(x[0], 3) for x in r],
            "step_ms_median": round(statistics.median(x[0] for x in r), 3),
            "cycle_ms_a_step": round(statistics.median(x[1] for x in r), 3),
            "dispatches_a_step": statistics.median(x[2] for x in r),
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
