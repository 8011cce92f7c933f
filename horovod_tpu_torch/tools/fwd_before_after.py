#!/usr/bin/env python3
"""The attention forward of two checkouts on one card, in turns: the time
of each forward kernel and its wrapper's host time per call.

    python3 horovod_tpu_torch/tools/fwd_before_after.py --other <checkout>

runs ``2 * --turns`` processes in the order other, this, this, other, ...
Each imports the ``horovod_tpu_torch`` of its checkout and measures, on the
same inputs (``torch.randn`` from seed 0, bf16):

- ``ms``: ``flash_fwd`` at (a) B8 H16 S512 D64, (b) B16 H12 S1024 D64
  causal and (c) B1 H4 S2048 D128 causal, the three probes (B12-B14) at
  (a), and ``scaled_dot_product_attention``'s forward at each shape, all
  by THIS checkout's ``utils.measure.time_ms`` (CUDA events around a CUDA
  graph of ``--iters`` calls), so both checkouts are read by one method;
- ``host_us``: each forward wrapper's wall time over ``--calls`` calls
  without a synchronise: what it costs a host-bound step.

It prints one JSON line per process, then one with each checkout's
medians and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout's root
SHAPES = {"a": (8, 16, 512, 64, False), "b": (16, 12, 1024, 64, True),
          "c": (1, 4, 2048, 128, True)}


def this_timer():
    """This checkout's ``utils.measure``, loaded by path, so that a worker
    that imports another checkout's package times it the same way."""
    spec = importlib.util.spec_from_file_location(
        "fwd_timer", HERE / "horovod_tpu_torch" / "utils" / "measure.py")
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    return timer


def host_us(fn, calls: int) -> float:
    """Microseconds of host time per call of ``fn`` (no synchronise
    inside the loop; the device drains before and after)."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / calls


def worker(checkout: Path, iters: int, calls: int) -> dict:
    """Measure the forward of the ``horovod_tpu_torch`` in ``checkout``."""
    sys.path.insert(0, str(checkout))
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.tools import flash_vpu_probe as vprobe

    timer = this_timer()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms, host = {}, {}
    for name, (b, h, s, d, causal) in SHAPES.items():
        q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        sm = d ** -0.5
        calls_of = {f"flash_fwd_{name}": lambda: fa.flash_fwd(
            q, k, v, causal=causal, sm_scale=sm, q_offset=0, k_offset=0)}
        if name == "a":
            q2, k2, v2 = vprobe.pack(q, k, v)
            calls_of.update(
                simple1=lambda: vprobe.simple1_fwd(q, k, v, sm, False),
                simple1_lse=lambda: vprobe.simple1_fwd(q, k, v, sm, True),
                pack2=lambda: vprobe.pack2_fwd(q2, k2, v2, sm))
        for key, fn in calls_of.items():
            ms[key] = timer.time_ms(fn, iters, dev)
            host[key] = host_us(fn, calls)
        ms[f"sdpa_{name}"] = timer.time_ms(
            lambda: sdpa(q, k, v, is_causal=causal, scale=sm), iters, dev)
    return {"checkout": str(checkout), "package": fa.__file__, "ms": ms,
            "host_us": host}


def in_turns(script: Path, other: Path, turns: int, args: list) -> int:
    """Run ``script --worker <checkout> *args`` in ``2 * turns`` processes,
    other, this, this, other, ..., print each one's JSON line, then each
    checkout's medians beside the card's name and power limit."""
    pair = (other.resolve(), HERE)
    rows = []
    for turn in range(turns):
        for checkout in (pair if turn % 2 == 0 else pair[::-1]):
            out = subprocess.run(
                [sys.executable, str(script), "--worker", str(checkout),
                 *args], capture_output=True, text=True)
            if out.returncode:
                print(out.stderr[-4000:], file=sys.stderr)
                return out.returncode
            rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    medians = {}
    for checkout in pair:
        mine = [r for r in rows if r["checkout"] == str(checkout)]
        medians[str(checkout)] = {
            what: {key: statistics.median(r[what][key] for r in mine)
                   for key in mine[0][what]}
            for what in ("ms", "host_us")}
    print(json.dumps({"medians": medians, "args": args,
                      "card": this_timer().card_line()}), flush=True)
    return 0


def parse_args(description: str) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--other", type=Path,
                    help="the checkout to compare with this one")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not args.worker and args.other is None:
        ap.error("--other is required")
    return args


def main() -> int:
    args = parse_args(__doc__.split("\n")[0])
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.iters,
                                args.calls)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fwd_before_after needs a CUDA device", file=sys.stderr)
        return 1
    return in_turns(Path(__file__).resolve(), args.other, args.turns,
                    ["--iters", str(args.iters), "--calls", str(args.calls)])


if __name__ == "__main__":
    sys.exit(main())
