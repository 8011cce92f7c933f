#!/usr/bin/env python3
"""The attention backward of two checkouts on one card, in turns: the time
of the dq, dk/dv and fused (B7) kernels and their wrappers' host time per
call.

    python3 horovod_tpu_torch/tools/bwd_before_after.py --other <checkout>

runs ``2 * --turns`` processes in the order other, this, this, other, ...
(``fwd_before_after.in_turns``). Each imports the ``horovod_tpu_torch`` of
its checkout and measures, on the same inputs (``torch.randn`` from seed 0,
bf16; lse from that checkout's forward, delta by ``compute_delta``), at the
forward tool's shapes (a) B8 H16 S512 D64, (b) B16 H12 S1024 D64 causal and
(c) B1 H4 S2048 D128 causal:

- ``ms``: ``flash_bwd_dq``, ``flash_bwd_dkv``, the two back to back (one
  backward), the fused backward ``flash_bwd_fused`` (B7) at the shapes
  within ``FUSED_MAX_SEQ`` ((a) and (b): :data:`FUSED`), and aten's flash
  attention backward (dq, dk and dv in one call, a yardstick the port
  never calls), all by THIS checkout's
  ``utils.measure.time_ms`` (CUDA events around a CUDA graph of
  ``--iters`` calls), so both checkouts are read by one method;
- ``host_us``: the wall time of each wrapper, and of the two back to back,
  over ``--calls`` calls without a synchronise: what a backward costs a
  host-bound step.

It prints one JSON line per process, then one with each checkout's
medians and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path


def _forward_tool():
    """This checkout's ``fwd_before_after``, loaded by path (it imports no
    package at its top), so that a worker imports the other checkout's
    ``horovod_tpu_torch`` and nothing else of it."""
    spec = importlib.util.spec_from_file_location(
        "fwd_before_after_by_path",
        Path(__file__).resolve().with_name("fwd_before_after.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


FWD = _forward_tool()
SHAPES = FWD.SHAPES
#: the shapes B7 is timed at: those the backward sends it (Sq, Sk <= 1024)
FUSED = ("a", "b")
this_timer = FWD.this_timer


def worker(checkout: Path, iters: int, calls: int) -> dict:
    """Measure the backward of the ``horovod_tpu_torch`` in ``checkout``."""
    sys.path.insert(0, str(checkout))
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    timer = this_timer()
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    aten = torch.ops.aten
    ms, host = {}, {}
    for name, (b, h, s, d, causal) in SHAPES.items():
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        kw = dict(causal=causal, sm_scale=d ** -0.5, q_offset=0, k_offset=0)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        args = (q, k, v, do, lse, fa.compute_delta(o, do))
        out = aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, causal, False, scale=kw["sm_scale"])

        def dq():
            return fa.flash_bwd_dq(*args, **kw)

        def dkv():
            return fa.flash_bwd_dkv(*args, **kw)

        def pair():
            return dq(), dkv()

        def fused():
            return fa.flash_bwd_fused(*args, **kw)

        calls_of = {f"dq_{name}": dq, f"dkv_{name}": dkv,
                    f"pair_{name}": pair}
        if name in FUSED:
            calls_of[f"fused_{name}"] = fused
        for key, fn in calls_of.items():
            ms[key] = timer.time_ms(fn, iters, dev)
            host[key] = FWD.host_us(fn, calls)
        ms[f"aten_{name}"] = timer.time_ms(
            lambda: aten._scaled_dot_product_flash_attention_backward(
                do, q, k, v, out[0], out[1], out[2], out[3], out[4], out[5],
                0.0, causal, out[6], out[7], scale=kw["sm_scale"]),
            iters, dev)
    return {"checkout": str(checkout), "package": fa.__file__, "ms": ms,
            "host_us": host}


def main() -> int:
    args = FWD.parse_args(__doc__.split("\n")[0])
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.iters,
                                args.calls)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bwd_before_after needs a CUDA device", file=sys.stderr)
        return 1
    return FWD.in_turns(Path(__file__).resolve(), args.other, args.turns,
                        ["--iters", str(args.iters),
                         "--calls", str(args.calls)])


if __name__ == "__main__":
    sys.exit(main())
