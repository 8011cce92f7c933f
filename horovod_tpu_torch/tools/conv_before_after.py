#!/usr/bin/env python3
"""The conv + BN-statistics kernel B11 of two checkouts on one card, in
turns: its time and its wrapper's host time per call.

    python3 horovod_tpu_torch/tools/conv_before_after.py --other <checkout>

runs ``2 * --turns`` processes in the order other, this, this, other, ...
(``fwd_before_after.in_turns``). Each imports the ``horovod_tpu_torch`` of
its checkout and measures, on the probe's own data (``conv_bn_probe.inputs``
of that checkout: ``RandomState(0)``, bf16) at ResNet-50's four 3x3 stages
at batch 128 (:data:`SWEEP`, the probe's sweep; 14 x 14 x 256 is the tool's
shape):

- ``ms``: ``conv3x3_bn_stats`` (B11 and its column sums), cuDNN's conv
  alone and cuDNN's conv plus a statistics pass (yardsticks the port never
  calls), all by THIS checkout's ``utils.measure.time_ms`` (CUDA events
  around a CUDA graph of ``--iters`` calls), so both checkouts are read by
  one method;
- ``host_us``: the wall time of B11's wrapper over ``--calls`` calls
  without a synchronise.

It prints one JSON line per process, then one with each checkout's medians
and the card's name and power limit.
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
#: (image size, channels in and out) at batch :data:`BATCH`: the probe's
#: sweep, written out here so that a worker imports no module of this
#: checkout's package
BATCH = 128
SWEEP = ((56, 64), (28, 128), (14, 256), (7, 512))
this_timer = FWD.this_timer


def worker(checkout: Path, iters: int, calls: int) -> dict:
    """Measure B11 of the ``horovod_tpu_torch`` in ``checkout``."""
    sys.path.insert(0, str(checkout))
    import torch

    from horovod_tpu_torch.tools import conv_bn_probe as probe

    timer = this_timer()
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    ms, host = {}, {}
    for size, c in SWEEP:
        x, xp, w = probe.inputs(BATCH, size, c, c, dev)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def b11():
            return probe.conv3x3_bn_stats(xp, w)

        ms[f"b11_{size}"] = timer.time_ms(b11, iters, dev)
        host[f"b11_{size}"] = FWD.host_us(b11, calls)
        ms[f"conv_{size}"] = timer.time_ms(lambda: probe.conv_only(xc, wc),
                                           iters, dev)
        ms[f"conv_stats_{size}"] = timer.time_ms(
            lambda: probe.conv_then_stats(xc, wc), iters, dev)
    return {"checkout": str(checkout), "package": probe.__file__, "ms": ms,
            "host_us": host}


def main() -> int:
    args = FWD.parse_args(__doc__.split("\n")[0])
    if args.worker:
        print(json.dumps(worker(args.worker.resolve(), args.iters,
                                args.calls)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("conv_before_after needs a CUDA device", file=sys.stderr)
        return 1
    return FWD.in_turns(Path(__file__).resolve(), args.other, args.turns,
                        ["--iters", str(args.iters),
                         "--calls", str(args.calls)])


if __name__ == "__main__":
    sys.exit(main())
