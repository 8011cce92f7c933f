#!/usr/bin/env python3
"""The hooks step of two checkouts, and of this one's runtime at other
settings, on one card, in turns, with a breakdown of the step.

    python3 horovod_tpu_torch/tools/runtime_before_after.py \\
        --other <checkout> [--configs fused,t0] [--models bert,gpt2]

Each run is a process of its own that imports the ``horovod_tpu_torch`` of
its checkout and trains a model under ``DistributedOptimizer`` as
``chip_smoke.py`` does (seed-0 weights, the bench's data): ``bert``,
BERT-Large MLM at full width (batch 8 x 512, AdamW, its phase 4);
``inception``, Inception-V3 (batch 32 x 299², bf16, SGD, phase 6);
``gpt2``, GPT-2-small (batch 16 x 1024, AdamW, phase 7); ``--layers``
cuts BERT's or GPT-2's depth. Each takes 2 warm-up and ``--steps`` timed
steps. Each step starts on an idle card and is read in four parts by the
host's clock: the forward and loss, the backward (hooks included),
``synchronize()`` (the wait for the gradients' collectives) and the
optimizer step up to the loss's value on the host.
The configs are ``other`` (the other checkout's hooks path), ``fused`` (this
checkout's runtime at its defaults: the native cycle engine), ``py``
(``HOROVOD_NATIVE_CYCLE=0``: the Python cache, bin-packer and trace
writer), ``t0`` (``HOROVOD_FUSION_THRESHOLD=0``) and ``cycleN``
(``HOROVOD_CYCLE_TIME=N`` ms); every turn runs them all, the order
reversed each turn. Beside the medians it reports the collectives the
optimizer requested a step and, for this checkout, the runtime's allreduce
calls, cycles and cycle host ms a step (``runtime.COUNTS``).
``--profile-cycle`` adds to each run the cycle thread's profile over the
timed steps (``tools/cycle_profile.py``: the 15 functions with the most
cumulative ms a step); its sampler costs the step some time, so time and
profile in separate calls.

It prints one JSON line per run, then one with each model and config's
medians and the card's name and power limit. The module imports no
package at its top, so a worker imports only its own checkout's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
PARTS = ("step_ms", "fwd_ms", "bwd_ms", "sync_ms", "opt_ms")


def config_env(config: str) -> dict:
    if config in ("other", "fused"):
        return {}
    if config == "py":
        return {"HOROVOD_NATIVE_CYCLE": "0"}
    if config == "t0":
        return {"HOROVOD_FUSION_THRESHOLD": "0"}
    if config.startswith("cycle"):
        return {"HOROVOD_CYCLE_TIME": config[len("cycle"):]}
    raise ValueError(f"unknown config {config!r}")


def _model(name: str, layers: int, dev, cpu: bool):
    """The model, its optimizer and a ``loss()`` closure over the bench's
    data, as ``chip_smoke.py`` phases 4, 6 and 7 build them (small shapes
    for a CPU rehearsal)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models import transformer as tr

    depth = {} if layers is None else {"num_layers": layers}
    if name == "inception":
        from horovod_tpu_torch.models.inception import InceptionV3
        from horovod_tpu_torch.training import default_loss_fn

        batch, size, classes = (2, 75, 10) if cpu else (32, 299, 1000)
        rng = np.random.RandomState(0)  # bench.py:306-312
        x = torch.from_numpy(rng.uniform(-1, 1, (batch, size, size, 3))
                             .astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.randint(0, classes, (batch,))).to(dev)
        model = InceptionV3(num_classes=classes, device=dev, seed=0,
                            dtype=torch.float32 if cpu else torch.bfloat16)
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        return model, opt, lambda: default_loss_fn(model(x), y)
    if name == "gpt2":
        batch, seq = (2, 64) if cpu else (16, 1024)
        t = torch.from_numpy(np.random.RandomState(0).randint(
            0, 50257, (batch, seq)).astype(np.int32)).to(dev)
        model = tr.GPT2Small(vocab_size=50257, max_seq=seq, device=dev,
                             seed=0, **depth)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        return model, opt, lambda: tr.causal_lm_loss(model(t), t)
    (batch, seq), vocab = (2, 64) if cpu else (8, 512), 30522
    rng = np.random.RandomState(0)  # chip_smoke.mlm_data, bench.py:453-460
    tokens = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    pos = tr.sample_masked_positions(np.random.default_rng(0), batch, seq,
                                     round(0.15 * seq))
    toks, tpos, tlab = (torch.from_numpy(a).to(dev) for a in (
        tokens, pos, np.take_along_axis(tokens, pos, axis=1)))
    model = tr.BertLarge(vocab_size=vocab, max_seq=seq, device=dev, seed=0,
                         **depth)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    return model, opt, lambda: tr.masked_lm_loss_gathered(
        model(toks, output="hidden"), model.token_embed, tpos, tlab)


def cycle_profiler():
    """This checkout's ``tools/cycle_profile.py``, loaded by path (it
    imports nothing of the package), for either checkout's runs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cycle_profile_by_path",
        Path(__file__).resolve().with_name("cycle_profile.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.CycleProfile()


def worker(checkout: Path, config: str, name: str, steps: int, layers: int,
           cpu: bool = False, profile_cycle: bool = False) -> dict:
    """One run; ``cpu`` rehearses it on the CPU (no device numbers)."""
    profile = cycle_profiler() if profile_cycle else None
    sys.path.insert(0, str(checkout))
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.utils.measure import card_line
    try:
        from horovod_tpu_torch.runtime import runtime
        issued = runtime.COUNTS
    except ImportError:  # a checkout from before the runtime
        issued = None

    hvd.init(device="cpu" if cpu else None)
    dev = hvd.device()
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    model, inner, loss_fn = _model(name, layers, dev, cpu)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(inner,
                                   named_parameters=model.named_parameters())
    rows, requested, runtime_rows = [], [], []
    for i in range(2 + steps):
        sync()
        if i == 2 and profile is not None:
            profile.start()
        before = dict(collectives.COUNTS)
        rt_before = dict(issued) if issued is not None else None
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn()
        t1 = time.perf_counter()
        loss.backward()
        t2 = time.perf_counter()
        opt.synchronize()
        t3 = time.perf_counter()
        with opt.skip_synchronize():
            opt.step()
        loss.item()
        t4 = time.perf_counter()
        if i < 2:
            continue
        rows.append(dict(step_ms=t4 - t0, fwd_ms=t1 - t0, bwd_ms=t2 - t1,
                         sync_ms=t3 - t2, opt_ms=t4 - t3))
        requested.append(collectives.COUNTS["allreduce"]
                         - before["allreduce"])
        if issued is not None:
            runtime_rows.append({k: issued[k] - rt_before[k]
                                 for k in ("allreduce", "cycles",
                                           "cycle_ms")})
    out = {"checkout": str(checkout), "config": config, "model": name,
           "card": "cpu (rehearsal)" if cpu else card_line(),
           "requested_allreduce": statistics.median(requested)}
    if profile is not None:
        profile.stop()
        out["cycle_profile"] = profile.top(15, steps)
    out.update({k: 1e3 * statistics.median(r[k] for r in rows)
                for k in PARTS})
    if runtime_rows:
        out.update({f"runtime_{k}": statistics.median(r[k]
                                                      for r in runtime_rows)
                    for k in runtime_rows[0]})
    hvd.shutdown()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path,
                    help="the checkout whose hooks path runs as 'other'")
    ap.add_argument("--configs", default="fused,t0")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--layers", type=int,
                    help="depth of bert or gpt2 (default: the model's)")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU: no device numbers")
    ap.add_argument("--models", default="bert",
                    help="any of bert, inception, gpt2, comma-separated")
    ap.add_argument("--profile-cycle", action="store_true",
                    help="profile the cycle thread over the timed steps")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        checkout, config, name = args.worker
        print(json.dumps(worker(Path(checkout), config, name, args.steps,
                                args.layers, args.cpu, args.profile_cycle)),
              flush=True)
        return 0
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("runtime_before_after needs a CUDA device", file=sys.stderr)
        return 1
    configs = args.configs.split(",")
    if args.other is not None:
        configs = ["other"] + configs
    rows = []
    for name in args.models.split(","):
        for turn in range(args.turns):
            for config in (configs if turn % 2 == 0 else configs[::-1]):
                checkout = args.other.resolve() if config == "other" else HERE
                env = dict(os.environ, **config_env(config))
                out = subprocess.run(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--worker", str(checkout), config, name, "--steps",
                     str(args.steps)]
                    + (["--layers", str(args.layers)] if args.layers else [])
                    + (["--cpu"] if args.cpu else [])
                    + (["--profile-cycle"] if args.profile_cycle else []),
                    capture_output=True, text=True, env=env)
                if out.returncode:
                    print(out.stderr[-4000:], file=sys.stderr)
                    return out.returncode
                rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
                print(json.dumps(rows[-1]), flush=True)
    medians = {}
    for row in rows:
        medians.setdefault(f"{row['model']} {row['config']}", []).append(row)
    medians = {key: {k: statistics.median(r[k] for r in runs)
                     for k, v in runs[0].items()
                     if isinstance(v, (int, float))}
               for key, runs in medians.items()}
    print(json.dumps({"medians": medians, "card": rows[-1]["card"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
