#!/usr/bin/env python3
"""The flat ZeRO AdamW kernel B8 of two checkouts on one card, in turns:
its time at BERT-Large's ZeRO shards, and the ZeRO steps that run it.

    python3 horovod_tpu_torch/tools/adamw_before_after.py --other <checkout>

runs ``2 * --turns`` processes in the order other, this, this, other, ...
(``fwd_before_after.run_turns``). Each imports the ``horovod_tpu_torch``
and the ``chip_smoke.py`` of its checkout (for BERT-Large's shapes, the
ZeRO layouts and the training paths) and measures, by THIS checkout's
``utils.measure.time_ms`` (CUDA events around a CUDA graph of ``--iters``
calls), on ``chip_smoke.flat_inputs`` data:

- ``ms.p2_shard``: ``flat_adamw_shard`` with float32 output over P2's
  world-1 shard (536,870,912 elements, the bucket pad included);
- ``ms.p2_shard_p_is_master``: the library's ``hvd_flat_adamw`` over the
  same shard with ``p_out`` set to master's address: a checkout whose
  kernel writes a separate ``p`` stream then writes it over master, so
  the card's L2 merges the two stores and the kernel moves a float32
  group's 28 bytes an element (a grid-stride kernel with the byte cut);
- ``ms.group``: ``flat_adamw_shard`` over one 2,097,152-element group
  shard of the P4/P5 bucket layout, and ``ms.groups`` over all 145 group
  shards of a step (one graph);
- ``ms.library_p2``, ``ms.library_group``: ``torch.optim.AdamW(fused=True)``
  over the same shards (a yardstick the port never calls);
- ``ms.copy_p2``: ``Tensor.copy_`` of one P2-shard-long float32 buffer
  into another (2.147 GB read, 2.147 GB written): the rate the card's
  memory gives a stream of half reads and half writes;
- ``host_us.group``: the wrapper's host time a call;
- with ``--steps``: ``ms.step_<path>`` and ``peak_gib.<path>``, the median
  step and ``max_memory_allocated`` of P2 (``zero``), P4 (``zero2``) and
  P5 (``zero3``) through that checkout's ``chip_smoke.train`` (BERT-Large
  at full width, 2 warm-up and 10 timed steps), and ``losses.<path>``;
- with ``--steps --profile-cycle``: ``cycle_profile``, a further P4 run
  (2 warm-up and 10 steps) with the runtime's cycle thread profiled over
  its last 10 (``tools/cycle_profile.py``: the 15 functions with the most
  cumulative ms a step). ``HOROVOD_NATIVE_CYCLE=0`` in the environment
  profiles this checkout's Python cycle engine.

It prints one JSON line per process, then one with each checkout's
medians, whether the checkouts' losses are bit-equal path by path and
P4's and P5's to P2's, and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
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
#: the ZeRO paths of chip_smoke.py that launch B8: P2, P4, P5
PATHS = ("zero", "zero2", "zero3")


def _chip_smoke(checkout: Path):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_checkout", checkout / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _cycle_profiler():
    """This checkout's ``tools/cycle_profile.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "cycle_profile_by_path",
        Path(__file__).resolve().with_name("cycle_profile.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.CycleProfile()


def profile_p4(cs, dev, warmup: int = 2, steps: int = 10,
               cfg=None) -> dict:
    """P4's step as ``chip_smoke._train`` builds it (``cfg``: its
    ``FULL``), its cycle thread profiled over the steps after
    ``warmup``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.transformer import BertLarge

    cfg = cs.FULL if cfg is None else cfg
    tokens, positions, labels, _ = cs.mlm_data(cfg)
    hvd.init(device=None if dev.type == "cuda" else "cpu")
    model = BertLarge(**cfg["model"], device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = dict(model.named_parameters())
    batch = tuple(torch.from_numpy(a).to(dev)
                  for a in (tokens, positions, labels))
    step, _ = cs.make_step("zero2", model, params, dev, batch)
    profile = _cycle_profiler()
    for i in range(warmup + steps):
        if i == warmup:
            profile.start()
        step().item()
    profile.stop()
    del model, params, step
    hvd.shutdown()
    cs.free_memory(dev)
    return profile.top(15, steps)


def worker(checkout: Path, iters: int, calls: int, steps: bool,
           profile_cycle: bool = False) -> dict:
    """Measure B8 (and the steps) of the ``horovod_tpu_torch`` in
    ``checkout``."""
    sys.path.insert(0, str(checkout))
    import torch

    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import fused_optimizer as fopt

    cs = _chip_smoke(checkout)
    timer = FWD.this_timer()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    sc = fadam.adamw_scalars(1, **cs.ADAMW)
    hyper = dict(lr=cs.ADAMW["learning_rate"],
                 betas=(cs.ADAMW["b1"], cs.ADAMW["b2"]), eps=cs.EPS,
                 weight_decay=cs.ADAMW["weight_decay"], capturable=True)
    shapes = cs.model_shapes(cs.FULL)
    lib = fadam.lib()
    ms, host = {}, {}

    def shard_rows(label, n, n_real, seed):
        bufs = cs.flat_inputs(n, n_real, f32, dev, seed)
        master, mu, nu, grad = bufs

        def wrapper():
            fopt.flat_adamw_shard(master, mu, nu, grad, sc, eps=cs.EPS,
                                  out_dtype=f32)

        ms[label] = timer.time_ms(wrapper, iters, dev)
        if label == "p2_shard":
            def p_is_master():
                err = lib.hvd_flat_adamw(
                    master.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                    grad.data_ptr(), master.data_ptr(), n, 0, 0,
                    *(float(x) for x in sc), float(cs.EPS),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"hvd_flat_adamw: cudaError {err}")

            ms["p2_shard_p_is_master"] = timer.time_ms(p_is_master, iters,
                                                       dev)
        else:
            host[label] = FWD.host_us(wrapper, calls)
        if label == "p2_shard":
            ms["copy_p2"] = timer.time_ms(lambda: mu.copy_(nu), iters, dev)
        shadow = master.clone()
        shadow.grad = grad
        fused = torch.optim.AdamW([shadow], fused=True, **hyper)
        ms[f"library_{label.split('_')[0]}"] = timer.time_ms(fused.step,
                                                             iters, dev)
        del bufs, master, mu, nu, grad, shadow, fused
        cs.free_memory(dev)

    n_real = sum(int(torch.Size(s).numel()) for s in shapes)
    shard_rows("p2_shard", cs.world1_shard(shapes), n_real, 8)
    spec = cs.bucket_spec(shapes)
    sizes = [g.shard_elems for g in spec.groups]
    n = statistics.mode(sizes)
    shard_rows("group", n, next(g.n for g in spec.groups
                                if g.shard_elems == n), 10)
    bufs = [cs.flat_inputs(g.shard_elems, g.n, f32, dev, seed=gi)
            for gi, g in enumerate(spec.groups)]

    def every_group():
        for b in bufs:
            fopt.flat_adamw_shard(*b, sc, eps=cs.EPS, out_dtype=f32)

    ms["groups"] = timer.time_ms(every_group, max(1, iters // 4), dev)
    del bufs
    cs.free_memory(dev)
    peak, losses = {}, {}
    if steps:
        card = timer.card_line()
        for path in PATHS:
            run = cs.train(cs.FULL, dev, card, path)
            ms[f"step_{path}"] = run["step_ms"]
            peak[path] = torch.cuda.max_memory_allocated() / 2**30
            losses[path] = run["losses"]
    out = {"checkout": str(checkout), "package": fopt.__file__,
           "groups": len(sizes), "ms": ms, "host_us": host,
           "peak_gib": peak, "losses": losses}
    if steps and profile_cycle:
        out["cycle_profile"] = profile_p4(cs, dev)
    return out


def main() -> int:
    ap = FWD.parse_args(__doc__.split("\n")[0], extra=(
        ("--steps", dict(action="store_true",
                         help="also time P2, P4 and P5 as whole steps")),
        ("--profile-cycle", dict(action="store_true",
                                 help="with --steps, profile P4's cycle "
                                      "thread in a run of its own")),))
    if ap.worker:
        print(json.dumps(worker(ap.worker.resolve(), ap.iters, ap.calls,
                                ap.steps, ap.profile_cycle)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("adamw_before_after needs a CUDA device", file=sys.stderr)
        return 1
    args = ["--iters", str(ap.iters), "--calls", str(ap.calls)]
    if ap.steps:
        args.append("--steps")
    if ap.profile_cycle:
        args.append("--profile-cycle")
    rc, rows = FWD.run_turns(Path(__file__).resolve(), ap.other, ap.turns,
                             args)
    if rc:
        return rc
    what = ("ms", "host_us", "peak_gib") if ap.steps else ("ms", "host_us")
    same = {  # every process's losses, path by path
        "across_checkouts": {path: len({json.dumps(r["losses"][path])
                                        for r in rows}) == 1
                             for path in (PATHS if ap.steps else ())},
        "p4_p5_as_p2": all(r["losses"][p] == r["losses"]["zero"]
                           for r in rows for p in PATHS) if ap.steps
        else None}
    print(json.dumps({"medians": FWD.medians(rows, what),
                      "losses_bit_equal": same, "args": args,
                      "card": FWD.this_timer().card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
