"""One rank of the 2-rank gloo world of tests/test_torch_observability_hooks.py.

Started through ``torch.multiprocessing`` (spawn). Joins the world through a
``FileStore`` with the profiler and the flight recorder's dump directory
on, trains a tiny transformer 3 steps on ZeRO-1 ``sharded_adamw`` (one
profiled step each), dumps the flight recorder, and writes to
``rank<r>.json`` what the planes hold: the first step's flight events, the
memory ledger's shard subsystems, the comms ledger's keys, the goodput
ledger and the parameters' shapes (for the layout the test rebuilds with
the JAX package)."""

import json
import os

import torch

STEPS = 3


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store",
                      HOROVOD_PROFILE="1",
                      HOROVOD_FLIGHT_RECORDER_DIR=f"{tmpdir}/flight")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import comms, flight_recorder, goodput, memory
    from horovod_tpu_torch.models.transformer import Transformer

    hvd.init(device="cpu")
    try:
        model = Transformer(vocab_size=64, d_model=32, num_layers=2,
                            num_heads=2, d_ff=64, max_seq=16,
                            dtype=torch.float32, device="cpu", seed=0)
        params = dict(model.named_parameters())
        tx = hvd.sharded_adamw(1e-3)
        state = tx.init(params)
        tokens = (torch.arange(2 * 16).reshape(2, 16) * (5 + rank)) % 64
        ring = flight_recorder.recorder()
        first = None
        for step in range(STEPS):
            n0 = len(ring.events())
            with hvd.profiler.step():
                model.zero_grad(set_to_none=True)
                model(tokens).float().pow(2).mean().backward()
                grads = {k: p.grad for k, p in params.items()}
                _, state = tx.apply(params, state, grads)
            if step == 0:
                first = [{k: e.get(k) for k in ("kind", "op", "phase",
                                                 "name", "bytes")}
                         for e in ring.events()[n0:]]
        hvd.dump_debug_state()
        led = memory.tracker().ledger()
        out = {
            "first_step_events": first,
            "optimizer_shards": led["subsystems"]["optimizer_shards"],
            "shapes": [list(p.shape) for p in params.values()],
            "comms_keys": comms.tracker().ledger()["keys"],
            "goodput": goodput.tracker().ledger(),
            "steps": STEPS,
        }
    finally:
        hvd.shutdown()
    with open(os.path.join(tmpdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
