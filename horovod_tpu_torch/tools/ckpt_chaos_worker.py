"""One rank of the sharded-AdamW checkpoint cell of the port's chaos matrix
(``ckpt_reform_sharded_adamw``; port of ``tools/ckpt_chaos_worker.py``).

ZeRO-1 ``hvd.sharded_adamw`` where every parameter element starts equal
and every gradient element is 1.0, so every real element of the flat fp32
master and moment shards stays equal across the whole sharded buffer at
every step. That is the oracle of the neighbour-replica restore: when rank
1 is killed and the survivors re-form, its moment segments must come back
from its left neighbour's replica, not as zeros; zero-filled segments
would evolve apart from the others for the rest of the run, so all real
``mu``/``nu`` elements nonzero and equal across every surviving shard
tells a replica restore from a zero fill.

Prints ``CHAOS_RESULT {json}`` with ``steps_ok``, ``moments_nonzero``,
``moments_uniform`` and ``replica_restored``.
"""

import json
import os
import sys
import time

import torch

from horovod_tpu_torch.tools.chaos_worker import (final_dump, init_world,
                                                  metric_total,
                                                  resilience_counters)

TOTAL_STEPS = int(os.environ.get("CHAOS_TOTAL_STEPS", "8"))
STEP_SLEEP = float(os.environ.get("CHAOS_STEP_SLEEP", "0"))
# divisible by neither 2 nor 3: both shard layouts carry padding
N = 37


def real_moments(opt_state) -> dict:
    """This rank's real (not padding) elements of each moment: shard
    ``spec.rank`` starts at ``rank * shard_elems`` of the flat buffer, and
    elements at or past ``n`` are padding."""
    from horovod_tpu_torch.parallel import zero

    export = zero.export_shard_arrays(opt_state)
    spec = opt_state.spec
    out = {}
    for comp in ("mu", "nu"):
        parts = []
        for g, arr in zip(spec.groups, export[comp]):
            arr = arr.reshape(-1).float()
            offset = spec.rank * g.shard_elems
            parts.append(arr[:max(0, min(g.n - offset, arr.numel()))])
        out[comp] = torch.cat(parts) if parts else torch.zeros(0)
    return out


def main() -> int:
    torch.set_num_threads(1)
    hvd, dev = init_world()
    tx = hvd.sharded_adamw(0.1)
    params = {"w": torch.full((N,), 0.5, device=dev)}
    state = hvd.elastic.ArrayState(params=params, optimizer=tx.init(params),
                                   step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < TOTAL_STEPS:
            grads = {"w": torch.ones(N, device=dev)}
            _, state.optimizer = tx.apply(state.params, state.optimizer,
                                          grads)
            state.step += 1
            state.commit()
            if STEP_SLEEP:
                time.sleep(STEP_SLEEP)
        return state

    train(state)
    state.checkpoint_wait()
    moments = real_moments(state.optimizer)
    moments_nonzero = bool(
        all(a.numel() == 0 or bool((a.abs() > 0).all())
            for a in moments.values())
        and any(a.numel() for a in moments.values()))
    # each component uniform here, and its value the same on every
    # surviving shard (a min/max allgather): a zero fill breaks one or the
    # other
    moments_uniform = True
    for comp in ("mu", "nu"):
        a = moments[comp].double()
        local = (torch.stack([a.min(), a.max()]) if a.numel()
                 else torch.full((2,), float("nan"), dtype=torch.float64))
        gathered = hvd.allgather(local.reshape(1, 2).to(dev),
                                 name=f"ckpt_chaos_mm_{comp}").cpu()
        vals = gathered[torch.isfinite(gathered)]
        if vals.numel() and float(vals.max() - vals.min()) != 0.0:
            moments_uniform = False
    snap = hvd.metrics()
    restores = metric_total(snap, "horovod_ckpt_replica_restores_total")
    result = {
        "rank": hvd.rank(), "size": hvd.size(), "step": state.step,
        "generation": hvd.elastic.restarts(),
        "steps_ok": state.step == TOTAL_STEPS,
        "moments_nonzero": moments_nonzero,
        "moments_uniform": moments_uniform,
        "replica_restored": restores > 0,
        "replica_restores_total": restores,
        **resilience_counters(snap),
    }
    final_dump()
    print("CHAOS_RESULT " + json.dumps(result), flush=True)
    ok = result["steps_ok"] and moments_nonzero and moments_uniform
    hvd.shutdown()
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
