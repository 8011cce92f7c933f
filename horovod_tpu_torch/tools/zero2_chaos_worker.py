"""One rank of the ZeRO-2 cell of the port's chaos matrix
(``zero2_kill_mid_reducescatter``; port of ``tools/zero2_chaos_worker.py``).

Stage-2 sharded training: a ``GradReleasePlan(reduce_scatter=True)``
releases each backward bucket as a reduce-scatter (one leaf a bucket,
three a step) and the partition-aligned ``hvd.sharded_adamw`` takes the
``ShardedGrads``; the full gradient is never put together. At
``ZERO2_KILL_STEP`` rank ``ZERO2_KILL_RANK`` dies inside its second
bucket's release, with bucket 0's reduce-scatter already in flight. The
survivors' gather fails the orphaned tokens with ``WorkersDownError``,
``@hvd.elastic.run`` re-forms them, and ``zero.resync`` rebuilds the AdamW
shards for the new world.

Prints ``CHAOS_RESULT {json}`` with ``resharded`` (the optimizer's layout
is the new world's) and ``leases_ok`` (no fusion slab leased out once the
run is over: every failed token gave its slab back).

Invariant: the loss is a plain sum, so every averaged gradient element is
1, and AdamW with b1 = b2 = eps = weight decay = 0 and lr = -1 adds exactly
1.0 an element a step whatever the world: ``w == step`` at every commit.
"""

import json
import os
import sys
import time

import torch

from horovod_tpu_torch.tools.chaos_worker import (final_dump, init_world,
                                                  resilience_counters)

TOTAL_STEPS = int(os.environ.get("CHAOS_TOTAL_STEPS", "8"))
STEP_SLEEP = float(os.environ.get("CHAOS_STEP_SLEEP", "0"))
KILL_STEP = int(os.environ.get("ZERO2_KILL_STEP", "3"))
KILL_RANK = int(os.environ.get("ZERO2_KILL_RANK", "1"))


def main() -> int:
    from horovod_tpu_torch.elastic import fault_inject
    from horovod_tpu_torch.parallel import buckets as buckets_mod

    torch.set_num_threads(1)
    hvd, dev = init_world()
    launch_rank = fault_inject.initial_rank()
    die_mid_rs = [False]
    real_release = buckets_mod.GradReleasePlan._release_reduce_scatter

    def release_and_maybe_die(self, bucket, values):
        real_release(self, bucket, values)
        if die_mid_rs[0] and bucket.index >= 1:
            # bucket 0's reduce-scatter is on the wire and later buckets
            # are still in the backward: stage-2 tokens in flight
            os._exit(17)

    buckets_mod.GradReleasePlan._release_reduce_scatter = \
        release_and_maybe_die
    # 384 bytes a leaf > bucket_bytes: one leaf a bucket, three
    # reduce-scatters a step
    plan = buckets_mod.GradReleasePlan(bucket_bytes=256, reduce_scatter=True)
    params = {k: torch.zeros(96, device=dev, requires_grad=True)
              for k in ("a", "b", "c")}
    opt = hvd.sharded_adamw(-1.0, 0.0, 0.0, 0.0, 0.0,
                            partition=plan.zero_partition(params))
    state = hvd.elastic.ArrayState(params=params, optimizer=opt.init(params),
                                   step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < TOTAL_STEPS:
            die_mid_rs[0] = (launch_rank == KILL_RANK
                             and state.step == KILL_STEP
                             and hvd.elastic.restarts() == 0)
            p = plan.tag(state.params)
            sum(x.sum() for x in p.values()).backward()
            sg = plan.gather()
            die_mid_rs[0] = False
            _, state.optimizer = opt.apply(state.params, state.optimizer, sg)
            state.step += 1
            state.commit()
            if STEP_SLEEP:
                time.sleep(STEP_SLEEP)
        return state

    train(state)
    from horovod_tpu_torch.core import state as state_mod

    _total, leased, leases_out = \
        state_mod.global_state().runtime.executor.fusion_buffers.usage()
    spec = state.optimizer.spec
    w = torch.cat([state.params[k].detach().reshape(-1).cpu()
                   for k in sorted(state.params)])
    lockstep = bool(((w - TOTAL_STEPS).abs() < 1e-5).all())
    result = {
        "rank": hvd.rank(), "size": hvd.size(), "step": state.step,
        "w": float(w[0]), "generation": hvd.elastic.restarts(),
        "resharded": spec.world == hvd.size() and spec.rank == hvd.rank(),
        "leases_ok": leases_out == 0 and leased == 0,
        "leases_leaked_bytes": int(leased),
        "wire_released": plan.wire_stats()["released"],
        **resilience_counters(hvd.metrics()),
    }
    final_dump()
    print("CHAOS_RESULT " + json.dumps(result), flush=True)
    ok = (state.step == TOTAL_STEPS and lockstep and result["resharded"]
          and result["leases_ok"])
    hvd.shutdown()
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
