"""One rank of the port's chaos matrix (``chaos_matrix.py`` beside it; port
of ``tools/chaos_worker.py``).

The elastic loop of the JAX worker on the port's ``hvd.elastic.run`` and
``ArrayState``: an Average allreduce of ones a step, so ``w == step`` at
every commit (the zero-lost-steps invariant), and

* ``CHAOS_STEP_SLEEP`` seconds of sleep a step, so that timer-armed faults
  (``partition:...:after=N``) land inside the training window;
* ``CHAOS_INTEGRITY_GUARD=1``: a ``StepGuard`` watches the reduced
  gradient and a flagged step is retried, not applied (the NaN cell);
* one ``CHAOS_RESULT {json}`` line with the invariants and the resilience
  counters the matrix reads, the hierarchy plan the survivors ended up
  running, and the goodput ledger;
* a final flight-recorder dump, so the merged postmortem sees the re-form.

The world is the launcher's contract in the environment. A rank takes
``cuda:<rank>`` (NCCL) and fails when the host has no such card;
``CHAOS_DEVICE=cpu`` asks for a gloo world on the CPU instead.
"""

import json
import os
import sys
import time

import torch

TOTAL_STEPS = int(os.environ.get("CHAOS_TOTAL_STEPS", "8"))
STEP_SLEEP = float(os.environ.get("CHAOS_STEP_SLEEP", "0"))


def metric_total(snap: dict, name: str) -> float:
    fam = snap.get(name, {})
    return float(sum(row.get("value", 0.0)
                     for row in fam.get("values", ())))


def resilience_counters(snap: dict) -> dict:
    return {
        "net_retries_total": metric_total(snap, "horovod_net_retries_total"),
        "net_gave_up_total": metric_total(snap, "horovod_net_gave_up_total"),
        "chaos_injected_total": metric_total(
            snap, "horovod_net_chaos_injected_total"),
    }


def init_world():
    """``hvd.init`` on ``cuda:<launch rank>``, or on the CPU under
    ``CHAOS_DEVICE=cpu``; the module and the device."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import fault_inject

    device = os.environ.get("CHAOS_DEVICE", "cuda")
    if device == "cpu":
        hvd.init(device="cpu")
        return hvd, hvd.device()
    if device != "cuda":
        raise ValueError(f"CHAOS_DEVICE={device!r}: cuda or cpu")
    rank, cards = fault_inject.initial_rank(), torch.cuda.device_count()
    if rank >= cards:
        raise RuntimeError(
            f"chaos worker rank {rank} takes cuda:{rank} and this host has "
            f"{cards} CUDA device(s); CHAOS_DEVICE=cpu runs the world on "
            f"the CPU (gloo)")
    hvd.init(device=torch.device("cuda", rank))
    return hvd, hvd.device()


def final_dump() -> None:
    """The postmortem needs the events after the re-form."""
    from horovod_tpu_torch import flight_recorder

    try:
        flight_recorder.dump_debug_state(reason="chaos_run_complete")
    except Exception:
        pass


def main() -> int:
    torch.set_num_threads(1)
    hvd, dev = init_world()
    guard = None
    if os.environ.get("CHAOS_INTEGRITY_GUARD") == "1":
        from horovod_tpu_torch.integrity import guards

        # outside train: a replay must not reset its statistics
        guard = guards.StepGuard(name="chaos_grad")
    state = hvd.elastic.ArrayState(
        params={"w": torch.zeros(4, device=dev)}, optimizer=None, step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < TOTAL_STEPS:
            grad = hvd.allreduce(torch.ones(4, device=dev), average=True,
                                 name="chaos_grad")
            if guard is not None and not guard.observe(float(grad[0])):
                continue  # skipped: every rank saw the same reduced value
            state.params["w"] += grad
            state.step += 1
            state.commit()
            if STEP_SLEEP:
                time.sleep(STEP_SLEEP)
        return state

    train(state)
    w = float(state.params["w"][0].cpu())
    snap = hvd.metrics()
    result = {
        "rank": hvd.rank(), "size": hvd.size(), "step": state.step, "w": w,
        "generation": hvd.elastic.restarts(),
        **resilience_counters(snap),
        "integrity_checks": metric_total(
            snap, "horovod_integrity_checks_total"),
        "integrity_violations": metric_total(
            snap, "horovod_integrity_violations_total"),
        "rollbacks": metric_total(snap, "horovod_integrity_rollbacks_total"),
        "skipped_steps": metric_total(
            snap, "horovod_integrity_skipped_steps_total"),
    }
    # the plan the survivors run after a re-form (the executor's groups)
    from horovod_tpu_torch.core import state as state_mod

    rt = state_mod.global_state().runtime
    hier = rt.executor._hier if rt is not None else None
    result["hier_enabled"] = hier is not None
    if hier is not None:
        result["hier_groups"] = hier.plan.num_groups
        result["hier_group_size"] = hier.plan.group_size
    from horovod_tpu_torch import goodput

    led = goodput.tracker().ledger()
    result.update(goodput_fraction=led["goodput_fraction"],
                  goodput_accounted=led["accounted_fraction"],
                  goodput_badput=led["badput_seconds"],
                  goodput_replayed=led["steps_replayed"],
                  goodput_incidents=led["incident_counts"])
    final_dump()
    print("CHAOS_RESULT " + json.dumps(result), flush=True)
    ok = state.step == TOTAL_STEPS and abs(w - TOTAL_STEPS) <= 1e-4
    hvd.shutdown()
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
