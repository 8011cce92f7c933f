"""Deterministic process faults for elastic testing (port of
``horovod_tpu/elastic/fault_inject.py:61-180``).

``HOROVOD_FAULT_INJECT=<spec>`` arms a one-shot fault on a chosen rank at
a chosen step. The variable holds ``;``-separated clauses; this module owns
the process faults, while the network faults (``partition``, ``kv_outage``,
``flaky``, ``netdelay``) belong to ``utils/resilience.py`` and the
data-corruption faults (``bitflip``, ``nan``) to ``integrity/inject.py``.
Process-fault grammar::

    <action>:rank=<r>:step=<s>[:code=<c>][:seconds=<t>][:gen=<g>]

* ``kill`` (``os._exit(code)``), ``hang`` (one long sleep, which the
  collective deadline or a transport timeout must catch) or ``slow``
  (sleep ``seconds`` at every step >= ``step``: a persistent straggler);
* ``rank``: the rank to fault, matched against the worker's launch rank
  (:func:`initial_rank`: a re-form renumbers the survivors, and a fault
  must not fire again on whoever inherited the number);
* ``step``: fire when the state's step counter reaches it;
* ``code``: the exit code of ``kill`` (default 1); ``seconds``: the hang's
  length (default 3600) or the per-step slowdown; ``gen``: the generation
  (re-form count) in which the fault is armed (default 0).

:func:`maybe_inject` is the hook; ``elastic.State.commit()`` calls it
every step. The checkpoint writer's ``HOROVOD_CKPT_FAULT`` names the rank
it kills by :func:`initial_rank` too. Each fault that fires is a
``fault_inject`` flight event, and a kill makes a failure dump first.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Optional

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import HOROVOD_FAULT_INJECT, HOROVOD_RANK

_FAULTS_INJECTED = _metrics().counter(
    "horovod_elastic_faults_injected_total",
    "Deterministic faults fired by the HOROVOD_FAULT_INJECT harness.")

_ACTIONS = ("kill", "hang", "slow")

# "slow" logs at its first firing only (it fires every step)
_slow_announced = False

# the worker's launch-time rank, captured before any re-form renumbers
# HOROVOD_RANK
_initial_rank: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    action: str
    rank: int
    step: int
    code: int = 1
    seconds: float = 3600.0
    generation: int = 0


def parse_spec(text: str) -> FaultSpec:
    parts = text.strip().split(":")
    action = parts[0].strip().lower()
    if action not in _ACTIONS:
        raise ValueError(
            f"{HOROVOD_FAULT_INJECT}: unknown action {action!r} "
            f"(expected one of {_ACTIONS})")
    fields = {"rank": None, "step": None, "code": 1,
              "seconds": 3600.0, "gen": 0}
    for part in parts[1:]:
        if "=" not in part:
            raise ValueError(
                f"{HOROVOD_FAULT_INJECT}: malformed clause {part!r} "
                f"(expected key=value)")
        key, value = part.split("=", 1)
        key = key.strip().lower()
        if key not in fields:
            raise ValueError(
                f"{HOROVOD_FAULT_INJECT}: unknown key {key!r} "
                f"(expected one of {sorted(fields)})")
        fields[key] = float(value) if key == "seconds" else int(value)
    if fields["rank"] is None or fields["step"] is None:
        raise ValueError(
            f"{HOROVOD_FAULT_INJECT}: spec must name rank= and step=")
    return FaultSpec(action=action, rank=fields["rank"], step=fields["step"],
                     code=fields["code"], seconds=fields["seconds"],
                     generation=fields["gen"])


def specs_from_env() -> tuple:
    """Every process-fault clause of the spec (a chaos cell may arm one
    kill a target rank, and each worker must see the clause naming its
    rank). Network and data-corruption clauses are skipped, not
    rejected."""
    from horovod_tpu_torch.integrity import inject as _integrity_inject
    from horovod_tpu_torch.utils import resilience

    specs = []
    for clause in os.environ.get(HOROVOD_FAULT_INJECT, "").split(";"):
        clause = clause.strip()
        if not clause or resilience.is_net_clause(clause) \
                or _integrity_inject.is_integrity_clause(clause):
            continue
        specs.append(parse_spec(clause))
    return tuple(specs)


def spec_from_env() -> Optional[FaultSpec]:
    """The first process-fault clause (see :func:`specs_from_env`)."""
    specs = specs_from_env()
    return specs[0] if specs else None


def initial_rank() -> int:
    """The rank this process launched with, frozen on first access: a
    re-form rewrites ``HOROVOD_RANK`` but must not re-target faults."""
    global _initial_rank
    if _initial_rank is None:
        _initial_rank = int(os.environ.get(HOROVOD_RANK, "0"))
    return _initial_rank


def maybe_inject(step: int, rank: Optional[int] = None,
                 generation: int = 0) -> None:
    """Fire each armed fault whose rank, step and generation match:
    ``kill`` and ``hang`` at ``spec.step`` exactly, ``slow`` at every step
    from it on."""
    if rank is None:
        rank = initial_rank()
    for spec in specs_from_env():
        _fire(spec, step, rank, generation)


def _fire(spec: FaultSpec, step: int, rank: int, generation: int) -> None:
    global _slow_announced
    if rank != spec.rank or generation != spec.generation:
        return
    if spec.action == "slow":
        if step < spec.step:
            return
        _FAULTS_INJECTED.inc()
        if not _slow_announced:
            _slow_announced = True
            log.error("fault injection: slowing rank %d by %.3fs per step "
                      "from step %d on", rank, spec.seconds, spec.step)
        flight_recorder.emit("fault_inject", action="slow", rank=rank,
                             step=step, seconds=spec.seconds)
        time.sleep(spec.seconds)
        return
    if step != spec.step:
        return
    _FAULTS_INJECTED.inc()
    if spec.action == "kill":
        log.error("fault injection: killing rank %d at step %d "
                  "(exit code %d)", rank, step, spec.code)
        # os._exit skips atexit and the signal handlers: the recorder
        # dumps here, or the postmortem loses the culprit
        flight_recorder.emit("fault_inject", action="kill", rank=rank,
                             step=step, code=spec.code)
        flight_recorder.dump_on_failure("fault_inject_kill")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(spec.code)
    log.error("fault injection: hanging rank %d at step %d for %.0fs",
              rank, step, spec.seconds)
    flight_recorder.emit("fault_inject", action="hang", rank=rank,
                         step=step, seconds=spec.seconds)
    time.sleep(spec.seconds)
