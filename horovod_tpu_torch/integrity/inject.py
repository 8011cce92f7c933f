"""Silent-corruption faults of the ``HOROVOD_FAULT_INJECT`` harness (port
of ``horovod_tpu/integrity/inject.py``). Grammar, composable with the
process and network clauses in one ``;``-separated spec::

    bitflip:<rank>[:after=<n>]
    nan:<rank>[:after=<n>]

* ``nan`` poisons element 0 of the target rank's input payload in the
  executor's pack, before the reduction: the NaN reaches every rank's
  result, as a poisoned gradient would. The port also arms it on the
  reduce-scatter lane (ZeRO's gradients), which the JAX package digests
  but does not poison: a ZeRO step runs no allreduce.
* ``bitflip`` flips the lowest bit of byte 0 of the target rank's copy of
  the reduced result after an allreduce: only the checksum vote sees it.
* ``after``: eligible dispatches to let pass before the one-shot fires
  (default 0: the first): allreduces for ``bitflip``, allreduces and
  reduce-scatters for ``nan``.

Armed by ``HOROVOD_FAULT_INJECT`` alone, whatever ``HOROVOD_INTEGRITY``
says, so a run with detection off shows that the corruption corrupts.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import torch

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import HOROVOD_FAULT_INJECT

INTEGRITY_FAULT_KINDS = ("bitflip", "nan")

# armed one-shot specs, parsed at first use; None: not parsed yet
_specs: "Optional[List[FaultSpec]]" = None  # guarded-by: <owner-thread>


@dataclasses.dataclass
class FaultSpec:
    action: str
    rank: int
    after: int = 0      # eligible dispatches to skip before firing
    fired: bool = False  # the one-shot latch


def is_integrity_clause(clause: str) -> bool:
    """Whether a ``HOROVOD_FAULT_INJECT`` clause belongs to this module."""
    return clause.strip().split(":", 1)[0].strip().lower() \
        in INTEGRITY_FAULT_KINDS


def parse_clause(clause: str) -> FaultSpec:
    parts = [p.strip() for p in clause.strip().split(":")]
    action = parts[0].lower()
    if action not in INTEGRITY_FAULT_KINDS:
        raise ValueError(
            f"HOROVOD_FAULT_INJECT: unknown integrity action {action!r} "
            f"(expected one of {INTEGRITY_FAULT_KINDS})")
    if len(parts) < 2 or not parts[1].lstrip("-").isdigit():
        raise ValueError(
            f"HOROVOD_FAULT_INJECT: {action} clause must name a rank, "
            f"got {clause!r}")
    rank = int(parts[1])
    after = 0
    for part in parts[2:]:
        key, _, value = part.partition("=")
        if key.strip().lower() != "after" or not value:
            raise ValueError(
                f"HOROVOD_FAULT_INJECT: malformed integrity clause part "
                f"{part!r} (expected after=<n>)")
        after = int(value)
    return FaultSpec(action=action, rank=rank, after=after)


def specs_from_env() -> List[FaultSpec]:
    """The armed clauses, parsed once, so the countdown and the latch
    persist across dispatches."""
    global _specs
    if _specs is None:
        _specs = [
            parse_clause(clause)
            for clause in os.environ.get(HOROVOD_FAULT_INJECT, "").split(";")
            if clause.strip() and is_integrity_clause(clause)
        ]
    return _specs


def reset() -> None:
    """Re-read the environment and forget the countdowns (tests)."""
    global _specs
    _specs = None


def _plan(rank_filter: Optional[int], kinds=INTEGRITY_FAULT_KINDS
          ) -> Optional[Tuple[str, int]]:
    """Advance the countdown of every armed spec of ``kinds`` by one
    eligible dispatch; ``(action, spec_rank)`` of the first that fires
    now."""
    fire = None
    for spec in specs_from_env():
        if spec.fired or spec.action not in kinds:
            continue
        if rank_filter is not None and spec.rank != rank_filter:
            continue
        if spec.after > 0:
            spec.after -= 1
            continue
        if fire is None:
            spec.fired = True
            fire = (spec.action, spec.rank)
    return fire


def plan_dispatch(kinds=INTEGRITY_FAULT_KINDS) -> Optional[str]:
    """The action of ``kinds`` to fire at this dispatch, when this
    worker's launch rank is the clause's target (a re-form renumbers
    ranks; a fault must not move), else None."""
    from horovod_tpu_torch.elastic import fault_inject

    if not specs_from_env():
        return None
    fire = _plan(fault_inject.initial_rank(), kinds)
    if fire is None:
        return None
    _announce(fire[0], fire[1])
    return fire[0]


def plan_dispatch_any() -> Optional[Tuple[str, int]]:
    """One process owning every rank's rows: the clause's rank selects the
    row. ``(action, row)`` or None."""
    if not specs_from_env():
        return None
    fire = _plan(None)
    if fire is not None:
        _announce(fire[0], fire[1])
    return fire


def corrupt_nan(buf: torch.Tensor) -> None:
    """Poison element 0 of a float tensor in place (a bfloat16 one with the
    JAX package's quiet NaN, 0x7FC1)."""
    flat = buf.view(-1)
    if flat.dtype == torch.bfloat16:
        flat.view(torch.int16)[0] = 0x7FC1
    else:
        flat[0] = float("nan")


def corrupt_bitflip(buf: torch.Tensor) -> None:
    """Flip the lowest bit of byte 0 in place."""
    raw = buf.view(-1).view(torch.uint8)
    raw[0] ^= 0x01


def _announce(action: str, rank: int) -> None:
    from horovod_tpu_torch.elastic import fault_inject

    log.error("fault injection: %s corruption armed for rank %d fires now",
              action, rank)
    fault_inject._FAULTS_INJECTED.inc()
    flight_recorder.emit("fault_inject", action=action, rank=rank)
