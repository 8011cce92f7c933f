"""Rollback and replay after an integrity failure (port of
``horovod_tpu/integrity/rollback.py:46-146``).

A digest verdict (or the step guard's spent skip budget) raises a typed
:class:`~horovod_tpu_torch.exceptions.NumericalError` on every rank in the
same dispatch, so recovery needs no re-form, no restart and no barrier:
each rank restores the last committed state in place, and ``@elastic.run``
calls the training function again to replay the lost steps.

* ``HOROVOD_ROLLBACK_BUDGET``: in-place replays a process may take
  (default 2); past it the error is raised again, for a supervised restart.
* ``HOROVOD_INTEGRITY_QUARANTINE``: when the vote named this rank as the
  corruption's source, exit instead of replaying, so the survivors re-form
  without it (off by default: one flipped bit is usually transient).

A rollback is a ``rollback`` flight event (its error names the verdict;
``@elastic.run`` makes a failure dump after it) and a goodput incident of cause ``rollback``
whose seconds are the restore's and whose replay countdown charges the
re-run steps (those between the restored step and the failed one, and the
failed one) to it. A quarantine and a spent budget are flight events with
a failure dump.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import (HOROVOD_INTEGRITY_QUARANTINE,
                                         HOROVOD_ROLLBACK_BUDGET, _get_bool,
                                         _get_int)

DEFAULT_ROLLBACK_BUDGET = 2

_ROLLBACKS = _metrics().counter(
    "horovod_integrity_rollbacks_total",
    "In-place rollback-and-replay recoveries from integrity failures.")

_replays = 0  # guarded-by: <owner-thread>


def replays() -> int:
    return _replays


def reset() -> None:
    """Forget the replay count (tests)."""
    global _replays
    _replays = 0


def should_quarantine(exc: Exception) -> bool:
    """Whether quarantine is armed and the vote named this process."""
    if not _get_bool(HOROVOD_INTEGRITY_QUARANTINE):
        return False
    suspect = getattr(exc, "suspect_rank", None)
    if suspect is None:
        return False
    from horovod_tpu_torch.elastic import fault_inject

    return suspect == fault_inject.initial_rank()


def quarantine_self(exc: Exception) -> None:
    """Leave the job so that the survivors re-form without this rank."""
    log.error("integrity quarantine: this rank (%s) was voted the "
              "corruption source; exiting so the job re-forms without "
              "it (%s)", getattr(exc, "suspect_rank", "?"), exc)
    flight_recorder.emit("integrity_quarantine",
                         suspect=getattr(exc, "suspect_rank", None),
                         error=str(exc)[:200])
    flight_recorder.dump_on_failure("integrity_quarantine")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(1)


def handle_failure(state, exc: Exception) -> Optional[int]:
    """Restore the last committed state in place and count the replay.

    Prefers the newest checkpoint cut of the state's ``HOROVOD_CKPT_DIR``
    (waiting for an async commit still in flight first), and falls back to
    the commit's memory snapshot. Raises ``exc`` again once the budget is
    spent. Returns the restored step, or None when the state has none."""
    global _replays
    if should_quarantine(exc):
        quarantine_self(exc)  # does not return
    budget = _get_int(HOROVOD_ROLLBACK_BUDGET, DEFAULT_ROLLBACK_BUDGET)
    if _replays >= budget:
        log.error("integrity rollback budget exhausted (%d/%d); "
                  "escalating to a supervised restart", _replays, budget)
        flight_recorder.emit("rollback_budget_exhausted", replays=_replays,
                             budget=budget, error=str(exc)[:200])
        flight_recorder.dump_on_failure("rollback_budget_exhausted")
        raise exc
    _replays += 1
    _ROLLBACKS.inc()
    failing_step = getattr(state, "step", None)
    t_restore = time.monotonic()
    restored_step = None
    if getattr(state, "_ckpt_dir", None):
        wait = getattr(state, "checkpoint_wait", None)
        if wait is not None:
            wait()  # an async commit in flight lands before the restore
        restored_step = state.load_latest()
    if restored_step is None:
        state.on_reset()
        restored_step = getattr(state, "step", None)
    log.warning("integrity rollback %d/%d: restored step %s after %s: %s",
                _replays, budget, restored_step, type(exc).__name__, exc)
    suspect = getattr(exc, "suspect_rank", None)
    flight_recorder.emit("rollback", replay=_replays, budget=budget,
                         restored_step=restored_step, suspect=suspect,
                         error="%s: %s" % (type(exc).__name__,
                                           str(exc)[:200]))
    # the step in flight at the failure runs again too: its first attempt
    # is lost work even when the restore lands on the last commit
    replay_steps = 1
    if isinstance(failing_step, int) and isinstance(restored_step, int):
        replay_steps = max(0, failing_step - restored_step) + 1
    goodput.note_incident(
        "rollback", time.monotonic() - t_restore, culprit_rank=suspect,
        replay_steps=replay_steps,
        linked_events=["rollback", "integrity_violation"])
    return restored_step
