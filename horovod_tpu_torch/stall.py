"""Stall inspector: find workers that stopped submitting tensors (port of
``StallInspector`` in ``horovod_tpu/stall.py``; reference:
horovod/common/stall_inspector.cc/.h).

On the coordinator, scan the negotiation table for tensors announced by
some but not all workers; log a warning naming the ready and missing ranks
(stall_inspector.cc:26-110); past the shutdown time, ask for a global
shutdown so the job fails instead of hanging (controller.cc:98-107).

Knobs (reference: common.h:78-80): ``HOROVOD_STALL_CHECK_DISABLE``,
``HOROVOD_STALL_CHECK_TIME_SECONDS`` (default 60). The shutdown time is
0 (never) unless a caller passes one. The JAX package's straggler
tracker, elastic verdict and metrics come with ROADMAP A10 and A11.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from horovod_tpu_torch.utils import logging as log


class StallInspector:
    def __init__(self, warning_time_seconds: float = 60.0,
                 shutdown_time_seconds: float = 0.0, enabled: bool = True):
        self.warning_time = warning_time_seconds
        self.shutdown_time = shutdown_time_seconds
        self.enabled = enabled
        self._last_check = time.monotonic()
        # fallback age baseline for tables that carry no arrival stamp
        self._first_seen: Dict[str, float] = {}

    def check(self, message_table, world: Optional[int] = None) -> bool:
        """Scan for stalled tensors; True when one stalled past the
        shutdown time (reference: CheckForStalledTensors,
        stall_inspector.cc:26-110)."""
        if not self.enabled:
            return False
        now = time.monotonic()
        if now - self._last_check < self.warning_time:
            return False
        self._last_check = now

        stalled, shutdown = [], False
        arrival_time = getattr(message_table, "first_request_time", None)
        pending = message_table.pending()
        for name, requests in pending.items():
            first = arrival_time(name) if arrival_time is not None else None
            if first is None:
                first = self._first_seen.setdefault(name, now)
            age = now - first
            if age < self.warning_time:
                continue
            ready = sorted(r.rank for r in requests)
            missing = ([] if world is None else
                       sorted(set(range(world)) - set(ready)))
            stalled.append(
                f"{name} [ready ranks: {ready}"
                + (f", missing ranks: {missing}]" if missing else "]"))
            if self.shutdown_time > 0 and age > self.shutdown_time:
                shutdown = True
        self._first_seen = {k: v for k, v in self._first_seen.items()
                            if k in pending}
        if stalled:
            log.warning(
                "One or more tensors were submitted to be reduced, gathered "
                "or broadcasted by subset of ranks and are waiting for "
                "remainder of ranks for more than %.0f seconds. This may "
                "indicate that different ranks are trying to submit "
                "different tensors or that only subset of ranks is "
                "submitting tensors. Stalled ops: %s",
                self.warning_time, "; ".join(stalled))
        if shutdown:
            log.error("Stalled tensors exceeded the shutdown time (%.0fs); "
                      "shutting down.", self.shutdown_time)
        return shutdown
