"""The launch rank that fault injection keys on (port of
``horovod_tpu/elastic/fault_inject.py:125-131``).

The checkpoint writer's ``HOROVOD_CKPT_FAULT`` kills the rank it names at a
commit phase (``ckpt/writer.py``); it names the rank the worker launched
with, which a re-form must not move. The JAX module's per-step process
faults (``HOROVOD_FAULT_INJECT``: ``kill``, ``hang`` and ``slow`` at a
step, fired by ``elastic.State``) come with the port's ``State``, and its
network clauses with the transports that fire them (ROADMAP, elastic).
"""

from __future__ import annotations

import os
from typing import Optional

from horovod_tpu_torch.utils.env import HOROVOD_RANK

# the worker's launch-time rank, captured before any re-form renumbers
# HOROVOD_RANK
_initial_rank: Optional[int] = None


def initial_rank() -> int:
    """The rank this process launched with, frozen on first access: a
    re-form rewrites ``HOROVOD_RANK`` but must not re-target faults."""
    global _initial_rank
    if _initial_rank is None:
        _initial_rank = int(os.environ.get(HOROVOD_RANK, "0"))
    return _initial_rank
