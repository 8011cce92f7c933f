"""Process-global framework state (port of ``horovod_tpu/core/state.py``).

One singleton holds the topology, the device this process drives and
whether ``init()`` created the ``torch.distributed`` process group (and so
must destroy it at ``shutdown()``)."""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import torch


@dataclasses.dataclass
class GlobalState:
    initialized: bool = False

    # Worker topology: one process per device, as in the reference.
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1

    device: Optional[torch.device] = None
    owns_group: bool = False

    lock: Any = dataclasses.field(default_factory=threading.RLock)


_global_state = GlobalState()


def global_state() -> GlobalState:
    return _global_state


def reset() -> None:
    """Replace the singleton with a fresh state (used by shutdown)."""
    global _global_state
    _global_state = GlobalState()
