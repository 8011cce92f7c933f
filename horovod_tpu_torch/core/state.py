"""Process-global framework state (port of ``horovod_tpu/core/state.py``).

One singleton holds the topology, the device this process drives, whether
``init()`` created the ``torch.distributed`` process group (and so must
destroy it at ``shutdown()``) and its store, the knobs ``init()`` parsed
(``utils.env.Config``), the enqueue runtime's two process groups and the
runtime itself, started at the first enqueue, and the model-parallel axes'
groups."""

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
    # the c10d store the world was made from (None when init() did not
    # create the group): the checkpoint's commit barrier
    store: Any = None
    # utils.env.Config, parsed once by init()
    config: Any = None

    # the runtime's groups (core/basics.init): negotiation on gloo, the
    # collectives on NCCL (gloo on the CPU); the runtime (runtime/runtime.py)
    control_group: Any = None
    data_group: Any = None
    runtime: Any = None
    # the model-parallel axes' groups (parallel/_util.axis_group), made on
    # first use in this generation, by sorted member ranks
    axis_groups: dict = dataclasses.field(default_factory=dict)

    lock: Any = dataclasses.field(default_factory=threading.RLock)


_global_state = GlobalState()


def global_state() -> GlobalState:
    return _global_state


def reset() -> None:
    """Replace the singleton with a fresh state (used by shutdown)."""
    global _global_state
    _global_state = GlobalState()
