"""Elastic (fault-tolerant) training (port of ``horovod_tpu/elastic/``;
reference: horovod/common/elastic.py, horovod/run/elastic/).

Usage::

    import horovod_tpu_torch as hvd

    hvd.init()
    state = hvd.elastic.ArrayState(model, zero_state, step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < total_steps:
            ...  # a step that updates the model and state.optimizer
            state.step += 1
            state.commit()

    train(state)

A lost peer makes the runtime raise
:class:`~horovod_tpu_torch.exceptions.WorkersDownError`; ``run`` re-forms
the world through the rendezvous store
(``HOROVOD_RENDEZVOUS_HTTP_ADDR``/``_PORT``), joins it again
(``core.basics.reinit``), rolls back to the last ``commit()``, re-shards
the ZeRO state and calls ``train`` again. An integrity verdict rolls back
in place; a driver's host-change notice re-forms without a rollback.
"""

from horovod_tpu_torch.elastic.fault_inject import FaultSpec, maybe_inject
from horovod_tpu_torch.elastic.runner import (
    Backoff,
    check_host_updates,
    restarts,
    run,
    start_heartbeat,
    stop_heartbeat,
)
from horovod_tpu_torch.elastic.state import ArrayState, ObjectState, State
from horovod_tpu_torch.exceptions import (
    HorovodInternalError,
    HostsUpdatedInterrupt,
    WorkerLostError,
    WorkersDownError,
    WorkerStallError,
)

__all__ = [
    "ArrayState", "ObjectState", "State",
    "run", "restarts", "Backoff",
    "start_heartbeat", "stop_heartbeat", "check_host_updates",
    "FaultSpec", "maybe_inject",
    "HorovodInternalError", "WorkersDownError", "WorkerLostError",
    "WorkerStallError", "HostsUpdatedInterrupt",
]
