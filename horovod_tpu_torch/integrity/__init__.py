"""Numerical integrity plane (port of ``horovod_tpu/integrity/``), off by
default and armed by ``HOROVOD_INTEGRITY``:

* :mod:`~horovod_tpu_torch.integrity.digest`: the runtime executor's
  payload digests (the input's non-finite count, CRC-32 of the reduced
  bytes) on every ``HOROVOD_INTEGRITY_INTERVAL``-th eligible dispatch, and
  the cross-rank vote that names the suspect rank;
* :mod:`~horovod_tpu_torch.integrity.guards`: the EWMA loss and grad-norm
  spike detection and the skip-step policy of ``DistributedOptimizer`` and
  ``training.make_train_step`` / ``make_train_round``;
* :mod:`~horovod_tpu_torch.integrity.rollback`: on a typed integrity
  failure, restore the last commit in place (the checkpoint cut first),
  optionally quarantine the voted-out rank, and replay within
  ``HOROVOD_ROLLBACK_BUDGET``;
* :mod:`~horovod_tpu_torch.integrity.inject`: the ``bitflip`` and ``nan``
  faults of ``HOROVOD_FAULT_INJECT`` that test the loop end to end.
"""

from __future__ import annotations

from horovod_tpu_torch.utils.env import (HOROVOD_INTEGRITY,
                                         HOROVOD_INTEGRITY_INTERVAL,
                                         _get_bool, _get_int)

# the digest cadence's default, in eligible dispatches
DEFAULT_INTEGRITY_INTERVAL = 32


def enabled() -> bool:
    """Whether the integrity plane is armed (read per call, as in the JAX
    package: tests and an elastic re-form rewrite the environment)."""
    return _get_bool(HOROVOD_INTEGRITY)


def interval() -> int:
    """The digest cadence in dispatches (<= 0: no digest)."""
    return _get_int(HOROVOD_INTEGRITY_INTERVAL, DEFAULT_INTEGRITY_INTERVAL)


# imported after the knob helpers they read: registers the
# horovod_integrity_* families on package import, so snapshots show zeros
# instead of no family
from horovod_tpu_torch.integrity import digest  # noqa: E402
from horovod_tpu_torch.integrity import guards  # noqa: E402
from horovod_tpu_torch.integrity import inject  # noqa: E402
from horovod_tpu_torch.integrity import rollback  # noqa: E402
from horovod_tpu_torch.integrity.guards import StepGuard  # noqa: E402,F401

__all__ = ["HOROVOD_INTEGRITY", "HOROVOD_INTEGRITY_INTERVAL",
           "DEFAULT_INTEGRITY_INTERVAL", "enabled", "interval", "digest",
           "guards", "inject", "rollback", "StepGuard"]
