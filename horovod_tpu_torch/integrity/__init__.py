"""Numerical integrity plane: the step guard (port of
``horovod_tpu/integrity/``, the part the training step runs).

:mod:`~horovod_tpu_torch.integrity.guards` holds the EWMA loss and
grad-norm spike detection and the skip-step policy hooked into
``DistributedOptimizer`` and ``training.make_train_step`` /
``make_train_round``. It is off by default and armed by
``HOROVOD_INTEGRITY``.

Not ported yet (ROADMAP A10): the per-bucket collective digests and their
cross-rank vote (``digest.py``), with ``interval()`` and
``HOROVOD_INTEGRITY_INTERVAL``; the silent-corruption fault injection
(``inject.py``); and the rollback-and-replay onto the last checkpoint
(``rollback.py``), which needs checkpoints and the elastic runner.
"""

from __future__ import annotations

from horovod_tpu_torch.utils.env import HOROVOD_INTEGRITY, _get_bool


def enabled() -> bool:
    """Whether the integrity plane is armed (read per call, as in the JAX
    package: tests and an elastic re-form rewrite the environment)."""
    return _get_bool(HOROVOD_INTEGRITY)


# imported after enabled(): registers horovod_integrity_skipped_steps_total
# on package import, so snapshots show a zero instead of no family
from horovod_tpu_torch.integrity import guards  # noqa: E402
from horovod_tpu_torch.integrity.guards import StepGuard  # noqa: E402,F401

__all__ = ["HOROVOD_INTEGRITY", "enabled", "guards", "StepGuard"]
