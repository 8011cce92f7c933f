"""Typed failures of the port (port of ``horovod_tpu/exceptions.py``, the
part the port raises)."""

from __future__ import annotations

from typing import Optional


class HorovodInternalError(RuntimeError):
    """Internal framework failure surfaced to a caller (reference:
    horovod/common/exceptions.py HorovodInternalError)."""


class NotInitializedError(HorovodInternalError):
    """The API was used before ``init()`` or after ``shutdown()``."""

    def __init__(self) -> None:
        # reference error text: horovod/common/operations.cc NOT_INITIALIZED
        super().__init__(
            "horovod_tpu_torch has not been initialized; use hvd.init().")


class NumericalError(HorovodInternalError):
    """A payload or training statistic went numerically bad: the step
    guard's spike budget was exhausted (``integrity/guards.py``).
    Deliberately not a worker-loss error: no worker is down, and the JAX
    package's elastic runner answers it by rolling back and replaying."""

    def __init__(self, message: str, bucket: Optional[str] = None,
                 tensor: Optional[str] = None,
                 suspect_rank: Optional[int] = None) -> None:
        super().__init__(message)
        #: fusion bucket / lane the bad payload traveled in, when known
        self.bucket = bucket
        #: tensor (or statistic) name carrying non-finite values
        self.tensor = tensor
        #: rank whose local payload was non-finite, when attributable
        self.suspect_rank = suspect_rank


class CheckpointCorruptError(HorovodInternalError):
    """A checkpoint failed its integrity check on restore: a truncated
    shard, a CRC mismatch on a leaf, or an unparseable container. Carries
    the offending file and (when the damage is attributable) the leaf
    path, so the operator knows whether to distrust one tensor or the
    whole file (``horovod_tpu/exceptions.py:48-60``)."""

    def __init__(self, message: str, path: Optional[str] = None,
                 leaf: Optional[str] = None) -> None:
        super().__init__(message)
        #: filesystem path of the damaged checkpoint file
        self.path = path
        #: leaf key whose bytes failed verification, when known
        self.leaf = leaf
