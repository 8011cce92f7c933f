"""Typed failures of the port (port of ``horovod_tpu/exceptions.py``).

Everything but :class:`HostsUpdatedInterrupt` subclasses
:class:`RuntimeError`, so callers that catch ``RuntimeError`` around a
collective keep working; ``@hvd.elastic.run`` catches the narrower
:class:`WorkersDownError` and re-forms the world, and
:class:`NumericalError` and rolls back in place.
"""

from __future__ import annotations

from typing import Optional, Sequence


class HorovodInternalError(RuntimeError):
    """Internal framework failure surfaced to a caller (reference:
    horovod/common/exceptions.py HorovodInternalError)."""


class NotInitializedError(HorovodInternalError):
    """The API was used before ``init()`` or after ``shutdown()``."""

    def __init__(self) -> None:
        # reference error text: horovod/common/operations.cc NOT_INITIALIZED
        super().__init__(
            "horovod_tpu_torch has not been initialized; use hvd.init().")


class WorkersDownError(HorovodInternalError):
    """One or more workers left the job (died, hung past a deadline, or
    closed their transport). Recoverable under ``@hvd.elastic.run``: the
    survivors re-form and resume from the last commit."""

    def __init__(self, message: str,
                 ranks: Optional[Sequence[int]] = None) -> None:
        super().__init__(message)
        #: ranks believed down, when the failure path could tell; else ()
        self.ranks = tuple(ranks or ())


class WorkerLostError(WorkersDownError):
    """A peer's transport died mid-collective: the gloo control group's
    connection closed or reset, or its operation timed out."""


class WorkerStallError(WorkersDownError):
    """Some ranks stopped announcing tensors past a deadline (the stall
    inspector's shutdown time under ``HOROVOD_ELASTIC``, or
    ``HOROVOD_COLLECTIVE_TIMEOUT``): treated as down, so the elastic
    layer evicts them and goes on."""


class NumericalError(HorovodInternalError):
    """A payload or training statistic went numerically bad: non-finite
    values entered a collective (``integrity/digest.py``), or the step
    guard's spike budget was exhausted (``integrity/guards.py``).
    Deliberately not a :class:`WorkersDownError`: no worker is down, and
    the elastic runner answers it by rolling back and replaying."""

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


class CollectiveIntegrityError(NumericalError):
    """Cross-rank digest disagreement on a collective's result: the
    replicated output differs between ranks (silent data corruption).
    ``suspect_rank`` is the digest vote's minority rank, when there is
    one."""


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


class OrderedLaneError(RuntimeError):
    """A collective was about to be issued from a caller's thread while the
    runtime still held named collectives in flight (the JAX package's
    ``horovod_tpu/ops/collectives.py:72-86``). The runtime's cycle thread
    is the one ordered issuer of the named ops; a collective of the
    caller's own on a group that the runtime also uses, issued meanwhile,
    can take another place in the order on each rank: a hang or garbage.
    Synchronize the outstanding handles first."""


class HostsUpdatedInterrupt(Exception):
    """The elastic driver announced a host-set change (reference:
    horovod/common/exceptions.py HostsUpdatedInterrupt). Not an error: it
    stands outside the ``RuntimeError`` family, so no generic handler
    swallows it; ``@hvd.elastic.run`` catches it at the commit that saw
    the notice and re-forms the world without a rollback."""

    def __init__(self, message: str = "host set updated") -> None:
        super().__init__(message)
