"""Typed failures of the port (port of ``horovod_tpu/exceptions.py``, the
part this slice raises)."""

from __future__ import annotations


class HorovodInternalError(RuntimeError):
    """Internal framework failure surfaced to a caller (reference:
    horovod/common/exceptions.py HorovodInternalError)."""


class NotInitializedError(HorovodInternalError):
    """The API was used before ``init()`` or after ``shutdown()``."""

    def __init__(self) -> None:
        # reference error text: horovod/common/operations.cc NOT_INITIALIZED
        super().__init__(
            "horovod_tpu_torch has not been initialized; use hvd.init().")
