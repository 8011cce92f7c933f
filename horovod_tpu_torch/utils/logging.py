"""Leveled, rank-prefixed logging (port of ``horovod_tpu/utils/logging.py``).
Level and time display follow ``HOROVOD_LOG_LEVEL`` and
``HOROVOD_LOG_HIDE_TIME``, as in the reference."""

from __future__ import annotations

import logging
import os
import sys
import threading

from horovod_tpu_torch.utils import env

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_lock = threading.Lock()
_logger: logging.Logger | None = None


class _RankFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        from horovod_tpu_torch.core import state

        st = state.global_state()
        record.hvd_rank = st.rank if st.initialized else -1
        return True


def get_logger() -> logging.Logger:
    global _logger
    with _lock:
        if _logger is None:
            logger = logging.getLogger("horovod_tpu_torch")
            level = os.environ.get(env.HOROVOD_LOG_LEVEL, "warning")
            logger.setLevel(_LEVELS.get(level.strip().lower(),
                                        logging.WARNING))
            handler = logging.StreamHandler(sys.stderr)
            fmt = "[%(hvd_rank)s]<%(levelname)s> %(message)s"
            if not env._get_bool(env.HOROVOD_LOG_HIDE_TIME):
                fmt = "%(asctime)s " + fmt
            handler.setFormatter(logging.Formatter(fmt))
            handler.addFilter(_RankFilter())
            logger.addHandler(handler)
            logger.propagate = False
            _logger = logger
        return _logger


def debug(msg: str, *args) -> None:
    get_logger().debug(msg, *args)
