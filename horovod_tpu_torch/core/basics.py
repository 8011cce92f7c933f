"""Lifecycle and topology: init / shutdown / rank / size / ...

Port of ``horovod_tpu/core/basics.py`` onto ``torch.distributed``. The
worker model is the reference Horovod's: one process per device, so
``rank``/``size`` are process ranks. Topology comes from the launcher's
environment contract (``HOROVOD_RANK``/``SIZE``/``LOCAL_*``/``CROSS_*``);
the JAX package's device mesh (``core/mesh.py``) has no counterpart.

``init()`` brings up a process group: NCCL for a CUDA device, gloo for the
CPU. A one-process world still gets a group (over an in-memory
``HashStore``), so the data-parallel path issues its collectives at size 1,
as the JAX package runs them on a one-device mesh. A larger world meets at
``HOROVOD_COORDINATOR_ADDR``: ``host:port`` (TCP) or a ``tcp://`` or
``file://`` URL.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.exceptions import NotInitializedError
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils import logging as log


def _ensure_init() -> state_mod.GlobalState:
    st = state_mod.global_state()
    if not st.initialized:
        raise NotInitializedError()
    return st


def _init_method(size: int) -> Optional[str]:
    addr = os.environ.get(env.HOROVOD_COORDINATOR_ADDR, "")
    if not addr:
        if size > 1:
            raise ValueError(
                f"HOROVOD_SIZE={size} needs HOROVOD_COORDINATOR_ADDR "
                "(host:port, tcp://host:port or file:///path)")
        return None
    return addr if "://" in addr else f"tcp://{addr}"


def init(device: Union[str, torch.device, None] = None) -> None:
    """Join the world and pick this process's device.

    ``device=None`` takes ``cuda:<local_rank>`` and raises when no CUDA
    device is visible; pass ``device="cpu"`` to run on the CPU (gloo). A
    second call while initialized is a no-op."""
    st = state_mod.global_state()
    with st.lock:
        if st.initialized:
            return
        rank = env._get_int(env.HOROVOD_RANK, 0)
        size = env._get_int(env.HOROVOD_SIZE, 1)
        local_size = env._get_int(env.HOROVOD_LOCAL_SIZE, size)
        local_rank = env._get_int(env.HOROVOD_LOCAL_RANK, rank % local_size)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "hvd.init(): no CUDA device is visible; pass "
                    "device='cpu' to run on the CPU")
            device = torch.device("cuda", local_rank)
        device = torch.device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
            backend = "nccl"
        elif device.type == "cpu":
            backend = "gloo"
        else:
            raise ValueError(f"hvd.init(): unsupported device {device}")

        owns_group = not dist.is_initialized()
        if owns_group:
            method = _init_method(size)
            if method is None:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            else:
                dist.init_process_group(backend, init_method=method,
                                        rank=rank, world_size=size)
        else:
            rank, size = dist.get_rank(), dist.get_world_size()

        st.rank, st.size = rank, size
        st.local_rank, st.local_size = local_rank, local_size
        st.cross_size = env._get_int(env.HOROVOD_CROSS_SIZE,
                                     max(1, size // max(local_size, 1)))
        st.cross_rank = env._get_int(env.HOROVOD_CROSS_RANK,
                                     rank // max(local_size, 1))
        st.device, st.owns_group = device, owns_group
        st.initialized = True
        log.debug("initialized: size=%d rank=%d device=%s", size, rank,
                  device)


def shutdown() -> None:
    """Leave the world; safe to call twice or before ``init()``."""
    st = state_mod.global_state()
    with st.lock:
        if not st.initialized:
            return
        if st.owns_group and dist.is_initialized():
            dist.destroy_process_group()
    state_mod.reset()


atexit.register(shutdown)  # reference: horovod/common/basics.py:40


def is_initialized() -> bool:
    return state_mod.global_state().initialized


def rank() -> int:
    return _ensure_init().rank


def size() -> int:
    return _ensure_init().size


def local_rank() -> int:
    return _ensure_init().local_rank


def local_size() -> int:
    return _ensure_init().local_size


def cross_rank() -> int:
    return _ensure_init().cross_rank


def cross_size() -> int:
    return _ensure_init().cross_size


def device() -> torch.device:
    """The device this process drives."""
    return _ensure_init().device


def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()
