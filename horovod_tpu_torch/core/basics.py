"""Lifecycle and topology: init / shutdown / rank / size / ...

Port of ``horovod_tpu/core/basics.py`` onto ``torch.distributed``. The
worker model is the reference Horovod's: one process per device, so
``rank``/``size`` are process ranks. Topology comes from the launcher's
environment contract (``HOROVOD_RANK``/``SIZE``/``LOCAL_*``/``CROSS_*``);
the JAX package's device mesh (``core/mesh.py``, ``mesh()``) has no
counterpart: PyTorch has no device mesh of that kind.

``init()`` brings up a process group: NCCL for a CUDA device, gloo for the
CPU. A one-process world still gets a group (over an in-memory
``HashStore``), so the data-parallel path issues its collectives at size 1,
as the JAX package runs them on a one-device mesh. A larger world meets at
``HOROVOD_COORDINATOR_ADDR``: ``host:port`` (TCP) or a ``tcp://`` or
``file://`` URL.

``init()`` also creates the enqueue runtime's two groups, in the same order
on every rank: the control group (gloo, for negotiation) and the data group
(the collectives: NCCL on the card, gloo on the CPU). Its own groups keep
the runtime's calls apart from any a user makes on the default group. The
runtime itself starts at the first enqueue; ``shutdown()`` stops it before
it destroys the groups.

``init()`` parses the runtime's knobs once (``utils.env.Config``) and, when
``HOROVOD_METRICS_PORT`` is set, serves the metrics registry over HTTP;
``shutdown()`` stops the endpoint and, when ``HOROVOD_METRICS_DUMP`` is
set, writes this rank's snapshot there. ``metrics()`` is the snapshot, at
any time. Without those knobs no thread and no socket exist for metrics.

``init()`` configures the step profiler (``profiler.py``) with this rank
and device; ``shutdown()`` closes its open step and writes its dump
(``HOROVOD_PROFILE_DIR``). Without ``HOROVOD_PROFILE`` or a profile dir it
records nothing and writes nothing.
"""

from __future__ import annotations

import atexit
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch import profiler
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.exceptions import NotInitializedError
from horovod_tpu_torch.metrics import registry as metrics_registry
from horovod_tpu_torch.runtime import types as runtime_types
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
        st.config = env.Config.from_env()
        st.control_group = dist.new_group(backend="gloo")
        st.data_group = dist.new_group(backend=backend)
        runtime_types.COUNTS["groups"] += 2
        st.initialized = True
        log.debug("initialized: size=%d rank=%d device=%s", size, rank,
                  device)
        if st.config.metrics_port is not None:
            port = metrics_registry().serve(st.config.metrics_port)
            log.debug("metrics endpoint serving on port %d", port)
        profiler.configure(rank=rank, device=device, config=st.config)


def shutdown() -> None:
    """Leave the world; safe to call twice or before ``init()``."""
    st = state_mod.global_state()
    with st.lock:
        if not st.initialized:
            return
        if st.runtime is not None:
            st.runtime.stop()
        profiler.finalize()
        reg = metrics_registry()
        reg.stop_server()
        if st.config.metrics_dump:
            try:
                reg.dump(st.config.metrics_dump, rank=st.rank)
            except OSError as exc:
                log.warning("could not write metrics dump: %s", exc)
        if dist.is_initialized():
            if st.owns_group:
                dist.destroy_process_group()
            else:
                for group in (st.data_group, st.control_group):
                    dist.destroy_process_group(group)
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


def metrics() -> dict:
    """The process-wide metrics registry's snapshot, a nested
    JSON-serializable dict: cycles and their duration, queue depth, cache
    hits and misses, fusion bytes and fill, each op's latency and bytes,
    stall and timeline counters (``metrics.py``). Works before ``init()``
    too; the counters move once the runtime runs."""
    return metrics_registry().snapshot()


def is_homogeneous() -> bool:
    """True when every process owns the same number of devices
    (``horovod_tpu/core/basics.py:332``): always, since each process
    drives one device."""
    _ensure_init()
    return True


# Capability probes with the JAX package's names and signatures
# (``horovod_tpu/core/basics.py:341-362``), true of this port: its
# transports are NCCL (the card) and gloo (the CPU and the control plane),
# with no MPI and no XLA.
def mpi_built() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def xla_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def mpi_threads_supported() -> bool:
    return False
