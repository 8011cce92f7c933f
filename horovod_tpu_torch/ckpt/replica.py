"""In-memory neighbour replication of ZeRO shards (port of
``horovod_tpu/ckpt/replica.py:48-144``).

At a commit each rank ships its sharded-leaf bytes (and its slice of the
replicated state) to its **left** neighbour, so rank ``i`` holds rank
``(i+1) % N``'s, and keeps the received copy in host memory. The
checkpoint writer adds them to its shard file as ``replica`` entries, so a
lost or damaged shard file restores from its left neighbour's; the elastic
re-form that reads them from memory comes with the elastic layer (ROADMAP
A1/A10).

The exchange is collective (two allgathers on the port's runtime, named
``ckpt_replica_len`` and ``ckpt_replica_payload`` as in the JAX package, so
the response cache answers them from the second commit), so it runs on the
training thread, before ``CheckpointManager.commit`` of the same step. The
store's reads are local. ``HOROVOD_CKPT_REPLICATION=0`` turns it off.
Clearing a store that held a copy, with a reason, is a
``ckpt_replica_clear`` flight event.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import HOROVOD_CKPT_REPLICATION, _get_bool

_lock = threading.Lock()
# {key: exported-shard-arrays} received from the right neighbour, plus the
# tags that validate a later lookup
_entries: Dict[str, Any] = {}  # guarded-by: _lock
_src_rank: int = -1            # guarded-by: _lock
_step: int = -1                # guarded-by: _lock


def enabled() -> bool:
    """On by default in a world of >= 2 ranks; meaningless at world 1
    (every shard already lives in this process)."""
    if not _get_bool(HOROVOD_CKPT_REPLICATION, True):
        return False
    st = state_mod.global_state()
    return st.initialized and st.size >= 2


def _to_host(x):
    """Tensors of the entries (nested dicts and lists) copied to the host,
    so the pickled payload holds no device tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def exchange(entries: Dict[str, Any], step: int) -> None:
    """Ring-shift the local payloads one rank to the LEFT: after this
    call, rank ``i`` holds rank ``(i+1) % N``'s ``entries``.

    Collective: every rank calls it with the same key set in the same
    commit. On success the store advances to ``step``; on any failure it
    keeps the previous commit's."""
    st = basics._ensure_init()
    blob = pickle.dumps({"rank": st.rank, "step": int(step),
                         "entries": _to_host(entries)})
    dev = st.device
    local = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(dev)
    lens = collectives.allgather(
        torch.tensor([local.numel()], dtype=torch.int64, device=dev),
        name="ckpt_replica_len").cpu()
    cat = collectives.allgather(local, name="ckpt_replica_payload")
    neighbor = (st.rank + 1) % st.size
    off = int(lens[:neighbor].sum())
    received = pickle.loads(
        cat[off:off + int(lens[neighbor])].cpu().numpy().tobytes())
    if received["rank"] != neighbor or received["step"] != int(step):
        log.warning(
            "ckpt replica exchange: unexpected payload from neighbor (rank "
            "%s step %s, wanted rank %s step %s) — keeping the previous "
            "replica", received["rank"], received["step"], neighbor, step)
        return
    global _entries, _src_rank, _step
    with _lock:
        _entries = received["entries"]
        _src_rank = neighbor
        _step = int(step)


def lookup(key: str, step: Optional[int] = None
           ) -> Optional[Tuple[int, Any]]:
    """(source_rank, exported arrays) for ``key`` if this rank holds a
    replica from commit ``step`` (any step when ``step`` is None)."""
    with _lock:
        if key not in _entries:
            return None
        if step is not None and _step != int(step):
            return None
        return _src_rank, _entries[key]


def holdings() -> Tuple[int, int, Tuple[str, ...]]:
    """(source_rank, step, keys)."""
    with _lock:
        return _src_rank, _step, tuple(_entries)


def export_store() -> Optional[Tuple[int, int, Dict[str, Any]]]:
    """Snapshot ``(source_rank, step, entries)`` for the checkpoint writer,
    or None when empty. The received values are never mutated, so the
    writer thread may read them while training goes on."""
    with _lock:
        if not _entries:
            return None
        return _src_rank, _step, dict(_entries)


def clear(reason: str = "") -> None:
    """Drop the store (after a re-form, whose ranks make the old tags
    meaningless, and at shutdown)."""
    global _entries, _src_rank, _step
    with _lock:
        had = bool(_entries)
        _entries, _src_rank, _step = {}, -1, -1
    if had and reason:
        log.debug("ckpt replica store cleared: %s", reason)
        flight_recorder.emit("ckpt_replica_clear", reason=reason)
