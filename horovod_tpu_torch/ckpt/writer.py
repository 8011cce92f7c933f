"""Sharded two-phase checkpoint commits (port of
``horovod_tpu/ckpt/writer.py:78-630``).

Every rank serializes ONLY what it owns (its ZeRO shards, its round-robin
slice of the replicated state and, when the replica ring ran, its right
neighbour's bytes) into one shard container (:mod:`.manifest`). Commits
are crash-consistent by construction:

1. **stage**: write the container to a pid-named ``*.tmp`` in the
   checkpoint directory, fsync it, and announce ``staged.<rank>`` on the
   world's store under the prefix ``ckpt.g<generation>.s<step>``.
2. **barrier**: wait until all ``world`` ranks have staged. A timeout or a
   generation change abandons the commit: the tmp is unlinked and the
   previous manifest stays authoritative.
3. **publish**: fsync'd rename tmp -> final shard name, announce
   ``published.<rank>`` with the whole-file digest, and the leader (rank
   0), once every rank has published, atomically writes
   ``MANIFEST-<step>.json``: the commit point. A restore reads only files
   a manifest names, so a rank killed at any instant of this protocol
   leaves the newest published checkpoint intact.

The store is the c10d store the world was made from (``core/basics.py``:
a ``HashStore`` at world 1, the ``init_method``'s ``FileStore`` or
``TCPStore`` otherwise), the port's counterpart of the JAX package's
launcher KV. The barrier runs on the ``hvd-ckpt-writer`` thread and never
issues a collective: collectives belong to the training thread. A world
whose group ``init()`` did not create has no store here: the barrier is
skipped with a warning and the leader waits for the shard files instead
(the JAX package's shared-filesystem fallback).

**The snapshot.** A JAX array is never mutated, so the JAX writer can
serialize the caller's trees later. A torch tensor is: the flat AdamW
kernel writes master, mu and nu in place and ``DistributedOptimizer``
steps parameters in place. ``commit()`` therefore copies every tensor into
reusable host slabs (pinned for CUDA tensors; one a dtype, keyed by size
bucket and dtype as the fusion buffer keys its slabs), CUDA tensors with
``non_blocking`` copies on a copy stream that first waits for the current
stream; the current stream then waits for the copies' event, so no
in-place update that the caller enqueues after ``commit()`` returns can
reach a tensor before it is copied. Only the enqueue runs inline; the
writer thread waits for the event before it reads the slab. The slabs
are reused by later commits (:attr:`CheckpointManager.slab_allocations`
counts the allocations). ``copy=False`` hands CPU tensors to the writer as
they are, for a caller that promises never to mutate them: a tensor on
any other device raises, and a commit whose tensor changed before it was
written is abandoned.

Asynchrony: the handoff is a blocking one-slot queue (back-pressure, not
latest-wins: every rank must attempt the same steps or the barrier never
forms). A commit waits for that slot before its snapshot, so at most two
snapshots hold slabs (one being written, one queued) and a third reuses
the slabs the first gave back.
``HOROVOD_CKPT_FAULT=kill:rank=<r>:phase=<stage|barrier|publish>`` kills
the matching rank at that protocol point.

The observability planes: the inline seconds of ``commit()`` (the
snapshot's enqueue and the handoff, any wait for the slot included, not
the write) are the goodput ledger's ``ckpt_stall``; a published commit is
a ``ckpt_commit`` flight event, an abandoned one ``ckpt_commit_abandoned``,
and an injected kill ``ckpt_fault_kill`` with a failure dump first; the
host slabs are the memory ledger's ``ckpt_staging``.
"""

from __future__ import annotations

import json
import os
import pickle
import queue
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch import memory
from horovod_tpu_torch.ckpt import io as ckpt_io
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import replica as replica_mod
from horovod_tpu_torch.ckpt import stats
from horovod_tpu_torch.ckpt import tree as tree_mod
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.elastic import fault_inject
from horovod_tpu_torch.parallel import zero
from horovod_tpu_torch.runtime.fusion_buffer import bucket_elems
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import (
    HOROVOD_CKPT_ASYNC, HOROVOD_CKPT_BARRIER_TIMEOUT_SECONDS,
    HOROVOD_CKPT_FAULT, HOROVOD_CKPT_KEEP, _get_bool, _get_float, _get_int)

DEFAULT_KEEP = 2
DEFAULT_BARRIER_TIMEOUT = 30.0

_PHASES = ("stage", "barrier", "publish")


class FaultSpec(NamedTuple):
    rank: int
    phase: str
    step: Optional[int]
    code: int


def parse_fault(text: Optional[str]) -> Optional[FaultSpec]:
    """``kill:rank=<r>:phase=<stage|barrier|publish>[:step=<s>][:code=<c>]``:
    the commit-phase fault, keyed on the launch rank
    (``fault_inject.initial_rank``)."""
    text = (text or "").strip()
    if not text:
        return None
    parts = text.split(":")
    if parts[0] != "kill":
        raise ValueError(
            f"HOROVOD_CKPT_FAULT action must be 'kill', got {parts[0]!r}")
    fields: Dict[str, str] = {}
    for part in parts[1:]:
        k, _, v = part.partition("=")
        fields[k] = v
    if "rank" not in fields or "phase" not in fields:
        raise ValueError(
            f"HOROVOD_CKPT_FAULT needs rank= and phase= (got {text!r})")
    phase = fields["phase"]
    if phase not in _PHASES:
        raise ValueError(
            f"HOROVOD_CKPT_FAULT phase must be one of {_PHASES}, got "
            f"{phase!r}")
    return FaultSpec(rank=int(fields["rank"]), phase=phase,
                     step=int(fields["step"]) if "step" in fields else None,
                     code=int(fields.get("code", 1)))


# ---------------------------------------------------------------------------
# Snapshot plan: split the state trees into this rank's items
# ---------------------------------------------------------------------------

class _Item(NamedTuple):
    key: str
    kind: str                 # "array" | "object"
    role: str                 # manifest.ROLE_*
    value: Any
    replica_of: Optional[int]


def _expand_sharded(key: str, export: Dict[str, Any], role: str,
                    replica_of: Optional[int]) -> List[_Item]:
    """One exported sharded state -> flat subkey items (``{key}#master/
    <gi>``, ``{key}#leaf/<li>``, ...), the unit a shard file stores."""
    items: List[_Item] = []
    if export.get("kind") == "flat_adamw":
        items.append(_Item(f"{key}#count", "array", role, export["count"],
                           replica_of))
        for comp in ("master", "mu", "nu"):
            for gi, arr in enumerate(export[comp]):
                items.append(_Item(f"{key}#{comp}/{gi}", "array", role, arr,
                                   replica_of))
    else:
        for li, arr in enumerate(export["leaves"]):
            items.append(_Item(f"{key}#leaf/{li}", "array", role, arr,
                               replica_of))
    return items


def build_rank_payload(trees: Dict[str, Any], rank: int, world: int
                       ) -> Tuple[List[_Item], Dict[str, dict],
                                  Dict[str, Any]]:
    """Split the state trees into this rank's shard items.

    Returns ``(items, sharded_layout, exchange_entries)``:

    * a sharded leaf (``zero.is_sharded_state``) -> ``own`` subkey items
      plus a manifest layout record (world-size-change restore);
    * every other leaf is replicated state, round-robin owned: rank
      ``leaf_index % world`` writes it (role ``replicated``);
    * ``exchange_entries`` is what the neighbour-replica ring ships: the
      sharded exports by key, plus this rank's replicated slice under
      ``item:``-prefixed keys, so a lost rank's shard file is rebuilt from
      its left neighbour's.

    Leaves are keyed ``{tree}/{i}``: the trees by sorted name, each
    flattened in the JAX package's order (:mod:`.tree`). The values are
    the caller's own (device tensors included): ``commit`` copies them."""
    items: List[_Item] = []
    layout: Dict[str, dict] = {}
    exchange: Dict[str, Any] = {}
    index = 0
    for name in sorted(trees):
        tree = trees[name]
        if tree is None:
            continue
        flat, _ = tree_mod.flatten(tree, is_leaf=zero.is_sharded_state)
        for leaf in flat:
            i, index = index, index + 1
            key = f"{name}/{i}"
            if zero.is_sharded_state(leaf):
                export = zero.export_shard_arrays(leaf, to_host=False)
                layout[key] = zero.layout_of(leaf)
                items.extend(_expand_sharded(key, export, mf.ROLE_OWN, None))
                exchange[key] = export
            elif i % world == rank:
                kind = "array" if mf.is_array(leaf) else "object"
                items.append(_Item(key, kind, mf.ROLE_REPLICATED, leaf, None))
                exchange[f"item:{key}"] = {"kind": kind, "value": leaf}
    return items, layout, exchange


def _replica_items(src_rank: int, entries: Dict[str, Any]) -> List[_Item]:
    """The neighbour's exchanged entries -> ``replica`` role items."""
    items: List[_Item] = []
    for key in sorted(entries):
        payload = entries[key]
        if key.startswith("item:"):
            items.append(_Item(key[len("item:"):], payload["kind"],
                               mf.ROLE_REPLICA, payload["value"], src_rank))
        elif isinstance(payload, dict) and "kind" in payload:
            items.extend(_expand_sharded(key, payload, mf.ROLE_REPLICA,
                                         src_rank))
    return items


# ---------------------------------------------------------------------------
# Host slabs of the snapshot
# ---------------------------------------------------------------------------

# every live manager's slabs (weak: a closed manager's slabs just go away)
_slab_sets: "weakref.WeakSet" = weakref.WeakSet()


def staging_bytes() -> int:
    """Bytes of every live manager's host slabs: the memory ledger's
    ``ckpt_staging`` (reference: the ``ckpt_staging`` purpose of
    ``horovod_tpu/runtime/fusion_buffer.py:63-76``)."""
    return sum(s.bytes for s in list(_slab_sets))


class _HostSlabs:
    """Reusable host slabs, one per (size bucket, dtype, pinned) key, as
    ``runtime/fusion_buffer.py`` keys its slabs. A commit leases one slab
    a dtype and returns it once its file is written."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: Dict[tuple, List[torch.Tensor]] = {}  # guarded-by: _lock
        self.allocations = 0  # guarded-by: _lock
        self.bytes = 0        # guarded-by: _lock
        _slab_sets.add(self)
        memory.tracker().register("ckpt_staging", staging_bytes)

    def acquire(self, n: int, dtype: torch.dtype, pinned: bool):
        cap = bucket_elems(n, dtype.itemsize, zero._quantum_bytes())
        key = (cap, dtype, pinned)
        with self._lock:
            free = self._free.setdefault(key, [])
            if free:
                return key, free.pop()
            self.allocations += 1
            self.bytes += cap * dtype.itemsize
        return key, torch.empty(cap, dtype=dtype, pin_memory=pinned)

    def release(self, lease) -> None:
        key, slab = lease
        with self._lock:
            self._free.setdefault(key, []).append(slab)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


# ---------------------------------------------------------------------------
# Commit manager
# ---------------------------------------------------------------------------

class _Pending(NamedTuple):
    step: int
    generation: int
    rank: int
    world: int
    items: List[_Item]
    layout: Dict[str, dict]
    leases: List[Any]
    ready: Any        # the snapshot copies' CUDA event, or None
    versions: list    # (tensor, version) of copy=False tensors
    on_done: Any      # called once the commit is written or abandoned


class CheckpointManager:
    """Per-process commit pipeline: the inline host-slab snapshot, then the
    stage / barrier / publish protocol on the ``hvd-ckpt-writer`` thread."""

    def __init__(self, directory: str, *,
                 async_write: Optional[bool] = None,
                 keep: Optional[int] = None,
                 barrier_timeout: Optional[float] = None,
                 generation_fn=None):
        self.directory = directory
        self._async = (_get_bool(HOROVOD_CKPT_ASYNC, True)
                       if async_write is None else bool(async_write))
        self._keep = (keep if keep is not None
                      else _get_int(HOROVOD_CKPT_KEEP, DEFAULT_KEEP))
        self._barrier_timeout = (
            barrier_timeout if barrier_timeout is not None
            else _get_float(HOROVOD_CKPT_BARRIER_TIMEOUT_SECONDS,
                            DEFAULT_BARRIER_TIMEOUT))
        self._generation_fn = generation_fn or (lambda: 0)
        self._fault = parse_fault(os.environ.get(HOROVOD_CKPT_FAULT, ""))
        self._slabs = _HostSlabs()
        self._copy_stream = None
        # one-slot blocking handoff: commit() blocks while a prior write is
        # still queued (back-pressure keeps every rank on the same steps)
        self._queue: "queue.Queue[_Pending]" = queue.Queue(maxsize=1)
        # commits handed off and not yet written: the one being written and
        # the queued one. A commit takes its place before its snapshot.
        self._inflight = threading.BoundedSemaphore(2)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._published_steps: List[int] = []  # this rank's, oldest first
        self._warned_no_store = False
        #: the last published commit on this rank: step, bytes, seconds
        #: (written by the writer thread)
        self.last_commit: Optional[dict] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def slab_allocations(self) -> int:
        """Host slabs allocated so far (a commit whose dtypes and sizes an
        earlier one had allocates none)."""
        return self._slabs.allocations

    # -- training-thread side ---------------------------------------------

    def commit(self, trees: Dict[str, Any], step: int,
               generation: Optional[int] = None,
               rank: Optional[int] = None,
               world: Optional[int] = None,
               copy: bool = True, ready=None, on_done=None) -> None:
        """Snapshot ``trees`` (a dict of state trees: dicts, lists and
        tuples of tensors, numpy arrays, plain values and sharded ZeRO
        states) and hand them to the writer. Inline run only the snapshot's
        enqueue and the (possibly blocking) handoff; once this returns the
        caller may update its tensors in place.

        ``copy=False`` skips the snapshot: only for host tensors that the
        caller never mutates afterwards. A tensor on another device raises
        ``ValueError``; a commit whose tensor changed before the writer
        wrote it is abandoned (warning, counter). ``ready``: a CUDA event
        the writer waits for before it reads them (the caller's own copies
        to the host); ``on_done()`` runs on the writer's side once the
        commit is written or abandoned, when the caller may reuse them."""
        t0 = time.monotonic()
        if rank is None or world is None:
            st = basics._ensure_init()
            rank = st.rank if rank is None else rank
            world = st.size if world is None else world
        if generation is None:
            generation = self._generation_fn()
        items, layout, _exchange = build_rank_payload(trees, rank, world)
        versions, leases = [], []
        if self._async:
            self._ensure_thread()
            self._inflight.acquire()  # blocks while two are in flight
        try:
            if copy:
                items, leases, ready = self._snapshot(items)
            else:
                versions = self._check_host(items)
        except BaseException:
            if self._async:
                self._inflight.release()
            if on_done is not None:
                on_done()
            raise
        rep = replica_mod.export_store()
        if rep is not None and rep[1] == int(step):
            items = items + _replica_items(rep[0], rep[2])
        pending = _Pending(step=int(step), generation=int(generation),
                           rank=int(rank), world=int(world), items=items,
                           layout=layout, leases=leases, ready=ready,
                           versions=versions, on_done=on_done)
        if self._async:
            self._queue.put(pending)  # blocks when the slot is full
        else:
            self._write_commit(pending)
        stats.SNAPSHOT_SECONDS.observe(time.monotonic() - t0)
        # only the training thread's inline seconds are checkpoint badput
        goodput.record_span("ckpt_stall", time.monotonic() - t0)

    @staticmethod
    def _check_host(items: List[_Item]) -> list:
        versions = []
        for item in items:
            if isinstance(item.value, torch.Tensor):
                if item.value.device.type != "cpu":
                    raise ValueError(
                        f"commit(copy=False): leaf {item.key} is on "
                        f"{item.value.device}; copy=False takes host tensors "
                        "that are never mutated (copy=True snapshots device "
                        "tensors)")
                versions.append((item.value, item.value._version))
        return versions

    @torch.no_grad()
    def _snapshot(self, items: List[_Item]):
        """Copy array values into host slabs, one a dtype. The returned
        items view the slabs, so the caller's tensors may change the moment
        commit() returns; CUDA tensors are copied on the copy stream, which
        the current stream then waits for (the returned event marks the
        copies' end). Objects are copied by a pickle round trip."""
        by_dtype: Dict[torch.dtype, List[int]] = {}
        out = list(items)
        for idx, item in enumerate(items):
            if item.kind == "array":
                out[idx] = item._replace(value=_as_tensor(item.value))
                by_dtype.setdefault(out[idx].value.dtype, []).append(idx)
            else:
                out[idx] = item._replace(
                    value=pickle.loads(pickle.dumps(item.value)))
        cuda = [out[i].value for idxs in by_dtype.values() for i in idxs
                if out[i].value.is_cuda]
        stream = None
        if cuda:
            dev = cuda[0].device
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(dev))
        leases = []
        for dtype, idxs in by_dtype.items():
            srcs = [out[i].value for i in idxs]
            total = sum(s.numel() for s in srcs)
            pinned = any(s.is_cuda for s in srcs)
            lease = self._slabs.acquire(total, dtype, pinned)
            leases.append(lease)
            flat, off = lease[1], 0
            for i, src in zip(idxs, srcs):
                n = src.numel()
                dst = flat[off:off + n].view(src.shape)
                if src.is_cuda:
                    with torch.cuda.stream(stream):
                        dst.copy_(src, non_blocking=True)
                    src.record_stream(stream)
                else:
                    dst.copy_(src)
                out[i] = out[i]._replace(value=dst)
                off += n
        ready = None
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(stream)
            torch.cuda.current_stream(stream.device).wait_event(ready)
        return out, leases, ready

    def wait(self) -> None:
        """Block until every handed-off commit has been written (or
        abandoned)."""
        self._queue.join()

    def close(self) -> None:
        self.wait()
        self._closed = True
        self._slabs.clear()

    # -- writer thread -----------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, daemon=True, name="hvd-ckpt-writer")
            self._thread.start()

    def _writer_loop(self) -> None:
        while not self._closed:
            try:
                pending = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                self._write_commit(pending)
            except Exception as exc:
                stats.COMMITS_ABANDONED.inc()
                log.warning("checkpoint commit at step %s abandoned: %s",
                            pending.step, exc)
            finally:
                self._inflight.release()
                self._queue.task_done()

    def _maybe_fault(self, phase: str, step: int) -> None:
        spec = self._fault
        if spec is None or spec.phase != phase:
            return
        if spec.rank != fault_inject.initial_rank():
            return
        if spec.step is not None and spec.step != step:
            return
        log.error("ckpt fault injection: killing rank %d at commit phase %r "
                  "(step %d)", spec.rank, phase, step)
        flight_recorder.emit("ckpt_fault_kill", phase=phase, step=step,
                             rank=spec.rank)
        flight_recorder.dump_on_failure("ckpt_fault_kill")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(spec.code)

    def _write_commit(self, p: _Pending) -> bool:
        stats.COMMITS.inc()
        t0 = time.monotonic()
        tmp = None
        try:
            ckpt_io.clean_stale_tmps(self.directory)
            if p.ready is not None:
                p.ready.synchronize()
            entries = [
                (mf.array_entry if item.kind == "array" else mf.object_entry)(
                    item.key, item.value, role=item.role,
                    replica_of=item.replica_of)
                for item in p.items]
            final_name = mf.shard_name(p.step, p.rank, p.world)
            # -- stage ------------------------------------------------
            fd, tmp = ckpt_io.make_tmp(self.directory, base=final_name)
            with os.fdopen(fd, "wb") as f:
                nbytes, file_crc = mf.write_shard(f, entries, meta={
                    "step": p.step, "generation": p.generation,
                    "rank": p.rank, "world": p.world})
                f.flush()
                os.fsync(f.fileno())  # durable before it can be published
            del entries
            if any(t._version != v for t, v in p.versions):
                log.warning("checkpoint commit at step %d: a tensor handed "
                            "over with copy=False changed before it was "
                            "written", p.step)
                self._abandon(p, tmp, "stage")
                return False
            record = json.dumps({"rank": p.rank, "file": final_name,
                                 "bytes": nbytes, "crc": file_crc}).encode()
            self._maybe_fault("stage", p.step)
            store = self._barrier_store(p)
            if store is not None:
                store.set(f"staged.{p.rank}", record)
            self._maybe_fault("barrier", p.step)
            if not self._await_all(store, "staged", p):
                self._abandon(p, tmp, "barrier", store)
                return False
            # -- publish ----------------------------------------------
            os.replace(tmp, os.path.join(self.directory, final_name))
            tmp = None
            ckpt_io.fsync_dir(self.directory)
            self._maybe_fault("publish", p.step)
            if store is not None:
                store.set(f"published.{p.rank}", record)
            if p.rank == 0 and not self._publish_manifest(store, p, record):
                self._abandon(p, None, "publish", store)
                return False
            self._published_steps.append(p.step)
            self._gc(p)
            seconds = time.monotonic() - t0
            stats.BYTES.inc(nbytes)
            stats.COMMIT_SECONDS.observe(seconds)
            self.last_commit = {"step": p.step, "bytes": nbytes,
                                "seconds": seconds}
            flight_recorder.emit(
                "ckpt_commit", step=p.step, generation=p.generation,
                rank=p.rank, bytes=nbytes, seconds=round(seconds, 6))
            return True
        except Exception:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            raise
        finally:
            for lease in p.leases:
                self._slabs.release(lease)
            if p.on_done is not None:
                p.on_done()

    # -- protocol helpers --------------------------------------------------

    def _barrier_store(self, p: _Pending):
        """The world's store under ``ckpt.g<generation>.s<step>``, or None
        at world 1 and where the port did not make the world's group."""
        if p.world <= 1:
            return None
        store = state_mod.global_state().store
        if store is None:
            if not self._warned_no_store:
                self._warned_no_store = True
                log.warning(
                    "checkpointing in a %d-rank world whose process group "
                    "hvd.init() did not create: there is no store for the "
                    "commit barrier, which is skipped; restore-side "
                    "manifest verification is the only consistency net",
                    p.world)
            return None
        return dist.PrefixStore(f"ckpt.g{p.generation}.s{p.step}", store)

    def _await_all(self, store, prefix: str, p: _Pending) -> bool:
        """True once all ``world`` ranks announced ``<prefix>.<rank>``;
        False on timeout or a generation change (the commit must be
        abandoned)."""
        if store is None:
            return True
        keys = [f"{prefix}.{r}" for r in range(p.world)]
        deadline = time.monotonic() + self._barrier_timeout
        while True:
            if self._generation_fn() != p.generation:
                return False
            try:
                if store.check(keys):
                    return True
            except Exception:  # a store that went away: keep polling
                pass
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.1)

    def _abandon(self, p: _Pending, tmp: Optional[str], phase: str,
                 store=None) -> None:
        stats.COMMITS_ABANDONED.inc()
        if tmp is not None:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        if store is not None:  # a retry of this step must not meet them
            for key in (f"staged.{p.rank}", f"published.{p.rank}"):
                try:
                    store.delete_key(key)
                except Exception:
                    pass
        log.warning("checkpoint commit at step %d abandoned at the %s phase "
                    "(timeout %.1fs, generation %d); previous manifest stays "
                    "authoritative", p.step, phase, self._barrier_timeout,
                    p.generation)
        flight_recorder.emit("ckpt_commit_abandoned", step=p.step,
                             generation=p.generation, rank=p.rank,
                             phase=phase)

    def _publish_manifest(self, store, p: _Pending, own_record) -> bool:
        """Leader side of the publish phase: collect every rank's published
        shard record, then atomically write the manifest: THE commit
        point."""
        shards: List[dict] = []
        if store is not None:
            if not self._await_all(store, "published", p):
                return False
            for r in range(p.world):
                shards.append(json.loads(store.get(f"published.{r}")))
        elif p.world > 1:
            # no store: shared-filesystem fallback, wait for every final
            # shard file to appear, then digest them directly
            if not self._await_files(p):
                return False
            for r in range(p.world):
                path = os.path.join(self.directory,
                                    mf.shard_name(p.step, r, p.world))
                try:
                    with open(path, "rb") as f:
                        blob = f.read()
                except OSError as exc:
                    log.warning("ckpt publish: shard file %s unreadable "
                                "(%s); abandoning manifest", path, exc)
                    return False
                shards.append({"rank": r, "file": os.path.basename(path),
                               "bytes": len(blob),
                               "crc": ckpt_io.checksum(blob)})
        else:
            shards.append(json.loads(own_record))
        mf.write_manifest(self.directory, mf.build_manifest(
            p.step, p.generation, p.world, shards, p.layout))
        if store is not None:
            for r in range(p.world):
                for key in (f"staged.{r}", f"published.{r}"):
                    try:
                        store.delete_key(key)
                    except Exception:
                        pass  # best-effort: a later step uses other keys
        return True

    def _await_files(self, p: _Pending) -> bool:
        deadline = time.monotonic() + self._barrier_timeout
        want = [os.path.join(self.directory,
                             mf.shard_name(p.step, r, p.world))
                for r in range(p.world)]
        while True:
            if all(os.path.exists(w) for w in want):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.1)

    def _gc(self, p: _Pending) -> None:
        """Keep the last ``keep`` checkpoints. Every rank prunes its own
        old shard files (they may live on rank-local disks); the leader
        also prunes superseded manifests."""
        if self._keep <= 0:
            return
        drop_own = self._published_steps[:-self._keep]
        self._published_steps = self._published_steps[-self._keep:]
        for step in drop_own:
            try:
                os.unlink(os.path.join(self.directory,
                                       mf.shard_name(step, p.rank, p.world)))
            except OSError:
                pass
        if p.rank != 0:
            return
        for step in mf.all_steps(self.directory)[:-self._keep]:
            try:
                manifest = mf.load_manifest(self.directory, step)
                files = [rec["file"] for rec in manifest["shards"]]
            except Exception:
                files = []
            try:
                os.unlink(mf.manifest_path(self.directory, step))
            except OSError:
                pass
            for name in files:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass
