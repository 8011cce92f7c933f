"""Elastic training state: commit, restore, sync (port of
``horovod_tpu/elastic/state.py:81-404``; reference: horovod/common/
elastic.py ``State``, horovod/torch/elastic/state.py ``TorchState``).

The training loop keeps what it must not lose (the model's parameters, the
optimizer state, the step) in a :class:`State`. ``commit()`` fires the
fault hook (``HOROVOD_FAULT_INJECT``), ships the ZeRO shards to the left
neighbour (``ckpt.replica``), snapshots the values, hands the snapshot to
the sharded checkpoint writer when a checkpoint directory is set
(``ckpt_dir`` or ``HOROVOD_CKPT_DIR``; else to the rank-0 spill of
``spill_dir`` / ``HOROVOD_ELASTIC_SPILL_DIR``, asynchronous unless
``HOROVOD_ELASTIC_SPILL_SYNC``), and raises
:class:`~horovod_tpu_torch.exceptions.HostsUpdatedInterrupt` when the
elastic driver announced a host change. After a failure the runner calls
``on_reset()`` (restore the last snapshot, then the reset callbacks) and
``sync()`` (make the new rank 0's values everyone's).

**Snapshots of tensors that change in place.** A JAX array is never
mutated, so the JAX package's snapshot is a host copy it hands the writer
as is. A torch tensor is: the flat AdamW kernel updates master, mu and nu
in place, and the optimizers step parameters in place. So
:class:`ArrayState` copies every tensor into reused host slabs (pinned for
CUDA tensors; one a dtype), two sets of them used in turn: the checkpoint
writer (``CheckpointManager(copy=False)``) writes one set while the next
commit fills the other, and a commit waits until the writer has let go of
the set it is about to fill, so no snapshot the writer holds is ever
written to. CUDA tensors are copied on a copy stream that first waits for
the current stream; the current stream then waits for the copies, and the
writer (and a restore) for their event. After the first two snapshots (the
constructor's and the first commit's) no commit allocates.

A commit is a ``state_commit`` flight event and the goodput ledger's
committed-step boundary (``goodput.record_step``: the gap since the last
accounted step, less the badput spans inside it, is productive; the
ledger's frontier keeps a profiled step from counting twice); a restore is
``state_restore`` and a checkpoint load ``ckpt_state_loaded``.

Not ported: the lock witness (ROADMAP A14).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import goodput
from horovod_tpu_torch.ckpt import tree as tree_mod
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.elastic import fault_inject
from horovod_tpu_torch.metrics import COMMIT_BUCKETS, registry as _metrics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel import zero
from horovod_tpu_torch.runtime.fusion_buffer import bucket_elems
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import (HOROVOD_CKPT_DIR,
                                         HOROVOD_ELASTIC_SPILL_DIR,
                                         HOROVOD_ELASTIC_SPILL_SYNC,
                                         _get_bool)

_COMMITS = _metrics().counter(
    "horovod_elastic_commits_total",
    "State.commit() snapshots taken (per process).")
_COMMIT_DURATION = _metrics().histogram(
    "horovod_elastic_commit_duration_seconds",
    "Wall time of one State.commit() (snapshot; excludes the async "
    "spill, which runs off-thread).", buckets=COMMIT_BUCKETS)


class State:
    """Base elastic state (reference: horovod/common/elastic.py State).

    Subclasses implement ``save``, ``restore_snapshot`` and ``sync``;
    ``commit()`` wraps ``save`` with the fault hook, the replica exchange,
    the metrics, the checkpoint or the spill, and the host-change check."""

    def __init__(self, spill_dir: Optional[str] = None,
                 ckpt_dir: Optional[str] = None):
        self._spill_dir = spill_dir or os.environ.get(
            HOROVOD_ELASTIC_SPILL_DIR, "")
        self._spill_sync = _get_bool(HOROVOD_ELASTIC_SPILL_SYNC)
        self._spill_lock = threading.Lock()
        self._spill_next: Optional[tuple] = None  # guarded-by: _spill_lock
        self._spill_thread: Optional[threading.Thread] = None  # guarded-by: _spill_lock
        self._reset_callbacks: list = []
        self._ckpt_dir = ckpt_dir or os.environ.get(HOROVOD_CKPT_DIR, "")
        self._ckpt = None  # CheckpointManager, made at the first commit
        #: seconds of the last commit (the snapshot's enqueue and hand-off)
        self.last_commit_seconds = 0.0

    # -- subclass surface --------------------------------------------------
    def save(self) -> None:
        """Snapshot the current values."""
        raise NotImplementedError

    def restore_snapshot(self) -> None:
        """Roll the values back to the last snapshot (process-local)."""
        raise NotImplementedError

    def sync(self, root_rank: int = 0) -> None:
        """Make ``root_rank``'s values everyone's."""
        raise NotImplementedError

    def _spill_payload(self):
        """(trees, step) to write at a commit, or None."""
        return None

    def _exchange_replicas(self, step: int) -> None:
        """Ship this rank's ZeRO shards to its left neighbour before the
        snapshot, so the replica and the snapshot advance together. Base
        states hold no sharded leaves; ArrayState overrides."""

    def _snapshot_ready(self):
        """The CUDA event the last snapshot's copies end at, or None."""
        return None

    def _snapshot_released(self):
        """A callable the writer calls once it has written the last
        snapshot, or None."""
        return None

    # -- public API (reference names: commit / restore / on_reset) --------
    def commit(self) -> None:
        step = int(getattr(self, "step", 0))
        from horovod_tpu_torch.elastic import runner as _runner

        fault_inject.maybe_inject(step, generation=_runner.restarts())
        t0 = time.monotonic()
        self._exchange_replicas(step)
        self.save()
        flight_recorder.emit("state_commit", step=step,
                             seconds=round(time.monotonic() - t0, 6))
        # the committed-step boundary of the goodput ledger
        goodput.record_step(step=step)
        if self._ckpt_dir:
            self._ckpt_commit(step, _runner.restarts())
        elif self._spill_dir:
            payload = self._spill_payload()
            if payload is not None:
                self._spill(payload[0], payload[1])
        self.last_commit_seconds = time.monotonic() - t0
        _COMMITS.inc()
        _COMMIT_DURATION.observe(self.last_commit_seconds)
        # the one boundary where a re-form is safe: a driver notice raises
        # HostsUpdatedInterrupt here, after the snapshot
        _runner.check_host_updates()

    def _ckpt_commit(self, step: int, generation: int) -> None:
        """Hand the snapshot to the sharded two-phase writer
        (:class:`horovod_tpu_torch.ckpt.CheckpointManager`), uncopied."""
        payload = self._spill_payload()
        if payload is None:
            return
        if self._ckpt is None:
            from horovod_tpu_torch import ckpt
            from horovod_tpu_torch.elastic import runner as _runner

            self._ckpt = ckpt.CheckpointManager(
                self._ckpt_dir, generation_fn=_runner.restarts)
        self._ckpt.commit(payload[0], payload[1], generation=generation,
                          copy=False, ready=self._snapshot_ready(),
                          on_done=self._snapshot_released())

    def checkpoint_wait(self) -> None:
        """Block until every commit handed to the writer is written (or
        abandoned)."""
        if self._ckpt is not None:
            self._ckpt.wait()

    def restore(self) -> None:
        self.restore_snapshot()
        flight_recorder.emit("state_restore",
                             step=int(getattr(self, "step", 0)))

    def register_reset_callbacks(self, callbacks) -> None:
        """Callables run after a re-form (reference: horovod/common/
        elastic.py register_reset_callbacks): rebuild what depends on the
        world size (learning-rate schedules, data shards)."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self) -> None:
        self.restore()
        for cb in self._reset_callbacks:
            cb()

    # -- async spill -------------------------------------------------------
    def _spill(self, tree, step: int) -> None:
        from horovod_tpu_torch import checkpoint

        if self._spill_sync:
            checkpoint.save(self._spill_dir, tree, step=step)
            return
        with self._spill_lock:
            # latest wins: a slow disk must not queue snapshots unbounded
            self._spill_next = (tree, step)
            if self._spill_thread is None or not self._spill_thread.is_alive():
                self._spill_thread = threading.Thread(
                    target=self._spill_loop, daemon=True,
                    name="hvd-elastic-spill")
                self._spill_thread.start()

    def _spill_loop(self) -> None:
        from horovod_tpu_torch import checkpoint

        while True:
            with self._spill_lock:
                item, self._spill_next = self._spill_next, None
                if item is None:
                    return
            try:
                checkpoint.save(self._spill_dir, item[0], step=item[1])
            except Exception as exc:
                log.warning("elastic spill to %s failed: %s",
                            self._spill_dir, exc)


class ObjectState(State):
    """Picklable-attribute state (reference: horovod/common/elastic.py
    ObjectState): every keyword becomes an attribute; a commit snapshots
    them by value; ``sync`` sends rank ``root_rank``'s."""

    _INTERNAL = ("_spill_dir", "_spill_sync", "_spill_lock", "_spill_next",
                 "_spill_thread", "_reset_callbacks", "_saved",
                 "_ckpt_dir", "_ckpt", "last_commit_seconds")

    def __init__(self, spill_dir: Optional[str] = None, **kwargs):
        super().__init__(spill_dir=spill_dir)
        self._saved: Dict[str, bytes] = {}
        for key, value in kwargs.items():
            setattr(self, key, value)
        self.save()

    def _public_attrs(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if k not in self._INTERNAL}

    def save(self) -> None:
        # a pickle round trip: a by-value snapshot of any object
        self._saved = {k: pickle.dumps(v)
                       for k, v in self._public_attrs().items()}

    def restore_snapshot(self) -> None:
        for key, blob in self._saved.items():
            setattr(self, key, pickle.loads(blob))

    def sync(self, root_rank: int = 0) -> None:
        synced = collectives.broadcast_object(self._public_attrs(), root_rank)
        for key, value in synced.items():
            setattr(self, key, value)
        self.save()


# ---------------------------------------------------------------------------
# ArrayState's snapshot
# ---------------------------------------------------------------------------

def _is_unit(x) -> bool:
    """Leaves the snapshot takes whole: a module (its parameters), a
    stage-3 parameter shard set, a generic ZeRO state (its inner
    optimizer's shards and state)."""
    return isinstance(x, (torch.nn.Module, zero.ShardedParams,
                          zero.ShardedOptState))


def _unit_tensors(x) -> List[torch.Tensor]:
    """The live tensors of a unit, in a fixed order."""
    if isinstance(x, torch.nn.Module):
        return [p.data for _, p in x.named_parameters()]
    if isinstance(x, zero.ShardedParams):
        return list(x.shards)
    return list(zero.export_shard_arrays(x, to_host=False)["leaves"])


def _view(tree):
    """The tree the checkpoint layer and the collectives see: a module's
    named parameters as a dict, everything else as it is."""
    if isinstance(tree, torch.nn.Module):
        return dict(tree.named_parameters())
    return tree


class _Slabs:
    """One set of host slabs, one a (dtype, pinned) key, grown on demand,
    with the event of the device copies into it and whether the
    checkpoint writer holds it."""

    def __init__(self) -> None:
        self.flat: Dict[tuple, torch.Tensor] = {}
        self.ready: Optional[torch.cuda.Event] = None
        self.free = threading.Event()
        self.free.set()


class _Snapshot:
    """Two :class:`_Slabs` sets used in turn, and the snapshot trees that
    view the last one filled."""

    def __init__(self) -> None:
        self.sets = [_Slabs(), _Slabs()]
        self.next = 0
        self.allocations = 0
        self._copy_stream = None

    def _slab(self, s: _Slabs, dtype: torch.dtype, pinned: bool,
              n: int) -> torch.Tensor:
        key = (dtype, pinned)
        flat = s.flat.get(key)
        if flat is None or flat.numel() < n:
            cap = bucket_elems(max(n, 1), dtype.itemsize,
                               zero._quantum_bytes())
            flat = torch.empty(cap, dtype=dtype, pin_memory=pinned)
            s.flat[key] = flat
            self.allocations += 1
        return flat

    @torch.no_grad()
    def take(self, tensors: List[torch.Tensor]):
        """Copies of ``tensors`` in the next slab set (waiting for the
        writer to let go of it first); returns (copies, the set)."""
        s = self.sets[self.next]
        self.next ^= 1
        s.free.wait()
        need: Dict[tuple, int] = {}
        for t in tensors:
            key = (t.dtype, t.is_cuda)
            need[key] = need.get(key, 0) + t.numel()
        flats = {key: self._slab(s, key[0], key[1], n)
                 for key, n in need.items()}
        cuda = [t for t in tensors if t.is_cuda]
        stream = None
        if cuda:
            dev = cuda[0].device
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            stream = self._copy_stream
            stream.wait_stream(torch.cuda.current_stream(dev))
        offs = dict.fromkeys(flats, 0)
        out = []
        for t in tensors:
            key = (t.dtype, t.is_cuda)
            off, n = offs[key], t.numel()
            dst = flats[key][off:off + n].view(t.shape)
            offs[key] = off + n
            if t.is_cuda:
                with torch.cuda.stream(stream):
                    dst.copy_(t, non_blocking=True)
                t.record_stream(stream)
            else:
                dst.copy_(t)
            out.append(dst)
        s.ready = None
        if stream is not None:
            s.ready = torch.cuda.Event()
            s.ready.record(stream)
            torch.cuda.current_stream(stream.device).wait_event(s.ready)
        return out, s


def _host_unit(x, tensors: List[torch.Tensor]):
    """A snapshot unit over host tensors, of the live unit's kind."""
    if isinstance(x, torch.nn.Module):
        return dict(zip((n for n, _ in x.named_parameters()), tensors))
    if isinstance(x, zero.ShardedParams):
        return zero.ShardedParams(x.spec, x.names, tensors)
    inner = x.inner
    hyper = {k: v for k, v in inner.param_groups[0].items() if k != "params"}
    keys = zero._state_keys(x)
    shards, it = [], iter(tensors)
    state = {}
    for gkeys in keys:
        shard = next(it)
        shards.append(shard)
        state[shard] = {k: next(it) for k in gkeys}
    opt = type(inner)([{"params": shards, **hyper}])
    for shard, entries in state.items():
        if entries:
            opt.state[shard] = entries
    return zero.ShardedOptState(x.spec, opt)


class ArrayState(State):
    """Tensor-tree state (the JAX package's ``ArrayState``, the analogue of
    the reference's ``TorchState``): ``params`` (a module, whose
    parameters it holds, or a tree of tensors), ``optimizer`` (a ZeRO
    state of ``parallel/zero.py``, or a tree) and the ``step``, plus any
    other trees passed as keywords. A tree is dicts, lists, tuples and
    named tuples of tensors, ZeRO states and plain values. The values at
    construction are the first snapshot, so a failure before the first
    ``commit()`` restores the start.

    ``restore`` writes the snapshot back into the live tensors in place
    (a module's parameters, a ZeRO state's shards), so what holds them,
    the model first, sees the restored values."""

    def __init__(self, params=None, optimizer=None, step: int = 0,
                 spill_dir: Optional[str] = None,
                 ckpt_dir: Optional[str] = None, **trees):
        super().__init__(spill_dir=spill_dir, ckpt_dir=ckpt_dir)
        self.params = params
        self.optimizer = optimizer
        self.step = int(step)
        self._tree_names = ["params", "optimizer"] + sorted(trees)
        for name, tree in trees.items():
            setattr(self, name, tree)
        self._snap = _Snapshot()
        self._saved: Dict[str, Any] = {}
        self._held: Optional[_Slabs] = None
        self.save()

    @property
    def slab_allocations(self) -> int:
        """Host slabs the snapshots allocated so far."""
        return self._snap.allocations

    def _trees(self) -> Dict[str, Any]:
        """The checkpoint layer's view of every tree, by name."""
        return {name: _view(getattr(self, name))
                for name in self._tree_names}

    def _leaf_key_base(self, name: str) -> int:
        """The first leaf index of tree ``name`` in the checkpoint layer's
        keys (``ckpt.writer.build_rank_payload`` flattens the trees in
        sorted-name order, in ``jax.tree_util``'s order)."""
        index = 0
        for n in sorted(self._tree_names):
            if n == name:
                return index
            tree = _view(getattr(self, n, None))
            if tree is None:
                continue
            flat, _ = tree_mod.flatten(tree, is_leaf=zero.is_sharded_state)
            index += len(flat)
        raise KeyError(name)

    def _exchange_replicas(self, step: int) -> None:
        from horovod_tpu_torch.ckpt import replica
        from horovod_tpu_torch.ckpt import writer as ckpt_writer

        if not replica.enabled():
            return
        st = basics._ensure_init()
        _items, _layout, exchange = ckpt_writer.build_rank_payload(
            self._trees(), st.rank, st.size)
        # a collective: every rank joins, with an empty dict too
        replica.exchange(exchange, step)

    # -- snapshot ------------------------------------------------------------
    def save(self) -> None:
        flat: Dict[str, tuple] = {}
        live: List[torch.Tensor] = []
        for name in self._tree_names:
            leaves, treedef = tree_mod.flatten(getattr(self, name),
                                               is_leaf=_is_unit)
            flat[name] = (leaves, treedef)
            for x in leaves:
                if _is_unit(x):
                    live.extend(_unit_tensors(x))
                elif isinstance(x, torch.Tensor):
                    live.append(x.detach())
        copies, slabs = self._snap.take(live)
        it = iter(copies)
        saved: Dict[str, Any] = {}
        for name, (leaves, treedef) in flat.items():
            out = []
            for x in leaves:
                if _is_unit(x):
                    out.append(_host_unit(
                        x, [next(it) for _ in _unit_tensors(x)]))
                elif isinstance(x, torch.Tensor):
                    out.append(next(it))
                else:
                    out.append(pickle.loads(pickle.dumps(x)))
            saved[name] = tree_mod.unflatten(treedef, out)
        saved["step"] = int(self.step)
        self._saved = saved
        self._held = slabs

    def _snapshot_ready(self):
        return self._held.ready if self._held is not None else None

    def _snapshot_released(self):
        slabs = self._held
        slabs.free.clear()  # the writer holds it until it has written it
        return slabs.free.set

    @torch.no_grad()
    def _write_back(self, name: str, src) -> None:
        """Copy tree ``src`` (a snapshot's or a restore's, of the live
        tree's structure) into the live tree ``name`` in place; leaves that
        are not tensors, and trees whose structure changed, are replaced."""
        live = getattr(self, name)
        if isinstance(live, torch.nn.Module):
            src = src if isinstance(src, dict) else _view(src)
            for k, p in live.named_parameters():
                p.data.copy_(src[k])
            return
        leaves, treedef = tree_mod.flatten(live, is_leaf=_is_unit)
        new, new_def = tree_mod.flatten(src, is_leaf=_is_unit)
        if new_def != treedef:  # a new layout (a re-shard): replace
            setattr(self, name, src)
            return
        out = []
        for x, y in zip(leaves, new):
            if _is_unit(x):
                xs, ys = _unit_tensors(x), _unit_tensors(y)
                if [t.shape for t in xs] != [t.shape for t in ys]:
                    setattr(self, name, src)
                    return
                for a, b in zip(xs, ys):
                    a.copy_(b)
                out.append(x)
            elif isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
                    and x.shape == y.shape and x.dtype == y.dtype:
                x.copy_(y)
                out.append(x)
            else:
                out.append(y)
        setattr(self, name, tree_mod.unflatten(treedef, out))

    def restore_snapshot(self) -> None:
        ready = self._snapshot_ready()
        if ready is not None:
            ready.synchronize()
        for name in self._tree_names:
            self._write_back(name, self._saved[name])
        self.step = int(self._saved["step"])

    # -- sync ----------------------------------------------------------------
    def _broadcast_tree(self, name: str, root_rank: int) -> None:
        """Rank ``root_rank``'s values of a tree without sharded leaves:
        its tensors broadcast in place through the runtime, its other
        leaves as one object."""
        from horovod_tpu_torch.parallel import dp

        tree = _view(getattr(self, name))
        paths = tree_mod.flatten_with_path(tree)[0]
        tensors = {f"elastic.sync.{name}.{tree_mod.path_key(p)}": x
                   for p, x in paths if isinstance(x, torch.Tensor)}
        dp.broadcast_parameters(tensors, root_rank=root_rank)
        others = [x for _, x in paths if not isinstance(x, torch.Tensor)]
        if others:
            others = iter(collectives.broadcast_object(others, root_rank))
            leaves, treedef = tree_mod.flatten(getattr(self, name),
                                               is_leaf=_is_unit)
            setattr(self, name, tree_mod.unflatten(treedef, [
                x if isinstance(x, torch.Tensor) or _is_unit(x)
                else next(others) for x in leaves]))

    def sync(self, root_rank: int = 0) -> None:
        """Make rank ``root_rank``'s values everyone's (after a re-form:
        the lowest surviving rank, renumbered 0).

        Sharded ZeRO leaves (``zero.is_sharded_state``) are not broadcast:
        rank 0's shard would overwrite every other rank's. They re-shard
        collectively by ``zero.resync`` against the synced parameters
        (``params`` come first in the tree order), with this rank's
        neighbour replica of the commit's step when it holds one."""
        from horovod_tpu_torch.ckpt import replica

        for name in self._tree_names:
            tree = _view(getattr(self, name))
            if tree is None:
                continue
            flat, treedef = tree_mod.flatten(tree,
                                             is_leaf=zero.is_sharded_state)
            if not any(zero.is_sharded_state(x) for x in flat):
                self._broadcast_tree(name, root_rank)
                continue
            base = self._leaf_key_base(name)
            out = []
            for i, x in enumerate(flat):
                if zero.is_sharded_state(x):
                    out.append(zero.resync(
                        x, _view(self.params), root_rank,
                        replica=replica.lookup(f"{name}/{base + i}",
                                               step=int(self.step))))
                elif isinstance(x, torch.Tensor):
                    from horovod_tpu_torch.parallel import dp

                    dp.broadcast_parameters(
                        {f"elastic.sync.{name}.{i}": x}, root_rank)
                    out.append(x)
                else:
                    out.append(collectives.broadcast_object(x, root_rank))
            setattr(self, name, tree_mod.unflatten(treedef, out))
        self.step = int(collectives.broadcast_object(int(self.step),
                                                     root_rank))
        self.save()

    # -- checkpoint ----------------------------------------------------------
    def _spill_payload(self):
        return ({name: _view(self._saved[name])
                 for name in self._tree_names},
                int(self._saved.get("step", 0)))

    def load_latest(self, directory: Optional[str] = None) -> Optional[int]:
        """Restore the newest consistent cut of ``directory`` (default: the
        state's checkpoint directory) into this state, sharded leaves
        re-sliced into the current world. The restored step, or None when
        the directory holds no checkpoint."""
        from horovod_tpu_torch import ckpt

        directory = directory or self._ckpt_dir
        if not directory:
            return None
        trees, step = ckpt.restore_latest(directory, self._trees())
        if step is None:
            return None
        for name, tree in trees.items():
            if tree is not None:
                self._write_back(name, tree)
        self.step = int(step)
        self.save()
        flight_recorder.emit("ckpt_state_loaded", step=int(step),
                             directory=directory)
        return int(step)
