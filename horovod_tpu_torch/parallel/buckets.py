"""Bucket-wise gradient release: the exchange overlaps the backward.

Port of the eager lane of ``horovod_tpu/parallel/buckets.py``. The
parameters are partitioned into buckets in **reverse-topological order**
(the reverse of ``named_parameters()``, the order in which a backward
finishes their gradients), cut where a bucket reaches ``bucket_bytes``.
Each bucket goes to the wire as soon as its last gradient lands, while
the backward goes on:

* **allreduce** (the default): one grouped enqueue a bucket
  (``collectives.grouped_allreduce_async_``), each gradient reduced in
  place in its ``.grad`` under the name
  ``grad_bucket.<name>.b<bucket>.<leaf>``;
* **reduce-scatter** (``reduce_scatter=True``, ZeRO stage 2): each of the
  bucket's dtype groups is packed and reduce-scattered under
  ``zero2.<name>.b<bucket>.g<group>``, and the bucket's ``.grad`` tensors
  are dropped once packed, so no full gradient outlives its bucket.
  :meth:`GradReleasePlan.gather` returns a ``zero.ShardedGrads`` for a
  ``sharded_adamw``/``sharded_update`` built with
  ``partition=plan.zero_partition(params)``.

A bucket's priority is ``len(buckets) - index``: the first released
negotiates first. The names carry no step number (the JAX package's do),
so the runtime's response cache answers them from the second step on.

``plan.tag(params)`` registers a ``register_post_accumulate_grad_hook`` on
each parameter once (the JAX package's ``custom_vjp`` identity) and opens
a backward pass; ``plan.gather()`` closes it, waits for every bucket in
release order and returns the reduced gradients. A parameter a plan has
tagged is the plan's: a ``DistributedOptimizer``'s hooks and its
``synchronize`` leave it alone (they would send its gradient a second
time). ``prereduced()`` marks gradients handed on as already reduced, for
``allreduce_gradients``.

``every_k > 1`` accumulates ``every_k`` backward passes in ``.grad`` (do
not zero the gradients between them) and only the last pass releases, the
sum times ``1/every_k``.

Knobs: ``HOROVOD_GRAD_BUCKET_BYTES`` (target bucket payload, 4 MiB by
default, rounded up to the fusion quantum) and
``HOROVOD_GRAD_BUCKET_RELEASE`` (``training.make_train_step`` builds a plan
of its own). Not ported: ``HOROVOD_GRAD_BUCKET_WIRE`` and the traced
lanes, which exist for the JAX package's single-controller mesh and its
``jit``/``shard_map`` programs; the comms ledger's ``bucket_wire`` lane,
which belongs to that wire (the collectives are the ``device`` lane's
records, in the executor).

Each released bucket is an ``op_dispatch`` flight event (phase
``bucket_release`` or, reduce-scattered, ``grad_release``, with the
bucket's index and bytes) and each gather an ``op_complete`` with its
buckets and host seconds; a reduce-scatter plan's shards are the memory
ledger's ``grad_shards``.
"""

from __future__ import annotations

import threading
import time
import weakref
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import memory
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel import zero
from horovod_tpu_torch.utils import env

_tls = threading.local()

# parameter -> weak reference to the plan that tagged it
_HELD = WeakTensorKeyDictionary()


def is_prereduced() -> bool:
    """True while this thread is inside a :func:`prereduced` scope: the
    gradients were exchanged by a release plan, and
    ``allreduce_gradients`` must not reduce them again."""
    return getattr(_tls, "prereduced", False)


@contextmanager
def prereduced():
    """Mark gradients handed to the optimizer as already reduced."""
    prev = is_prereduced()
    _tls.prereduced = True
    try:
        yield
    finally:
        _tls.prereduced = prev


def held_by_plan(param: torch.Tensor) -> bool:
    """True when a live release plan has tagged ``param``: its gradient
    goes out through the plan only."""
    ref = _HELD.get(param)
    return ref is not None and ref() is not None


def release_enabled() -> bool:
    """``HOROVOD_GRAD_BUCKET_RELEASE``, default off."""
    return env._get_bool(env.HOROVOD_GRAD_BUCKET_RELEASE, False)


# The autotuner's committed bucket payload (runtime._autotune_sync; 0:
# none; cleared when the runtime stops). It applies to release plans built
# after the commit: a plan keeps its partition
# (horovod_tpu/parallel/buckets.py:126-140).
_autotuned_bucket_bytes = 0


def set_autotuned_bucket_bytes(nbytes: int) -> None:
    """The autotuner's commit hook: the bucket payload of plans built from
    now on (0 clears it)."""
    global _autotuned_bucket_bytes
    _autotuned_bucket_bytes = max(0, int(nbytes))


def bucket_bytes_from_env() -> int:
    """``HOROVOD_GRAD_BUCKET_BYTES`` (the autotuner's committed value wins
    while set) rounded up to a whole number of fusion quanta (at least
    one)."""
    raw = _autotuned_bucket_bytes or env._get_int(
        env.HOROVOD_GRAD_BUCKET_BYTES, env.DEFAULT_GRAD_BUCKET_BYTES)
    quantum = max(1, zero._quantum_bytes())
    raw = max(quantum, raw)
    return ((raw + quantum - 1) // quantum) * quantum


def _nbytes(leaf) -> int:
    return torch.Size(leaf.shape).numel() * leaf.dtype.itemsize


class _Bucket:
    __slots__ = ("index", "leaves", "nbytes")

    def __init__(self, index: int, leaves: List[int], nbytes: int):
        self.index = index
        self.leaves = leaves  # leaf positions, reverse-topological order
        self.nbytes = nbytes


class GradReleasePlan:
    """Partition and release state of one model's gradients.

    Build once and reuse every step: the partition comes from the first
    tagged parameters, and the hooks are registered once."""

    def __init__(self, *, bucket_bytes: Optional[int] = None,
                 every_k: int = 1, average: bool = True,
                 name: str = "grad", reduce_scatter: bool = False):
        if every_k < 1:
            raise ValueError("every_k must be >= 1")
        self.bucket_bytes = (bucket_bytes if bucket_bytes is not None
                             else bucket_bytes_from_env())
        self.every_k = every_k
        self.average = average
        self.name = name
        self.reduce_scatter = bool(reduce_scatter)
        # partition (made at the first tag or zero_partition)
        self._num_leaves: Optional[int] = None
        self._buckets: List[_Bucket] = []
        self._bucket_of: Dict[int, _Bucket] = {}
        self._metas: Dict[int, zero.LeafMeta] = {}
        # the tagged parameters, their keys and hook handles
        self._params: Optional[list] = None
        self._keys = None
        self._hooks: list = []
        # per-pass state (the hooks run on autograd's thread)
        self._armed = False
        self._grads: Dict[int, torch.Tensor] = {}
        self._remaining: Dict[int, int] = {}
        self._pass_idx = 0
        # released handles in release order: (bucket, [(leaf, handle)]) and,
        # reduce-scatter, (bucket, [(group, handle)])
        self._released: List[tuple] = []
        self._rs_released: List[tuple] = []
        self._zspec: Optional[zero.ZeroSpec] = None
        self._groups_of_bucket: Dict[int, List[int]] = {}
        # wire counters: released on the training side, completed on the
        # runtime's thread
        self._wire_lock = threading.Lock()
        self._wire_released = 0
        self._wire_completed = 0
        self._wire_failed = 0

    # -- partition ----------------------------------------------------------
    def _ensure_partition(self, leaves) -> None:
        if self._num_leaves is not None:
            if len(leaves) != self._num_leaves:
                raise ValueError(
                    f"gradient tree changed shape: plan was built for "
                    f"{self._num_leaves} leaves, got {len(leaves)}")
            return
        self._num_leaves = len(leaves)
        # a frozen parameter gets no gradient: it forms no bucket
        dense = [i for i, leaf in enumerate(leaves)
                 if not (isinstance(leaf, torch.nn.Parameter)
                         and not leaf.requires_grad)]
        cur: List[int] = []
        cur_bytes = 0
        for i in reversed(dense):
            cur.append(i)
            cur_bytes += _nbytes(leaves[i])
            if cur_bytes >= self.bucket_bytes:
                self._buckets.append(_Bucket(len(self._buckets), cur,
                                             cur_bytes))
                cur, cur_bytes = [], 0
        if cur:
            self._buckets.append(_Bucket(len(self._buckets), cur, cur_bytes))
        for b in self._buckets:
            for i in b.leaves:
                self._bucket_of[i] = b
                self._metas[i] = zero.LeafMeta(tuple(leaves[i].shape),
                                               leaves[i].dtype)

    def buckets(self) -> List[List[int]]:
        """The partition (leaf positions a bucket, in release order); empty
        before the first ``tag``."""
        return [list(b.leaves) for b in self._buckets]

    def zero_partition(self, params) -> List[List[int]]:
        """The buckets as a ``zero.build_spec`` partition: give it to
        ``sharded_adamw(..., partition=...)`` or ``sharded_update(...,
        partition=...)`` so the optimizer's shards line up with the
        reduce-scatter release. ``params`` as for :meth:`tag` (shape
        stand-ins such as meta tensors do)."""
        self._ensure_partition(zero._leaves_of(params)[1])
        return self.buckets()

    def _ensure_zspec(self) -> zero.ZeroSpec:
        """The bucket-aligned layout (one group a bucket and dtype), made
        again when the world changes."""
        spec = self._zspec
        if (spec is not None and spec.world == basics.size()
                and spec.rank == basics.rank()):
            return spec
        metas = [self._metas.get(i) for i in range(self._num_leaves or 0)]
        spec = zero._local_spec(metas, self.buckets())
        self._groups_of_bucket = {}
        for gi, g in enumerate(spec.groups):
            b = self._bucket_of[g.indices[0]]
            self._groups_of_bucket.setdefault(b.index, []).append(gi)
        self._zspec = spec
        return spec

    # -- tagging ------------------------------------------------------------
    def tag(self, params):
        """Open a backward pass over ``params`` (a dict keyed like
        ``named_parameters()``, or a list) before the forward: the first
        call registers each parameter's hook, and a DistributedOptimizer
        leaves those parameters to the plan from then on. Returns
        ``params``."""
        keys, leaves = zero._leaves_of(params)
        self._ensure_partition(leaves)
        if self._params is None or any(
                a is not b for a, b in zip(self._params, leaves)):
            self._hook(leaves)
        self._keys = keys
        self._grads.clear()
        self._remaining = {b.index: len(b.leaves) for b in self._buckets}
        self._armed = True
        return params

    def _hook(self, leaves) -> None:
        for h in self._hooks:
            h.remove()
        ref = weakref.ref(self)
        self._hooks = [leaves[i].register_post_accumulate_grad_hook(
            _make_hook(ref, i)) for i in self._bucket_of]
        for i in self._bucket_of:
            _HELD[leaves[i]] = ref
        self._params = list(leaves)

    # -- backward hooks -----------------------------------------------------
    def _on_grad(self, i: int, param: torch.Tensor) -> None:
        if not self._armed or self._pass_idx + 1 < self.every_k:
            return  # no open pass, or a pass that only accumulates
        if param.grad.is_sparse:
            raise ValueError("a release plan carries dense gradients only")
        bucket = self._bucket_of[i]
        self._grads[i] = param.grad
        self._remaining[bucket.index] -= 1
        if self._remaining[bucket.index] == 0:
            self._finish_bucket(bucket)

    def _finish_bucket(self, bucket: _Bucket) -> None:
        values = {i: self._grads.pop(i) for i in bucket.leaves
                  if i in self._grads}
        if self.every_k > 1:
            for v in values.values():
                v.mul_(torch.tensor(1.0 / self.every_k, dtype=v.dtype))
        if self.reduce_scatter:
            self._release_reduce_scatter(bucket, values)
        else:
            self._release(bucket, values)

    # -- wire ---------------------------------------------------------------
    def _priority(self, bucket: _Bucket) -> int:
        return len(self._buckets) - bucket.index

    def _release(self, bucket: _Bucket, values) -> None:
        leaves = list(values)
        handles = collectives.grouped_allreduce_async_(
            [values[i] for i in leaves],
            [f"grad_bucket.{self.name}.b{bucket.index}.{i}" for i in leaves],
            average=self.average, priority=self._priority(bucket),
            group_callback=self._on_wire_complete)
        with self._wire_lock:
            self._wire_released += len(handles)
        self._released.append((bucket.index, list(zip(leaves, handles))))
        flight_recorder.emit(
            "op_dispatch", op="allreduce", phase="bucket_release",
            bucket=bucket.index, tensors=len(leaves),
            bytes=sum(values[i].numel() * values[i].element_size()
                      for i in leaves))

    def _release_reduce_scatter(self, bucket: _Bucket, values) -> None:
        """Pack each of the bucket's groups (a leaf with no gradient packs
        as zeros, the reduction identity) and reduce-scatter it; then drop
        the bucket's full gradients."""
        spec = self._ensure_zspec()
        op = collectives.Average if self.average else collectives.Sum
        pairs, nbytes = [], 0
        for gi in self._groups_of_bucket.get(bucket.index, []):
            g = spec.groups[gi]
            nbytes += g.padded * zero.group_dtype(g).itemsize
            vals = {i: values[i] if i in values else torch.zeros(
                        shape, dtype=zero.group_dtype(g),
                        device=self._params[i].device)
                    for i, shape in zip(g.indices, g.shapes)}
            pairs.append((gi, collectives.reducescatter_async(
                zero._pack_group(vals, g), op=op,
                name=f"zero2.{self.name}.b{bucket.index}.g{gi}",
                priority=self._priority(bucket))))
        for i in bucket.leaves:
            self._params[i].grad = None
        with self._wire_lock:
            self._wire_released += len(pairs)
        self._rs_released.append((bucket.index, pairs))
        flight_recorder.emit(
            "op_dispatch", op="reducescatter", phase="grad_release",
            bucket=bucket.index, groups=len(pairs), bytes=nbytes)

    def _on_wire_complete(self, ok: bool) -> None:
        with self._wire_lock:
            self._wire_completed += 1
            if not ok:
                self._wire_failed += 1

    def wire_stats(self) -> dict:
        """Collectives released, completed and failed so far."""
        with self._wire_lock:
            return {"released": self._wire_released,
                    "completed": self._wire_completed,
                    "failed": self._wire_failed}

    # -- gather -------------------------------------------------------------
    def gather(self):
        """Close the pass: release the buckets whose countdown never
        reached zero (a parameter unused in the forward gets no hook call),
        wait for every bucket in release order and return the reduced
        gradients, keyed or ordered as tagged (the allreduce's results are
        the parameters' ``.grad``), or ``zero.ShardedGrads``. ``None``
        after a pass that only accumulates (``every_k``). On any failure
        the rest are waited for and the step's state reset before the
        error propagates, so the next step starts clean on the same
        plan."""
        self._armed = False
        if self._pass_idx + 1 < self.every_k:
            self._pass_idx += 1
            return None
        failure = None
        t0 = time.monotonic()
        try:
            self._flush()
        except Exception as exc:
            failure = exc
        released = self._released + self._rs_released
        pairs = [p for _, ps in released for p in ps]
        outs = {}
        for key, h in pairs:
            try:
                outs[key] = collectives.synchronize(h)
            except Exception as exc:  # wait for the rest first
                failure = failure or exc
        self._reset_step()
        flight_recorder.emit(
            "op_complete", phase="bucket_gather", buckets=len(released),
            ok=failure is None, seconds=round(time.monotonic() - t0, 6))
        if failure is not None:
            raise failure
        if self.reduce_scatter:
            spec = self._ensure_zspec()
            shards = tuple(
                outs[gi] if gi in outs else torch.zeros(
                    g.shard_elems, dtype=zero.group_dtype(g),
                    device=basics.device())
                for gi, g in enumerate(spec.groups))
            memory.tracker().note_tree_bytes("grad_shards", list(shards))
            return zero.ShardedGrads(spec, shards)
        grads = [p.grad for p in self._params]
        return (dict(zip(self._keys, grads)) if self._keys is not None
                else grads)

    def _flush(self) -> None:
        for b in self._buckets:
            if self._remaining.get(b.index, 0) > 0 and any(
                    i in self._grads for i in b.leaves):
                self._remaining[b.index] = 0
                self._finish_bucket(b)

    def _reset_step(self) -> None:
        self._armed = False
        self._pass_idx = 0
        self._grads.clear()
        self._released = []
        self._rs_released = []

    def abort(self) -> None:
        """Wait for every collective in flight (ignoring its errors) and
        reset, for a caller that abandons a step without gathering; the
        bucket-aligned layout is made again at the next release."""
        for _, pairs in self._released + self._rs_released:
            for _, h in pairs:
                try:
                    collectives.synchronize(h)
                except Exception:
                    pass
        self._zspec = None
        self._reset_step()


def _make_hook(ref, i: int):
    """A parameter's hook: it holds the plan weakly, as the parameter
    keeps its hooks out of the garbage collector's sight."""

    def hook(param):
        plan = ref()
        if plan is not None:
            plan._on_grad(i, param)

    return hook
