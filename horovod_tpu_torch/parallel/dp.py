"""Data-parallel training API: ``DistributedOptimizer`` and the broadcasts.

Port of ``horovod_tpu/parallel/dp.py`` together with the optimizer wrapper
of ``horovod_tpu/torch/__init__.py:68-330`` (reference:
horovod/torch/__init__.py:47-403). Each parameter gets a
post-accumulate-grad hook; once ``backward_passes_per_step`` backward passes
have accumulated into its gradient, the hook starts an async in-place
allreduce of that gradient, so communication overlaps the rest of the
backward pass. ``step()`` waits for every outstanding allreduce, then runs
the wrapped optimizer. The hooks are registered at every world size, so a
one-process world issues the same collectives. A sparse gradient
(``nn.Embedding(sparse=True)``) goes out by the sparse allreduce (a
gather of every rank's indices and values) unless ``sparse_as_dense``
densifies it first (``horovod_tpu/torch/__init__.py:79-82, 141-147,
192-193``). A parameter that a gradient release plan has tagged
(``parallel/buckets.py``) is the plan's: its hook and ``synchronize``
leave it alone, so no gradient goes out twice. A ``SparseGrad`` (from
``with_sparse_embedding_grad``, ``parallel/sparse.py``) enters through
``add_sparse_grad`` as one backward pass's gradient: it joins ``p.grad``
as a COO tensor and goes out by the same sparse path.
``shard_optimizer_states=True`` returns the ZeRO wrapper
(``parallel/zero.py`` ``sharded_update``) in place of the hooks.

``step()`` carries the JAX update's hooks (``horovod_tpu/parallel/
dp.py:214-254``): the memory ledger's ``params`` and ``grads`` bytes, a
step-profiler boundary (``profiler.auto_step()``)
before the exchange is awaited, the inner step inside
``profiler.annotate("optimizer")``, and, under ``HOROVOD_INTEGRITY``, the
step guard over the averaged gradients' global norm: a flagged step is
skipped, leaving the parameters, the inner optimizer's state and its step
count as they were, as zero updates and the unchanged ``opt_state`` do in
optax. The ZeRO wrapper has neither hook, as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import warnings
import weakref
from typing import Optional

import torch

from horovod_tpu_torch import integrity, memory, profiler
from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.collectives import Average, Sum
from horovod_tpu_torch.parallel import buckets, sparse, zero


class _DistributedOptimizer(torch.optim.Optimizer):
    """Optimizer wrapper that allreduces gradients as they become ready
    (reference: horovod/torch/__init__.py:47-203)."""

    #: its hooks allreduce the gradients (``training.make_train_step``)
    exchanges_gradients = True

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, sparse_as_dense, op):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._sparse_as_dense = sparse_as_dense
        self._op = op
        if named_parameters is not None:
            named_parameters = list(named_parameters)
        else:
            named_parameters = [
                (f"allreduce.noname.{i}", v)
                for i, v in enumerate(v for group in self.param_groups
                                      for v in group["params"])]
        # the name is the reference's negotiation key: duplicates break it
        names = [name for name, _ in named_parameters]
        if len(set(names)) < len(names):
            dups = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"parameter names must be unique, duplicates: "
                             f"{dups}")
        named = {p for _, p in named_parameters}
        if any(p not in named for group in self.param_groups
               for p in group["params"]):
            raise ValueError("named_parameters was specified but one or more "
                             "optimizer parameters were not named")
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1")
        self._parameter_names = {p: n for n, p in named_parameters}
        self.backward_passes_per_step = backward_passes_per_step
        self._delay = {}
        self._handles = {}
        self._requires_update = []
        self._param_bytes = None  # the memory ledger's, once: sizes stay
        self._synchronized = False
        self._should_synchronize = True
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._requires_update.append(p)
                    self._delay[p] = backward_passes_per_step
                    p.register_post_accumulate_grad_hook(self._make_hook())

    def _allreduce_grad_async(self, p):
        name = self._parameter_names[p]
        if p.grad.is_sparse:
            if self._sparse_as_dense:
                p.grad = p.grad.to_dense()
            elif self._op in (Average, Sum):
                return collectives.sparse_allreduce_async(
                    p.grad, average=self._op == Average, name=name,
                    compression=self._compression)
            else:
                raise ValueError("a sparse gradient is reduced by Average "
                                 "or Sum only; pass sparse_as_dense=True")
        return collectives.allreduce_async_(
            p.grad, op=self._op, name=name, compression=self._compression)

    def add_sparse_grad(self, p, sg: "sparse.SparseGrad") -> None:
        """Take ``sg`` as one backward pass's gradient of ``p``, as the
        hook takes autograd's: its COO form is added to ``p.grad`` and sent
        by the sparse path when the passes of a step are in."""
        if p not in self._delay:
            raise ValueError("add_sparse_grad: the parameter is not one of "
                             "this optimizer's")
        coo = sg.to_coo().to(p.dtype)
        p.grad = coo if p.grad is None else p.grad + coo
        self._mark_ready(p)

    def _make_hook(self):
        # The parameter keeps its hooks in C++, out of the garbage
        # collector's sight: a hook that held the optimizer or the
        # parameter would keep both (and the model's gradients and the
        # optimizer state) alive after the caller drops them.
        ref = weakref.ref(self)

        def hook(param):
            opt = ref()
            if opt is not None:
                opt._mark_ready(param)

        return hook

    def _mark_ready(self, p):
        """reference: horovod/torch/__init__.py:127-143."""
        if buckets.held_by_plan(p):
            return  # a release plan sends this gradient
        if self._handles.get(p) is not None and self._delay[p] <= 0:
            raise AssertionError(
                "Gradients were computed more than backward_passes_per_step "
                "times before call to step(). Increase "
                "backward_passes_per_step to accumulate gradients locally.")
        self._delay[p] -= 1
        if self._delay[p] == 0:
            self._handles[p] = self._allreduce_grad_async(p)

    def synchronize(self):
        """Wait for every outstanding allreduce; parameters whose hook did
        not fire this step (no gradient path) are reduced here."""
        for p in self._requires_update:
            if p not in self._handles and p.grad is not None \
                    and not buckets.held_by_plan(p):
                self._handles[p] = self._allreduce_grad_async(p)
        for p, handle in self._handles.items():
            out = collectives.synchronize(handle)
            if out.is_sparse:  # a new tensor, not the gradient in place
                p.grad = out.to(p.grad.dtype)
            self._delay[p] = self.backward_passes_per_step
        self._handles.clear()
        self._synchronized = True

    @contextlib.contextmanager
    def skip_synchronize(self):
        """For callers that ran ``synchronize()`` themselves before
        ``step()`` (reference: horovod/torch/__init__.py:185-193)."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        profiler.auto_step()
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called after optimizer.synchronize() "
                    "but outside optimizer.skip_synchronize(): gradients "
                    "are allreduced a second time")
            self.synchronize()
        self._synchronized = False
        mem = memory.tracker()
        if mem.enabled:
            # the memory ledger's params (each storage once, counted at the
            # first step) and grads (sizes only: a gradient is a tensor of
            # its own)
            params = self._requires_update
            if self._param_bytes is None:
                self._param_bytes = memory.tree_bytes(params)
            mem.set_bytes("params", self._param_bytes)
            mem.set_bytes("grads", sum(memory.tensor_bytes(p.grad)
                                       for p in params
                                       if p.grad is not None))
        if integrity.enabled() and not integrity.guards.guard_gradients(
                [p.grad for p in self._requires_update]):
            # every rank observes the same averaged norm, so every rank
            # skips this step; the batch stays consumed
            return None
        with profiler.annotate("optimizer"):
            return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        """Zeroing gradients that async allreduces are still reading would
        corrupt the average (reference: horovod/torch/__init__.py:197-202)."""
        if self._handles:
            raise AssertionError(
                "optimizer.zero_grad() was called after loss.backward() but "
                "before optimizer.step() or optimizer.synchronize(). This is "
                "prohibited as it can cause a race condition.")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         sparse_as_dense: bool = False,
                         op: int = Average,
                         shard_optimizer_states: bool = False):
    """Wrap a torch optimizer so gradients are averaged (``op``) across all
    ranks before each update (reference: horovod/torch/__init__.py:205-253).
    Sparse gradients go out by :func:`~horovod_tpu_torch.ops.collectives.
    sparse_allreduce_async` unless ``sparse_as_dense`` densifies them. The
    result is an instance of the wrapped optimizer's class.

    ``shard_optimizer_states=True`` returns the ZeRO wrapper
    (``zero.sharded_update``, reference: ``horovod_tpu/parallel/
    dp.py:164-210``): each ``step()`` reduce-scatters the gradients, steps
    an optimizer of the same class over this rank's flat shards and
    allgathers them into the parameters; the optimizer state lives 1/N a
    rank. It needs ``backward_passes_per_step == 1`` and ``op`` Average or
    Sum."""
    if shard_optimizer_states:
        if backward_passes_per_step != 1:
            raise ValueError(
                "shard_optimizer_states does not compose with "
                "backward_passes_per_step > 1: accumulate in the training "
                "loop instead")
        if op not in (Average, Sum):
            raise ValueError("shard_optimizer_states reduces by Average or "
                             "Sum only")
        return zero.sharded_update(
            optimizer, named_parameters, average=op == Average,
            compression=compression, sparse_as_dense=sparse_as_dense)
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, sparse_as_dense, op)


def allreduce_gradients(grads, *, average: bool = True,
                        compression=Compression.none,
                        name: str = "allreduce_gradients",
                        sparse_as_dense: bool = False):
    """Allreduce a dict or list of gradient tensors as one group and return
    the same structure, reduced (port of ``dp.allreduce_gradients``). The
    i-th gradient is named ``"<name>.<i>"`` every call, so from the second
    call on the runtime answers them from its response cache. A
    ``SparseGrad`` leaf is exchanged by its ids and rows (two gathers,
    started before the dense group) unless ``sparse_as_dense`` densifies
    it into the group; either way its result is dense. Inside
    ``buckets.prereduced()`` the gradients are returned as they are;
    stage-2 ``ShardedGrads`` are refused."""
    if isinstance(grads, zero.ShardedGrads):
        raise TypeError(
            "allreduce_gradients got a zero.ShardedGrads: stage-2 gradients "
            "are already the reduced local shard — feed them straight to a "
            "partition-aligned zero.sharded_adamw / zero.sharded_update "
            "instead of re-reducing them")
    if buckets.is_prereduced():
        return grads
    keys = list(grads) if isinstance(grads, dict) else None
    leaves = [grads[k] for k in keys] if keys is not None else list(grads)
    out = list(leaves)
    exchanges = {}
    for i, g in enumerate(leaves):
        if sparse.is_sparse(g):
            if sparse_as_dense:
                out[i] = g.densify()
            else:
                exchanges[i] = collectives.sparse_allreduce_async(
                    g.to_coo(), average=average, name=f"{name}.{i}",
                    compression=compression)
    dense = [i for i in range(len(out)) if i not in exchanges]
    if dense:
        reduced = collectives.grouped_allreduce(
            [out[i] for i in dense], average=average, name=name,
            compression=compression)
        for i, r in zip(dense, reduced):
            out[i] = r
    for i, handle in exchanges.items():
        out[i] = handle.wait().to_dense()
    return dict(zip(keys, out)) if keys is not None else out


def DistributedGradientTape(grad_fn, *, compression=Compression.none,
                            average: bool = True, returns: str = "grads",
                            name: str = "gradient_tape",
                            sparse_as_dense: bool = False):
    """Wrap a function that returns gradients so that they come back
    allreduced (port of ``horovod_tpu/parallel/dp.py:275-317``; reference:
    ``hvd.DistributedGradientTape``, horovod/tensorflow/__init__.py:
    323-376). PyTorch has no tape either: the counterpart of a wrapped
    ``tf.GradientTape`` is a wrapped gradient function, such as one of
    ``torch.func.grad`` or ``torch.func.grad_and_value`` (a dict of
    gradients, or a list). ``returns`` says what the function returns:

    * ``"grads"``: the gradients (``torch.func.grad(f)``);
    * ``"value_and_grads"``: ``(value, grads)``;
    * ``"grads_and_aux"``: ``(grads, aux)``
      (``torch.func.grad(f, has_aux=True)``, and
      ``torch.func.grad_and_value(f)``, whose value passes as the aux).

    The gradients go through :func:`allreduce_gradients` under ``name``
    (``SparseGrad`` leaves too, densified first with ``sparse_as_dense``)."""
    if returns not in ("grads", "value_and_grads", "grads_and_aux"):
        raise ValueError(
            "returns must be 'grads', 'value_and_grads' or 'grads_and_aux', "
            f"got {returns!r}")

    def reduce(grads):
        return allreduce_gradients(grads, average=average,
                                   compression=compression, name=name,
                                   sparse_as_dense=sparse_as_dense)

    def wrapped(*args, **kwargs):
        out = grad_fn(*args, **kwargs)
        if returns == "value_and_grads":
            value, grads = out
            return value, reduce(grads)
        if returns == "grads_and_aux":
            grads, aux = out
            return reduce(grads), aux
        return reduce(out)

    return wrapped


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Make every rank's parameters rank ``root_rank``'s, in place — model
    init / resume (reference: horovod/torch/__init__.py:255-297). Takes a
    ``state_dict()`` or an iterable of (name, tensor)."""
    if isinstance(params, dict):
        params = sorted(params.items())
    elif isinstance(params, collections.abc.Iterable):
        params = list(params)
    else:
        raise ValueError(f"invalid params of type: {type(params)}")
    handles = [collectives.broadcast_async_(p.data, root_rank, name=name)
               for name, p in params if isinstance(p, torch.Tensor)]
    for handle in handles:
        collectives.synchronize(handle)


class _DeviceTensor(collections.namedtuple("_DeviceTensor", "shape dtype")):
    """Placeholder in the pickled skeleton for a state tensor that travels
    by a tensor broadcast."""


def broadcast_optimizer_state(optimizer: torch.optim.Optimizer,
                              root_rank: int = 0) -> None:
    """Make every rank's optimizer state rank ``root_rank``'s (reference:
    horovod/torch/__init__.py:299-403). The structure, the hyperparameters
    and the state kept on the CPU (step counts) travel in one pickled
    object; state tensors on the device are broadcast tensor-wise."""
    if isinstance(optimizer, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    sd = optimizer.state_dict()
    skeleton = {
        "param_groups": sd["param_groups"],
        "state": {pid: {key: _DeviceTensor(tuple(v.shape), v.dtype)
                        if isinstance(v, torch.Tensor) and v.device.type != "cpu"
                        else v for key, v in s.items()}
                  for pid, s in sd["state"].items()},
    }
    skeleton = collectives.broadcast_object(skeleton, root_rank)
    device = basics.device()
    state, handles = {}, []
    for pid, entries in sorted(skeleton["state"].items()):
        mine = sd["state"].get(pid, {})
        state[pid] = {}
        for key, val in sorted(entries.items()):
            if isinstance(val, _DeviceTensor):
                t = mine.get(key)
                if not isinstance(t, torch.Tensor) or t.device.type == "cpu":
                    t = torch.empty(val.shape, dtype=val.dtype, device=device)
                handles.append(collectives.broadcast_async_(t, root_rank))
                val = t
            state[pid][key] = val
    for handle in handles:
        collectives.synchronize(handle)
    optimizer.load_state_dict({"state": state,
                               "param_groups": skeleton["param_groups"]})
