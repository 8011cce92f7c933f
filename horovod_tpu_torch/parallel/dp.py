"""Data-parallel training API: ``DistributedOptimizer`` and the broadcasts.

Port of ``horovod_tpu/parallel/dp.py`` together with the optimizer wrapper
of ``horovod_tpu/torch/__init__.py:68-330`` (reference:
horovod/torch/__init__.py:47-403). Each parameter gets a
post-accumulate-grad hook; once ``backward_passes_per_step`` backward passes
have accumulated into its gradient, the hook starts an async in-place
allreduce of that gradient, so communication overlaps the rest of the
backward pass. ``step()`` waits for every outstanding allreduce, then runs
the wrapped optimizer. The hooks are registered at every world size, so a
one-process world issues the same collectives.
"""

from __future__ import annotations

import collections
import contextlib
import warnings
import weakref
from typing import Optional

import torch

from horovod_tpu_torch.compression import Compression
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.ops.collectives import Average


class _DistributedOptimizer(torch.optim.Optimizer):
    """Optimizer wrapper that allreduces gradients as they become ready
    (reference: horovod/torch/__init__.py:47-203)."""

    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, op):
        super(self.__class__, self).__init__(params)
        self._compression = compression
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
        self._synchronized = False
        self._should_synchronize = True
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._requires_update.append(p)
                    self._delay[p] = backward_passes_per_step
                    p.register_post_accumulate_grad_hook(self._make_hook())

    def _allreduce_grad_async(self, p):
        return collectives.allreduce_async_(
            p.grad, op=self._op, name=self._parameter_names[p],
            compression=self._compression)

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
            if p not in self._handles and p.grad is not None:
                self._handles[p] = self._allreduce_grad_async(p)
        for p, handle in self._handles.items():
            collectives.synchronize(handle)
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
        if self._should_synchronize:
            if self._synchronized:
                warnings.warn(
                    "optimizer.step() called after optimizer.synchronize() "
                    "but outside optimizer.skip_synchronize(): gradients "
                    "are allreduced a second time")
            self.synchronize()
        self._synchronized = False
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
                         op: int = Average) -> torch.optim.Optimizer:
    """Wrap a torch optimizer so gradients are averaged (``op``) across all
    ranks before each update (reference: horovod/torch/__init__.py:205-253).
    The result is an instance of the wrapped optimizer's class."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    return cls(optimizer.param_groups, named_parameters, compression,
               backward_passes_per_step, op)


def allreduce_gradients(grads, *, average: bool = True,
                        compression=Compression.none):
    """Allreduce a dict or list of gradient tensors as one group and return
    the same structure, reduced (port of ``dp.allreduce_gradients``)."""
    if isinstance(grads, dict):
        keys = list(grads)
        out = collectives.grouped_allreduce(
            [grads[k] for k in keys], average=average, compression=compression)
        return dict(zip(keys, out))
    return collectives.grouped_allreduce(list(grads), average=average,
                                         compression=compression)


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
