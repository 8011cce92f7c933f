"""The training API of the data-parallel examples and benchmarks (port of
``horovod_tpu/training.py``): :class:`TrainState` and
:func:`create_train_state`, the eager step (:func:`make_train_step`) and
the round of steps (:func:`make_train_round`), each with the bucket-wise
gradient release (``parallel/buckets.py``) and wrapped by the step
profiler's and the integrity guard's hooks when those are on.

The JAX package jits one step (or a ``lax.scan`` round of steps) over the
global batch; here a step is eager PyTorch, one process per GPU, and the
gradient exchange is the optimizer's own (the hooks of
:func:`horovod_tpu_torch.DistributedOptimizer`, the ZeRO optimizers'
reduce-scatter), a release plan's or, when neither exchanges, the step's:
it averages the gradients over the world, so every optimizer sees the
global batch's gradient as the JAX step does.

A round is an eager loop of steps on the same batch, returning the last
loss. The JAX round is one XLA program, one dispatch a round; its eager
counterpart would be a CUDA graph of the round, which cannot be captured
while the runtime's thread issues the collectives from its own stream.
A round is one profiler step, as one XLA program is.

``init_on_host`` and ``init_on_host_fn`` are not ported: the JAX package
runs a model's one-off init on the host's CPU backend, switching kernels to
interpret mode by a change of the environment, to spare a remote
accelerator its compile; a torch module is built on the device its
constructor names, with nothing to compile.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch import integrity, profiler
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.parallel import buckets, dp, zero


@dataclasses.dataclass
class TrainState:
    """The JAX package's ``TrainState``: ``params`` and ``batch_stats``
    are the module's own tensors (``named_parameters()``,
    ``named_buffers()``), which the steps update in place; ``opt_state``
    is the optimizer's state when the state was made."""

    params: Any
    batch_stats: Any
    opt_state: Any
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer,
                       broadcast: bool = True) -> TrainState:
    """Make every rank's parameters and buffers rank 0's (the reference's
    init convention; ``broadcast=False`` leaves them), then take the
    optimizer's state: ``optimizer.init(params)`` for a step-level
    optimizer (``fused_adamw``, ``sharded_adamw``), the torch optimizer's
    ``state_dict()`` otherwise. The model is already built: a torch module
    initializes in its constructor, on the device it names."""
    if broadcast:
        dp.broadcast_parameters(model.state_dict(), root_rank=0)
    params = dict(model.named_parameters())
    opt_state = (optimizer.init(params) if hasattr(optimizer, "apply")
                 else optimizer.state_dict())
    return TrainState(params=params, batch_stats=dict(model.named_buffers()),
                      opt_state=opt_state)


def default_loss_fn(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(logits,
    labels).mean()``, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def _resolve_grad_release(grad_release):
    """``None``: a plan when ``HOROVOD_GRAD_BUCKET_RELEASE`` is on, which
    reduce-scatters when ``HOROVOD_ZERO_STAGE >= 2``; ``False``: none; a
    plan: that plan (reference: horovod_tpu/training.py:162-181)."""
    if grad_release is None:
        if buckets.release_enabled():
            return buckets.GradReleasePlan(
                reduce_scatter=zero.stage_from_env() >= 2)
        return None
    if grad_release is False:
        return None
    return grad_release


def make_train_step(model: torch.nn.Module, optimizer,
                    loss_fn: Optional[Callable] = None,
                    grad_release=None) -> Callable:
    """An eager ``step(inputs, labels) -> loss`` (see :func:`_make_step`),
    a profiler step a call under ``HOROVOD_PROFILE`` and its loss watched
    by the integrity guard under ``HOROVOD_INTEGRITY``; with both off, the
    step itself."""
    return _with_integrity_guard(_with_profiler_hook(
        _make_step(model, optimizer, loss_fn, grad_release)))


def make_train_round(model: torch.nn.Module, optimizer,
                     loss_fn: Optional[Callable] = None, steps: int = 1,
                     grad_release=None) -> Callable:
    """``round(inputs, labels) -> loss``: ``steps`` steps of
    :func:`make_train_step` on the same batch, returning the last step's
    loss, unread (the JAX package's ``lax.scan`` round, benchmark
    workloads). Under ``HOROVOD_PROFILE`` a round is one profiler step,
    whatever the optimizer's own hook would mark."""
    if steps < 1:
        raise ValueError(f"a round takes at least one step, got {steps}")
    one_step = _make_step(model, optimizer, loss_fn, grad_release)

    def round_fn(inputs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        for _ in range(steps):
            loss = one_step(inputs, labels)
        return loss

    return _with_integrity_guard(_with_profiler_hook(round_fn))


def _with_integrity_guard(step_fn: Callable) -> Callable:
    """Watch the returned loss with the integrity spike guard when
    ``HOROVOD_INTEGRITY`` is on: one read of the loss (one wait for the
    device) a call. The update that produced a flagged loss is already
    applied, so the remedy here is the guard's budget
    (``NumericalError`` after ``HOROVOD_INTEGRITY_SKIP_STEPS`` consecutive
    spikes); the skip-step policy that suppresses updates lives in
    ``DistributedOptimizer``. Off: the callable untouched."""
    if not integrity.enabled():
        return step_fn
    guard = integrity.guards.StepGuard(name="loss")

    def guarded(*args, **kwargs):
        loss = step_fn(*args, **kwargs)
        if loss.numel() == 1:  # a non-scalar loss: nothing to observe
            guard.observe(loss.item())
        return loss

    guarded.__wrapped__ = step_fn
    guarded.__integrity_guard__ = guard
    return guarded


def _with_profiler_hook(step_fn: Callable) -> Callable:
    """Mark a step boundary a call when profiling is on: the step's time is
    the call-to-call interval, and the optimizer's own boundary inside the
    call is a no-op (``profiler.nested``). Off: the callable untouched, so
    nothing synchronizes."""
    if not profiler.enabled():
        return step_fn

    def profiled(*args, **kwargs):
        profiler.auto_step()
        with profiler.nested():
            return step_fn(*args, **kwargs)

    profiled.__wrapped__ = step_fn
    return profiled


def _make_step(model: torch.nn.Module, optimizer,
               loss_fn: Optional[Callable] = None,
               grad_release=None) -> Callable:
    """An eager ``step(inputs, labels) -> loss``: zero the gradients, the
    forward in train mode (which updates the running statistics), the
    backward, the optimizer's step. The loss is returned detached, not
    read, so the step does not wait for the device.

    ``optimizer`` is a ``torch.optim`` optimizer (a
    ``DistributedOptimizer``, ``sharded_update``'s) or a step-level one
    with ``init``/``apply`` (``sharded_adamw``, ``fused_adamw``), whose
    state the step keeps. An optimizer whose ``exchanges_gradients`` is
    true (``DistributedOptimizer``, ``sharded_update``'s, ``sharded_adamw``)
    exchanges the gradients itself; for any other, without a plan, the
    step averages them over the world (``allreduce_gradients`` under the
    names ``train_step.grads.<i>``, the same every step) before the update,
    when ``init()`` has made a world of more than one rank.

    ``grad_release`` (``None`` follows ``HOROVOD_GRAD_BUCKET_RELEASE``, a
    :class:`~horovod_tpu_torch.parallel.buckets.GradReleasePlan`, or
    ``False``): the plan tags the parameters before the forward, releases
    each bucket during the backward and is gathered after it; the
    optimizer then steps inside ``prereduced()`` on the reduced gradients
    or, from a reduce-scatter plan, on the ``ShardedGrads``. With
    ``every_k > 1`` a call is one backward pass, and only every k-th
    steps."""
    loss_fn = loss_fn or default_loss_fn
    plan = _resolve_grad_release(grad_release)
    params = dict(model.named_parameters())
    step_level = hasattr(optimizer, "apply")
    box = [optimizer.init(params)] if step_level else None
    # the JAX step always takes the global batch's gradient
    # (horovod_tpu/training.py:186-195): average it here when nothing else
    # exchanges it
    averages = plan is None and not getattr(optimizer, "exchanges_gradients",
                                            False)

    def world_average() -> dict:
        """The gradients averaged over the world when the step exchanges
        them (see above) and ``init()`` made more than one rank; else {}."""
        if not (averages and basics.is_initialized() and basics.size() > 1):
            return {}
        return dp.allreduce_gradients(
            {k: p.grad for k, p in params.items() if p.grad is not None},
            name="train_step.grads")

    def zero_grad():
        if step_level:
            model.zero_grad(set_to_none=True)
        else:
            optimizer.zero_grad(set_to_none=True)

    def update(grads):
        if step_level:
            if grads is None:
                grads = {k: p.grad for k, p in params.items()}
                grads.update(world_average())
            _, box[0] = optimizer.apply(params, box[0], grads)
        elif isinstance(grads, zero.ShardedGrads):
            if not isinstance(optimizer, zero.ShardedOptimizer):
                raise TypeError(
                    "a reduce-scatter release plan's ShardedGrads go to "
                    "sharded_adamw or sharded_update, built with "
                    "partition=plan.zero_partition(params)")
            optimizer.step(grads=grads)
        else:
            for k, g in world_average().items():
                params[k].grad = g
            optimizer.step()

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        if plan is None or plan._pass_idx == 0:
            zero_grad()
        model.train()
        if plan is not None:
            plan.tag(params)
        loss = loss_fn(model(images), labels)
        loss.backward()
        if plan is None:
            update(None)
            return loss.detach()
        grads = plan.gather()
        if grads is not None:
            with buckets.prereduced():
                update(grads)
        return loss.detach()

    return step
