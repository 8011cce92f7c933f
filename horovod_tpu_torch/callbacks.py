"""Training-loop callbacks and learning-rate schedules (port of
``horovod_tpu/callbacks.py``; reference: horovod/_keras/callbacks.py).

* ``BroadcastGlobalVariablesCallback``: make every rank's state rank
  ``root_rank``'s at the start of training (reference: _keras/callbacks.py
  :20-44).
* ``MetricAverageCallback`` / :func:`average_metrics`: average epoch
  metrics over the ranks (reference: _keras/callbacks.py:46-84).
* ``LearningRateWarmupCallback`` / ``LearningRateScheduleCallback``: the
  linear-scaling warmup and multiplier schedules of "Accurate, Large
  Minibatch SGD" (reference: _keras/callbacks.py:87-181), holding the
  current rate as ``.lr`` for the loop to set.

Training loops are explicit, so a callback is a plain object the loop calls
(``on_train_begin``, ``on_epoch_end``, ...). The warmup is also a function
from the step to the rate, :func:`warmup_scaled_schedule`, the counterpart
of the JAX package's optax schedule.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import torch

from horovod_tpu_torch.core import basics
from horovod_tpu_torch.ops import collectives
from horovod_tpu_torch.parallel import dp


class Callback:
    """The callback protocol of an explicit training loop."""

    def on_train_begin(self, state):
        return state

    def on_epoch_begin(self, epoch: int, state):
        return state

    def on_epoch_end(self, epoch: int, state, metrics=None):
        return state, metrics

    def on_batch_begin(self, batch: int, state):
        return state


class BroadcastGlobalVariablesCallback(Callback):
    """Make every rank's state rank ``root_rank``'s at the start of
    training, as random init or a checkpoint restored on one rank needs
    (reference: _keras/callbacks.py:20-44). ``state`` is a module (its
    parameters and buffers) or a mapping of tensors, updated in place and
    returned."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, state):
        tensors = (state.state_dict() if isinstance(state, torch.nn.Module)
                   else state)
        dp.broadcast_parameters(tensors, root_rank=self.root_rank)
        return state


class MetricAverageCallback(Callback):
    """Average metrics over the ranks at epoch end, so the reported values
    are the whole job's (reference: _keras/callbacks.py:46-84)."""

    def on_epoch_end(self, epoch: int, state,
                     metrics: Optional[Mapping] = None):
        if metrics is None:
            return state, metrics
        return state, average_metrics(metrics)


def average_metrics(metrics: Mapping) -> dict:
    """Functional form of ``MetricAverageCallback``: each value (a number
    or a tensor) averaged over the ranks, as a tensor on the port's device
    (named ``metrics.<key>``, the same on every rank)."""
    device = basics.device()
    return {k: collectives.allreduce(
                torch.as_tensor(v, device=device), average=True,
                name=f"metrics.{k}")
            for k, v in metrics.items()}


def warmup_scaled_schedule(
    base_lr: float,
    warmup_epochs: float,
    steps_per_epoch: int,
    size: Optional[int] = None,
    after: Optional[Callable[[float], float]] = None,
    initial_lr: Optional[float] = None,
) -> Callable[[int], float]:
    """The rate at a step: a linear ramp from ``base_lr`` (or
    ``initial_lr``) to ``base_lr * size`` over ``warmup_epochs``, then
    ``after(epochs past the warmup)`` times the scaled rate, or flat
    (reference: _keras/callbacks.py:87-181): large-batch training scales
    the rate by the number of workers and warms up from one worker's rate
    to avoid early divergence.

    With ``torch.optim.lr_scheduler.LambdaLR``, whose factor multiplies the
    optimizer's initial rate, build the optimizer at ``base_lr`` and divide::

        sched = warmup_scaled_schedule(0.1, warmup_epochs=5,
                                       steps_per_epoch=len(loader))
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        lr_sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: sched(step) / 0.1)
        # ... lr_sched.step() after each optimizer step
    """
    if size is None:
        size = basics.size()
    scaled = base_lr * size
    start = initial_lr if initial_lr is not None else base_lr
    warmup_steps = max(int(warmup_epochs * steps_per_epoch), 1)

    def schedule(step: int) -> float:
        if after is not None and step >= warmup_steps:
            return scaled * after(
                max((step - warmup_steps) / steps_per_epoch, 0.0))
        return start + (scaled - start) * min(step / warmup_steps, 1.0)

    return schedule


class LearningRateWarmupCallback(Callback):
    """Eager-loop form of :func:`warmup_scaled_schedule`, holding the
    current rate as ``self.lr``; the loop reads it each batch (reference:
    _keras/callbacks.py:129-181)."""

    def __init__(self, base_lr: float, warmup_epochs: float = 5.0,
                 steps_per_epoch: int = 1, size: Optional[int] = None,
                 verbose: bool = False):
        self._schedule = warmup_scaled_schedule(
            base_lr, warmup_epochs, steps_per_epoch, size=size)
        self._step = 0
        self.verbose = verbose
        self.lr = float(self._schedule(0))

    def on_batch_begin(self, batch: int, state):
        self.lr = float(self._schedule(self._step))
        self._step += 1
        return state


class LearningRateScheduleCallback(Callback):
    """Multiplier schedule: ``lr = base_lr * multiplier(epoch)``, staircase
    or smooth (reference: _keras/callbacks.py:87-127)."""

    def __init__(self, base_lr: float,
                 multiplier: Callable[[float], float],
                 start_epoch: float = 0.0,
                 end_epoch: Optional[float] = None,
                 staircase: bool = True):
        self.base_lr = base_lr
        self.multiplier = multiplier
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.lr = base_lr

    def on_epoch_begin(self, epoch: int, state):
        if epoch < self.start_epoch or (
                self.end_epoch is not None and epoch >= self.end_epoch):
            return state
        e = math.floor(epoch) if self.staircase else epoch
        self.lr = self.base_lr * self.multiplier(e)
        return state
