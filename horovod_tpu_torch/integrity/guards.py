"""Step-level numerical guards: EWMA spike detection and the skip-step
policy (port of ``horovod_tpu/integrity/guards.py``).

:class:`StepGuard` keeps an exponentially weighted mean and variance of a
scalar stream (the loss or the global gradient norm) and flags values that
are non-finite or spike above ``mean + sigma * std``. A flagged step is
skipped (the optimizer's update suppressed, the batch consumed) up to
``HOROVOD_INTEGRITY_SKIP_STEPS`` consecutive times; past that budget the
guard raises :class:`~horovod_tpu_torch.exceptions.NumericalError`.

The guard observes globally reduced values (the averaged gradients' norm),
so every rank sees the same stream, skips the same steps and raises on the
same step, with no agreement traffic.

On the card :func:`guard_gradients` reduces the norm on the gradients'
device, in float64 as the JAX package accumulates it, and reads it with one
``.item()`` a step: one wait for the device a step, only while
``HOROVOD_INTEGRITY`` is on. Each spike is an ``integrity_spike`` flight
event.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from horovod_tpu_torch import exceptions
from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.metrics import registry as _metrics
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import (HOROVOD_INTEGRITY_SKIP_STEPS,
                                         HOROVOD_INTEGRITY_SPIKE_SIGMA,
                                         _get_float, _get_int)

DEFAULT_SPIKE_SIGMA = 6.0
DEFAULT_SKIP_STEPS = 3

_SKIPPED = _metrics().counter(
    "horovod_integrity_skipped_steps_total",
    "Optimizer steps suppressed by the integrity spike guard.")


class StepGuard:
    """EWMA spike detector over one scalar training statistic.

    ``observe(v)`` returns True to accept the step, False to skip it; it
    raises :class:`NumericalError` once more than ``skip_budget``
    consecutive steps have been skipped. Single-threaded: the training
    loop's thread.
    """

    def __init__(self, sigma: Optional[float] = None,
                 skip_budget: Optional[int] = None,
                 warmup: int = 5, decay: float = 0.9,
                 name: str = "loss") -> None:
        self.sigma = sigma if sigma is not None else _get_float(
            HOROVOD_INTEGRITY_SPIKE_SIGMA, DEFAULT_SPIKE_SIGMA)
        self.skip_budget = skip_budget if skip_budget is not None \
            else _get_int(HOROVOD_INTEGRITY_SKIP_STEPS, DEFAULT_SKIP_STEPS)
        self.warmup = warmup
        self.decay = decay
        self.name = name
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.consecutive_skips = 0

    def _is_spike(self, v: float) -> bool:
        if not math.isfinite(v):
            return True
        if self.n < self.warmup:
            return False
        std = math.sqrt(max(self.var, 0.0))
        # one-sided upward test with a small relative slack: a constant
        # stream has std ~= 0 and must not trip on float jitter, and a drop
        # in the statistic is progress, never a spike
        slack = 1e-6 + 1e-3 * abs(self.mean)
        return v > self.mean + self.sigma * std + slack

    def observe(self, v: float) -> bool:
        v = float(v)
        if self._is_spike(v):
            self.consecutive_skips += 1
            _SKIPPED.inc()
            flight_recorder.emit(
                "integrity_spike", stat=self.name, value=repr(v),
                mean=self.mean, std=math.sqrt(max(self.var, 0.0)),
                consecutive=self.consecutive_skips, budget=self.skip_budget)
            log.warning(
                "integrity guard: %s spike (%r vs mean %.6g std %.3g), "
                "skipping step (%d/%d consecutive)", self.name, v,
                self.mean, math.sqrt(max(self.var, 0.0)),
                self.consecutive_skips, self.skip_budget)
            if self.consecutive_skips > self.skip_budget:
                raise exceptions.NumericalError(
                    f"integrity guard: {self.name} spiked on "
                    f"{self.consecutive_skips} consecutive steps "
                    f"(budget {self.skip_budget}); last value {v!r}, "
                    f"EWMA mean {self.mean:.6g}", tensor=self.name)
            return False
        self.consecutive_skips = 0
        # EW moments (West-style update): the first value seeds the mean
        if self.n == 0:
            self.mean = v
        else:
            diff = v - self.mean
            incr = (1.0 - self.decay) * diff
            self.mean += incr
            self.var = self.decay * (self.var + diff * incr)
        self.n += 1
        return True

    def reset(self) -> None:
        self.mean = 0.0
        self.var = 0.0
        self.n = 0
        self.consecutive_skips = 0


# the process's guard for the DistributedOptimizer hook: one stream of
# global gradient norms a process
_default_guard: Optional[StepGuard] = None


def default_guard() -> StepGuard:
    global _default_guard
    if _default_guard is None:
        _default_guard = StepGuard(name="grad_norm")
    return _default_guard


def reset() -> None:
    """Drop the process's guard (tests; an elastic re-form)."""
    global _default_guard
    _default_guard = None


def global_norm(grads) -> float:
    """The global L2 norm of a dict or list of gradient tensors, summed in
    float64 on their device and read with one ``.item()``. The real
    gradients go through one ``cat`` and one norm: a norm a tensor costs a
    launch a tensor, which on the card is the guard's whole price. Integer
    tensors are left out; a sparse gradient counts its values. NaN and inf
    propagate, so one bad element makes the whole norm non-finite."""
    tensors = grads.values() if isinstance(grads, dict) else grads
    real, other = [], []
    for g in tensors:
        if g is None or not (g.is_floating_point() or g.is_complex()):
            continue
        if g.is_sparse:
            g = g.coalesce().values()
        (real if g.is_floating_point() else other).append(g.reshape(-1))
    parts = [torch.linalg.vector_norm(g).double() for g in other]
    if real:
        parts.append(torch.linalg.vector_norm(torch.cat(real),
                                              dtype=torch.float64))
    if not parts:
        return 0.0
    return torch.linalg.vector_norm(torch.stack(parts)).item()


def guard_gradients(grads) -> bool:
    """Observe the global gradient norm of (already averaged) gradients, a
    dict or a list of tensors; True: apply the update, False: skip it."""
    return default_guard().observe(global_norm(grads))
