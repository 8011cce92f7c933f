"""The eager training step of the data-parallel examples and benchmarks.

Port of the part of ``horovod_tpu/training.py`` that the port's paths
run: the default loss and a train step, with the bucket-wise gradient
release (``parallel/buckets.py``). The JAX package jits one step (or a
``lax.scan`` round of steps) over the global batch; here a step is eager
PyTorch, one process per GPU, and the gradient exchange is the
optimizer's own (the hooks of :func:`horovod_tpu_torch.DistributedOptimizer`,
the ZeRO optimizers' reduce-scatter), a release plan's or, when neither
exchanges, the step's: it averages the gradients over the world, so every
optimizer sees the global batch's gradient as the JAX step does.
``create_train_state``'s broadcast of ``params`` and ``batch_stats`` from
rank 0 is ``hvd.broadcast_parameters(model.state_dict(), root_rank=0)``:
the state dict holds both.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from horovod_tpu_torch.core import basics
from horovod_tpu_torch.parallel import buckets, dp, zero


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
