"""The eager training step of the data-parallel examples and benchmarks.

Port of the part of ``horovod_tpu/training.py`` that the Inception-V3 path
runs: the default loss and a train step. The JAX package jits one step
(or a ``lax.scan`` round of steps) over the global batch; here a step is
eager PyTorch, one process per GPU, and the gradient allreduce is the
hooks' of :func:`horovod_tpu_torch.DistributedOptimizer`.
``create_train_state``'s broadcast of ``params`` and ``batch_stats`` from
rank 0 is ``hvd.broadcast_parameters(model.state_dict(), root_rank=0)``:
the state dict holds both.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def default_loss_fn(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """``optax.softmax_cross_entropy_with_integer_labels(logits,
    labels).mean()``, in float32."""
    return F.cross_entropy(logits.float(), labels.long())


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """An eager ``step(images, labels) -> loss``: zero the gradients, the
    forward in train mode (which updates the running statistics), the
    backward, ``optimizer.step()``. The loss is returned detached, not
    read, so the step does not wait for the device."""
    loss_fn = loss_fn or default_loss_fn

    def step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        model.train()
        loss = loss_fn(model(images), labels)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
