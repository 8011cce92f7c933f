"""Parallelism strategies of the port (port of
``horovod_tpu/parallel/__init__.py``): data parallel and ZeRO. The
sequence-parallel ``ring_attention`` and ``ulysses_attention`` come with
ROADMAP A9."""

from horovod_tpu_torch.parallel.dp import (
    DistributedGradientTape,
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.ops.collectives import broadcast_object
from horovod_tpu_torch.parallel.zero import (
    FlatAdamState,
    ShardedOptState,
    sharded_adamw,
    sharded_update,
)

__all__ = [
    "DistributedOptimizer",
    "DistributedGradientTape",
    "allreduce_gradients",
    "broadcast_parameters",
    "broadcast_optimizer_state",
    "broadcast_object",
    "sharded_update",
    "sharded_adamw",
    "ShardedOptState",
    "FlatAdamState",
]
