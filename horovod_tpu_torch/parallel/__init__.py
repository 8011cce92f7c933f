"""Parallelism strategies of the port (port of
``horovod_tpu/parallel/__init__.py``): data parallel, sparse embedding
gradients (``SparseGrad``, ``sparse_allgather``,
``with_sparse_embedding_grad``), ZeRO, expert parallelism
(``switch_moe``, ``load_balance_loss``, ``default_capacity``, with
``stack_stage_params``) and the sequence-parallel ``ring_attention`` and
``ulysses_attention``. Tensor and pipeline parallelism are the modules
``parallel.tp`` and ``parallel.pp``."""

from horovod_tpu_torch.parallel.dp import (
    DistributedGradientTape,
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.ops.collectives import broadcast_object
from horovod_tpu_torch.parallel._util import stack_stage_params
from horovod_tpu_torch.parallel.ring import ring_attention
from horovod_tpu_torch.parallel.ulysses import ulysses_attention
from horovod_tpu_torch.parallel.sparse import (
    SparseGrad,
    sparse_allgather,
    with_sparse_embedding_grad,
)
from horovod_tpu_torch.parallel.ep import (
    default_capacity,
    load_balance_loss,
    switch_moe,
)
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
    "ring_attention",
    "ulysses_attention",
    "sharded_update",
    "sharded_adamw",
    "ShardedOptState",
    "FlatAdamState",
    "SparseGrad",
    "sparse_allgather",
    "with_sparse_embedding_grad",
    "switch_moe",
    "load_balance_loss",
    "default_capacity",
    "stack_stage_params",
]
