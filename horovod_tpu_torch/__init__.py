"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` gives the surface of the JAX package's
PyTorch binding (``horovod_tpu.torch``), in its order, but ``mesh``, which
has no counterpart here: ``hvd.init()`` and the capability probes,
``hvd.DistributedOptimizer`` with per-parameter gradient hooks that start
async allreduces (sparse gradients by the sparse allreduce, or densified),
the broadcasts for the checkpoint-on-rank-0 convention, the collectives
(allreduce, allgather with a ragged dim 0, broadcast, reduce-scatter,
alltoall; allreduce, allgather and broadcast differentiable). Beyond it:
``grouped_allreduce``, the bucket-wise gradient release
(``GradReleasePlan``), ZeRO stages 1-3 (``sharded_adamw``,
``sharded_update``, ``scatter_gradients``, ``shard_params``,
``gather_params``, ``iter_param_buckets``), and ``flash_attention`` on
hand-written Hopper kernels (``csrc/``). The replicated fused AdamW is
``horovod_tpu_torch.ops.fused_adamw.fused_adamw``. Every collective goes
through the enqueue runtime (``runtime/``): named, negotiated across the
ranks, allreduces fused into one call a bin, on ``torch.distributed``
(NCCL between GPUs, gloo on the CPU); ``hvd.metrics()`` is its metrics
registry's snapshot. ``hvd.training`` (``create_train_state``,
``make_train_step``, ``make_train_round``), ``hvd.callbacks``,
``hvd.profiler`` (the step profiler) and ``hvd.integrity`` (the step
guard) are modules of the package.

Entry points run on the card unless the caller asks for the CPU
(``hvd.init(device="cpu")``). Nothing here imports JAX or the JAX package.
"""

# The metrics module is loaded before ``metrics`` (the function) is bound
# below: a submodule's first import makes it an attribute of the package,
# which would otherwise replace the function. The same holds for every
# module attribute, so they all come first.
import horovod_tpu_torch.metrics  # noqa: F401
from horovod_tpu_torch import profiler  # noqa: F401
from horovod_tpu_torch import integrity  # noqa: F401
from horovod_tpu_torch import training  # noqa: F401
from horovod_tpu_torch import callbacks  # noqa: F401

from horovod_tpu_torch.core.basics import (  # noqa: F401
    init,
    shutdown,
    is_initialized,
    rank,
    size,
    local_rank,
    local_size,
    cross_rank,
    cross_size,
    is_homogeneous,
    mpi_built,
    gloo_built,
    nccl_built,
    xla_built,
    mpi_enabled,
    mpi_threads_supported,
    device,
    metrics,
)
from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Average,
    Max,
    Min,
    Product,
    Sum,
    allgather,
    allgather_async,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    alltoall,
    alltoall_async,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    poll,
    reducescatter,
    reducescatter_async,
    sparse_allreduce_async,
    synchronize,
)
from horovod_tpu_torch.parallel.dp import (  # noqa: F401
    DistributedOptimizer,
    broadcast_parameters,
    broadcast_optimizer_state,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    broadcast_object,
    Handle,
    SparseHandle,
    grouped_allreduce,
)
from horovod_tpu_torch.parallel.dp import allreduce_gradients  # noqa: F401
from horovod_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_partial,
)
from horovod_tpu_torch.parallel.buckets import GradReleasePlan  # noqa: F401
from horovod_tpu_torch.parallel.zero import (  # noqa: F401
    sharded_update,
    sharded_adamw,
    ShardedOptState,
    FlatAdamState,
    ShardedGrads,
    ShardedParams,
    scatter_gradients,
    shard_params,
    gather_params,
    iter_param_buckets,
    ShardedAdamW,
)
from horovod_tpu_torch.version import __version__  # noqa: F401
