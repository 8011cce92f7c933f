"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` gives the data-parallel surface of the
JAX package in PyTorch: ``hvd.init()``, ``hvd.DistributedOptimizer`` with
per-parameter gradient hooks that start async allreduces, the broadcasts
for the checkpoint-on-rank-0 convention, reduce-scatter and allgather,
ZeRO-1 ``sharded_adamw``, and ``flash_attention`` on hand-written Hopper
kernels (``csrc/``). The replicated fused AdamW is
``horovod_tpu_torch.ops.fused_adamw.fused_adamw``. Collectives run on
``torch.distributed``: NCCL between GPUs, gloo on the CPU.

Entry points run on the card unless the caller asks for the CPU
(``hvd.init(device="cpu")``). Nothing here imports JAX or the JAX package.
"""

from horovod_tpu_torch.compression import Compression  # noqa: F401
from horovod_tpu_torch.core.basics import (  # noqa: F401
    cross_rank,
    cross_size,
    device,
    gloo_built,
    init,
    is_initialized,
    local_rank,
    local_size,
    nccl_built,
    rank,
    shutdown,
    size,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    Average,
    Handle,
    Max,
    Min,
    Product,
    Sum,
    allreduce,
    allreduce_,
    allreduce_async,
    allreduce_async_,
    allgather,
    allgather_async,
    broadcast,
    broadcast_,
    broadcast_async,
    broadcast_async_,
    grouped_allreduce,
    poll,
    reducescatter,
    reducescatter_async,
    synchronize,
)
from horovod_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_partial,
)
from horovod_tpu_torch.parallel.dp import (  # noqa: F401
    DistributedOptimizer,
    allreduce_gradients,
    broadcast_optimizer_state,
    broadcast_parameters,
)
from horovod_tpu_torch.parallel.zero import (  # noqa: F401
    FlatAdamState,
    ShardedAdamW,
    sharded_adamw,
)
from horovod_tpu_torch.version import __version__  # noqa: F401
