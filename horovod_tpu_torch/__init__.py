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
``gather_params``, ``iter_param_buckets``), expert parallelism
(``switch_moe`` over the runtime's all-to-all, ``load_balance_loss``,
``default_capacity``, ``stack_stage_params``), model parallelism over the
axes' own process groups (``ring_attention`` and ``ulysses_attention`` on
the flash kernels, Megatron's ``tp_train_step`` with
``transformer_tp_rules``, ``params_shardings`` and ``xla_attention``, the
GPipe ``pipeline_apply`` with ``last_stage_value``), the ordered-lane
guard (``assert_collective_lane_clear``, ``OrderedLaneError``), sparse
embedding gradients
(``with_sparse_embedding_grad``, ``SparseGrad``, ``sparse_allgather``),
and ``flash_attention`` on
hand-written Hopper kernels (``csrc/``). The replicated fused AdamW is
``horovod_tpu_torch.ops.fused_adamw.fused_adamw``. Every collective goes
through the enqueue runtime (``runtime/``): named, negotiated across the
ranks, allreduces fused into one call a bin, on ``torch.distributed``
(NCCL between GPUs, gloo on the CPU); ``hvd.metrics()`` is its metrics
registry's snapshot. ``hvd.training`` (``create_train_state``,
``make_train_step``, ``make_train_round``), ``hvd.callbacks``,
``hvd.profiler`` (the step profiler) and ``hvd.integrity`` (the step
guard) are modules of the package, as are ``hvd.checkpoint`` (rank 0
saves, every rank restores by a broadcast) and ``hvd.ckpt`` (the sharded
two-phase checkpoint with neighbour replicas); a damaged checkpoint raises
``hvd.CheckpointCorruptError``. ``hvd.elastic`` (``run``, ``State``,
``ObjectState``, ``ArrayState``, ``restarts``) re-forms a world that lost a
worker through the rendezvous store (``horovod_tpu_torch.run``) and
``hvd.reinit()``, and rolls back in place after an integrity verdict.
``HOROVOD_HIERARCHICAL_ALLREDUCE`` / ``_ALLGATHER`` run the collectives in
two levels over sub-communicators (``runtime/hierarchy.py``) and
``HOROVOD_AUTOTUNE`` tunes the runtime's knobs while training runs
(``horovod_tpu_torch.autotune``). The
observability planes are modules too: ``hvd.flight_recorder`` (the event
ring and its dumps, ``hvd.dump_debug_state()``), ``hvd.memory`` (the byte
ledger against the CUDA allocator), ``hvd.comms`` (each collective's
bandwidth, timed by CUDA events on the card) and ``hvd.goodput`` (the
productive share of the wall-clock and its incidents), and so is
``hvd.tracing`` (request spans and the SLO plane). ``hvd.serve(model,
...)`` serves a causal ``Transformer`` with continuous batching over a
KV cache, dense or paged (``ServePolicy``; the package
``horovod_tpu_torch.serve``).

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
from horovod_tpu_torch import checkpoint  # noqa: F401
from horovod_tpu_torch import ckpt  # noqa: F401
from horovod_tpu_torch import elastic  # noqa: F401
from horovod_tpu_torch import flight_recorder  # noqa: F401
from horovod_tpu_torch import memory  # noqa: F401
from horovod_tpu_torch import comms  # noqa: F401
from horovod_tpu_torch import goodput  # noqa: F401
from horovod_tpu_torch import tracing  # noqa: F401

from horovod_tpu_torch.core.basics import (  # noqa: F401
    init,
    reinit,
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
    ddl_built,
    mlsl_built,
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
    grouped_allreduce_async,
)
from horovod_tpu_torch.parallel.dp import (  # noqa: F401
    allreduce_gradients,
    DistributedGradientTape,
)
from horovod_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_partial,
)
from horovod_tpu_torch.parallel.buckets import GradReleasePlan  # noqa: F401
from horovod_tpu_torch.parallel._util import stack_stage_params  # noqa: F401
from horovod_tpu_torch.parallel.sparse import (  # noqa: F401
    SparseGrad,
    sparse_allgather,
    with_sparse_embedding_grad,
)
from horovod_tpu_torch.parallel.ep import (  # noqa: F401
    default_capacity,
    load_balance_loss,
    switch_moe,
)
from horovod_tpu_torch.parallel.ring import ring_attention  # noqa: F401
from horovod_tpu_torch.parallel.ulysses import ulysses_attention  # noqa: F401
from horovod_tpu_torch.parallel.tp import (  # noqa: F401
    params_shardings,
    tp_train_step,
    transformer_tp_rules,
    xla_attention,
)
from horovod_tpu_torch.parallel.pp import (  # noqa: F401
    last_stage_value,
    pipeline_apply,
)
from horovod_tpu_torch.ops.collectives import (  # noqa: F401
    OrderedLaneError,
    assert_collective_lane_clear,
)
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
from horovod_tpu_torch.exceptions import (  # noqa: F401
    CheckpointCorruptError,
    CollectiveIntegrityError,
    HorovodInternalError,
    HostsUpdatedInterrupt,
    NumericalError,
    WorkerLostError,
    WorkersDownError,
    WorkerStallError,
)
from horovod_tpu_torch.flight_recorder import dump_debug_state  # noqa: F401
# ``hvd.serve(model, ...)`` is the function: this binding replaces the
# package attribute that importing ``horovod_tpu_torch.serve`` set, and
# the package stays reachable through ``sys.modules``
# (``horovod_tpu_torch.serve.kv_cache`` imports as before).
from horovod_tpu_torch.serve import ServePolicy, serve  # noqa: F401
from horovod_tpu_torch.version import __version__  # noqa: F401
