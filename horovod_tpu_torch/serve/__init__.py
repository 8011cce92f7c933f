"""Online inference plane: continuous batching over the port's models
(port of ``horovod_tpu/serve/``).

* ``api``      — ``hvd.serve()``, :class:`ServePolicy`, ``serve_state()``
* ``queue``    — shared request queue (in-process + rendezvous-KV)
* ``batcher``  — iteration-level admission/retire scheduling
* ``kv_cache`` — per-slot KV cache, the bucketed prefills and the decode
  step (a CUDA graph on the card)
* ``paging``   — paged KV cache: block pool, prefix reuse, COW sharing
* ``replica``  — the per-replica loop; ``run_kv_replica`` for fleets
* ``__main__`` — the ``python -m horovod_tpu_torch.serve`` replica worker

``hvd.serve`` is the function :func:`serve`; this package stays
importable as ``horovod_tpu_torch.serve`` (``sys.modules``), so
``from horovod_tpu_torch.serve.kv_cache import DecodeEngine`` works after
``import horovod_tpu_torch``.
"""

from horovod_tpu_torch.serve.api import (ServeHandle, ServePolicy, serve,
                                         serve_state)
from horovod_tpu_torch.serve.batcher import ContinuousBatcher
from horovod_tpu_torch.serve.kv_cache import DecodeEngine, prompt_bucket
from horovod_tpu_torch.serve.paging import (PagedDecodeEngine, PagePool,
                                            PagePoolExhausted, PrefixCache,
                                            total_pool_bytes)
from horovod_tpu_torch.serve.queue import (Completion, KVQueueFrontend,
                                           KVQueueReplica, QueueFull, Request,
                                           RequestQueue)
from horovod_tpu_torch.serve.replica import Replica, run_kv_replica

__all__ = [
    "Completion", "ContinuousBatcher", "DecodeEngine", "KVQueueFrontend",
    "KVQueueReplica", "PagePool", "PagePoolExhausted", "PagedDecodeEngine",
    "PrefixCache", "QueueFull", "Replica", "Request", "RequestQueue",
    "ServeHandle", "ServePolicy", "prompt_bucket", "run_kv_replica",
    "serve", "serve_state", "total_pool_bytes",
]
