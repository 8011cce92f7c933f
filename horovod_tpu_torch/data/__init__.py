"""Rank-sharded sampling and device prefetch (port of
``horovod_tpu/data/__init__.py``).

The reference leaves input pipelines to the frameworks but fixes the
convention in every example: shard the dataset by rank so each worker sees
a disjoint 1/size slice, reshuffled each epoch with a common seed
(reference: examples/pytorch_mnist.py,
``DistributedSampler(num_replicas=hvd.size(), rank=hvd.rank())``).

* :class:`ShardedSampler`: those semantics, the JAX package's sampler to
  the index (the same ``numpy`` permutation of ``seed + epoch``, padded by
  wrap-around, rank-strided).
* :func:`prefetch_to_device`: a background thread keeps ``size`` batches
  ahead of the consumer. The JAX package's ``sharding=`` is ``device=``
  here: the port has no device mesh. For a CUDA device each batch's
  tensors are pinned and copied on a copy stream of the prefetcher's own;
  the consumer's current stream waits on an event recorded after the
  batch's copy, and each tensor is recorded on that stream
  (``record_stream``) so the caching allocator does not hand its memory to
  a later copy while the consumer's kernels still read it. A tensor that
  cannot be pinned or copied raises: the prefetcher never hands back a
  host tensor for a CUDA device. For the CPU it passes tensors through
  (numpy arrays become tensors without a copy).
* ``torch.utils.data.distributed.DistributedSampler(num_replicas=
  hvd.size(), rank=hvd.rank())`` works as in the reference.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["ShardedSampler", "prefetch_to_device"]


class ShardedSampler:
    """One worker's view of a dataset: disjoint shards of equal length
    under a common per-epoch shuffle. ``dataset_size`` need not divide
    ``num_replicas``: indices wrap around so every worker yields
    ``ceil(n / num_replicas)`` indices an epoch and collectives stay in
    lockstep. ``num_replicas`` and ``rank`` default to ``hvd.size()`` and
    ``hvd.rank()``."""

    def __init__(self, dataset_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0):
        from horovod_tpu_torch.core import basics

        if num_replicas is None:
            num_replicas = basics.size()
        if rank is None:
            rank = basics.rank()
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for num_replicas {num_replicas}")
        if dataset_size <= 0:
            raise ValueError("dataset_size must be positive")
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_size // num_replicas)  # ceil
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle for a new epoch: the same permutation on every worker
        (``seed + epoch``), a different shard a rank."""
        self.epoch = int(epoch)

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self.epoch).permutation(self.dataset_size)
        else:
            order = np.arange(self.dataset_size)
        pad = self.total_size - self.dataset_size
        if pad:
            order = np.concatenate([order, order[:pad]])
        return iter(order[self.rank::self.num_replicas].tolist())

    def __len__(self) -> int:
        return self.num_samples


_END = object()


def _map(fn, batch):
    """``fn`` on every tensor or numpy array of a batch of nested dicts,
    lists and tuples; other leaves pass through."""
    if isinstance(batch, (torch.Tensor, np.ndarray)):
        return fn(batch)
    if isinstance(batch, dict):
        return type(batch)((k, _map(fn, v)) for k, v in batch.items())
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(_map(fn, v) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return batch


def _leaves(batch):
    if isinstance(batch, torch.Tensor):
        yield batch
    elif isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _leaves(v)


def _as_tensor(x) -> torch.Tensor:
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       device: Union[str, torch.device, None] = None):
    """Iterate ``iterator``'s batches with up to ``size`` of them already
    on ``device`` (default: ``hvd.device()``). Batches are tensors, numpy
    arrays, or dicts, lists and tuples of them.

    The copies run on a background thread; for a CUDA device on a copy
    stream of their own from pinned host memory, ordered before the
    consumer's stream by an event. An error of the source iterator reaches
    the consumer at its position. ``close()`` on the generator (or its
    collection) stops the worker thread."""
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    if device is None:
        from horovod_tpu_torch.core import basics

        device = basics.device()
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    q: queue_mod.Queue = queue_mod.Queue(maxsize=size)
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(dev) if cuda else None

    def to_device(x):
        t = _as_tensor(x)
        if t.device.type == "cuda":
            if t.device != dev:
                raise ValueError(f"batch tensor on {t.device}, prefetching "
                                 f"to {dev}")
            return t
        if not t.is_pinned():
            t = t.pin_memory()  # raises when it cannot pin
        return t.to(dev, non_blocking=True)

    def put(batch):
        if not cuda:
            return _map(_as_tensor, batch), None
        with torch.cuda.stream(copy_stream):
            moved = _map(to_device, batch)
            done = torch.cuda.Event()
            done.record(copy_stream)
        return moved, done

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(dev)
            for batch in iterator:
                if stop.is_set():
                    return
                q.put(put(batch))
                if stop.is_set():
                    return
            q.put(_END)
        except BaseException as exc:  # noqa: BLE001 - relayed to consumer
            q.put(exc)

    thread = threading.Thread(target=worker, daemon=True,
                              name="hvd-data-prefetch")

    def gen():
        # started lazily: a generator never consumed starts no thread
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, done = item
                if done is not None:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(done)
                    for t in _leaves(batch):
                        t.record_stream(consumer)
                yield batch
        finally:
            stop.set()
            # unblock a worker stuck on a full queue
            try:
                q.get_nowait()
            except queue_mod.Empty:
                pass

    return gen()
