"""Crash-consistent distributed checkpointing (port of
``horovod_tpu/ckpt``, with its exports).

Sharded two-phase snapshots (every rank writes only its ZeRO shard plus
its round-robin slice of the replicated state), a commit barrier on the
world's c10d store with an atomically published per-step manifest as the
commit point, neighbour replication of shard bytes, and restore into any
world size.

Modules:

* :mod:`~horovod_tpu_torch.ckpt.io`: CRCs, pid-named tmps, fsync'd renames.
* :mod:`~horovod_tpu_torch.ckpt.manifest`: the shard container + manifest.
* :mod:`~horovod_tpu_torch.ckpt.tree`: the JAX package's flatten order.
* :mod:`~horovod_tpu_torch.ckpt.writer`: :class:`CheckpointManager`, the
  host-slab snapshot and the stage/barrier/publish protocol on a
  background writer thread.
* :mod:`~horovod_tpu_torch.ckpt.restore`: ``restore_latest`` with replica
  fallback and re-slicing into the current world size.
* :mod:`~horovod_tpu_torch.ckpt.replica`: the neighbour-replica ring.
* :mod:`~horovod_tpu_torch.ckpt.stats`: the ``horovod_ckpt_*`` families.
"""

from horovod_tpu_torch.ckpt import (io, manifest, replica, restore, stats,
                                    tree, writer)
from horovod_tpu_torch.ckpt.restore import (latest_step, restore_latest,
                                            restore_step)
from horovod_tpu_torch.ckpt.writer import CheckpointManager, parse_fault
from horovod_tpu_torch.exceptions import CheckpointCorruptError

__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "io",
    "latest_step",
    "manifest",
    "parse_fault",
    "replica",
    "restore",
    "restore_latest",
    "restore_step",
    "stats",
    "tree",
    "writer",
]
