"""Metric families of the checkpoint layer (port of
``horovod_tpu/ckpt/stats.py``: the same names, help texts and buckets, on
the port's registry). Defined once here and read by the writer, the
restore path and the shard container."""

from __future__ import annotations

from horovod_tpu_torch.metrics import CKPT_COMMIT_BUCKETS, registry as _metrics

COMMITS = _metrics().counter(
    "horovod_ckpt_commits_total",
    "Checkpoint commits attempted (per rank; includes commits later "
    "abandoned at the barrier).")
COMMIT_SECONDS = _metrics().histogram(
    "horovod_ckpt_commit_seconds",
    "End-to-end wall time of one checkpoint commit on this rank: "
    "serialize + stage + barrier + publish (the async writer observes "
    "this off-thread; the inline snapshot cost is "
    "horovod_ckpt_snapshot_seconds).", buckets=CKPT_COMMIT_BUCKETS)
SNAPSHOT_SECONDS = _metrics().histogram(
    "horovod_ckpt_snapshot_seconds",
    "Inline (training-thread) cost of one commit: device->host-slab "
    "copy-on-commit plus writer handoff — the step-time overhead the "
    "<2% goal budgets.", buckets=CKPT_COMMIT_BUCKETS)
BYTES = _metrics().counter(
    "horovod_ckpt_bytes_total",
    "Checkpoint bytes written by this rank (own shard + neighbor "
    "replica + replicated-state slice).")
REPLICA_RESTORES = _metrics().counter(
    "horovod_ckpt_replica_restores_total",
    "Dead-rank ZeRO shard segments restored from a neighbor replica "
    "(instead of falling back to zeros / recomputed fill).")
INTEGRITY_FAILURES = _metrics().counter(
    "horovod_ckpt_integrity_failures_total",
    "Checkpoint files or leaves that failed CRC/structure verification "
    "on restore.")
COMMITS_ABANDONED = _metrics().counter(
    "horovod_ckpt_commits_abandoned_total",
    "Commits abandoned before publishing (barrier timeout, a peer died "
    "mid-commit, or a generation change) — the previous manifest stays "
    "authoritative.")
RESTORE_SECONDS = _metrics().histogram(
    "horovod_ckpt_restore_seconds",
    "Wall time of restore_latest on this rank.",
    buckets=CKPT_COMMIT_BUCKETS)
