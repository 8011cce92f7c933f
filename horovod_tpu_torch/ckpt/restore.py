"""Restore the newest consistent checkpoint cut (port of
``horovod_tpu/ckpt/restore.py:44-249``).

``restore_latest`` walks the published manifests newest first and, for the
first one whose files check out, rebuilds the full state:

* **replicated** leaves come straight from whichever rank's shard file
  round-robin-owned them;
* **sharded** leaves (ZeRO) are reassembled into FULL flat buffers from
  every rank's ``own`` segments, then re-sliced for the *current* world
  size by :func:`horovod_tpu_torch.parallel.zero.from_full_buffers`: the
  manifest records the writing layout, so a restore into another world
  size is a re-slice, not an error;
* a missing or corrupt shard file falls back to the ``replica`` section of
  its left neighbour's file, so any single-file loss a checkpoint is
  recoverable;
* an unrecoverable cut is skipped with a warning and the next-older one is
  tried: a torn commit never shadows an intact one. If every cut is
  damaged the last error is raised.

A restore is a ``ckpt_restore`` flight event, and a shard recovered from
its neighbour's replica ``ckpt_restore_replica``.

The restored trees take the targets' structure and devices: a tensor leaf
comes back as a tensor on its target's device, a numpy leaf as a numpy
array, a Python scalar as a Python scalar, a sharded state as a new state
of the target's layout. All integrity damage is a
:class:`~horovod_tpu_torch.exceptions.CheckpointCorruptError` carrying the
file path and the leaf key.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import stats
from horovod_tpu_torch.ckpt import tree as tree_mod
from horovod_tpu_torch.exceptions import CheckpointCorruptError
from horovod_tpu_torch.parallel import zero
from horovod_tpu_torch.utils import logging as log
from horovod_tpu_torch.utils.env import HOROVOD_CKPT_VERIFY, _get_bool


def latest_step(directory: str) -> Optional[int]:
    steps = mf.all_steps(directory)
    return steps[-1] if steps else None


def _read_rank_entries(directory: str, manifest: dict, verify: bool
                       ) -> Dict[int, List[dict]]:
    """Per old-rank entry lists, the left neighbour's ``replica`` section
    standing in for any unreadable file."""
    world = int(manifest["world"])
    by_rank: Dict[int, List[dict]] = {}
    failures: Dict[int, Exception] = {}
    raw: Dict[int, Tuple[dict, List[dict]]] = {}
    for rec in manifest["shards"]:
        r = int(rec["rank"])
        path = os.path.join(directory, rec["file"])
        try:
            if verify and not (os.path.isfile(path) and
                               os.path.getsize(path) == int(rec["bytes"])):
                raise CheckpointCorruptError(
                    f"shard file {path} missing or wrong size", path=path)
            raw[r] = mf.read_shard(path, verify=verify)
        except (CheckpointCorruptError, OSError) as exc:
            failures[r] = exc
    for r, (_meta, entries) in raw.items():
        by_rank[r] = [e for e in entries
                      if e["role"] in (mf.ROLE_OWN, mf.ROLE_REPLICATED)]
    for r, exc in failures.items():
        left = (r - 1) % world
        rep = [dict(e, role=(mf.ROLE_OWN if "#" in e["key"]
                             else mf.ROLE_REPLICATED))
               for _m, entries in ([raw[left]] if left in raw else [])
               for e in entries
               if e["role"] == mf.ROLE_REPLICA and e.get("replica_of") == r]
        if not rep:
            raise CheckpointCorruptError(
                f"shard file for rank {r} is damaged ({exc}) and its left "
                f"neighbor (rank {left}) holds no usable replica",
                path=getattr(exc, "path", None),
                leaf=getattr(exc, "leaf", None))
        log.warning("checkpoint restore: rank %d's shard file is damaged "
                    "(%s); recovered from rank %d's replica section", r, exc,
                    left)
        stats.REPLICA_RESTORES.inc()
        flight_recorder.emit("ckpt_restore_replica", rank=r, source=left,
                             step=int(manifest["step"]))
        by_rank[r] = rep
    return by_rank


def _group_for(groups, per_rank) -> int:
    n = next(iter(per_rank.values())).numel()
    for gi, (_dt, _gn, shard_elems, _p) in enumerate(groups):
        if int(shard_elems) == n:
            return gi
    raise CheckpointCorruptError(
        f"generic sharded leaf with {n} elements matches no layout group "
        f"{groups!r}")


def _assemble(manifest: dict, by_rank: Dict[int, List[dict]]
              ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
    """(replicated-leaf values by key, per-sharded-key FULL buffers)."""
    world = int(manifest["world"])
    replicated: Dict[str, Any] = {}
    sub: Dict[str, Dict[int, Any]] = {}  # subkey -> {rank: value}
    for r, entries in by_rank.items():
        for e in entries:
            if e["role"] == mf.ROLE_REPLICATED:
                replicated.setdefault(e["key"], e["value"])
            else:
                sub.setdefault(e["key"], {})[r] = e["value"]
    full: Dict[str, Dict[str, Any]] = {}
    for key, layout in manifest.get("sharded", {}).items():
        groups = layout["groups"]

        def _full_buffer(subkey: str, gi: int) -> torch.Tensor:
            shard_elems = int(groups[gi][2])
            per_rank = sub.get(subkey, {})
            if len(per_rank) < world:
                missing = sorted(set(range(world)) - set(per_rank))
                raise CheckpointCorruptError(
                    f"sharded leaf {subkey!r}: missing segments from ranks "
                    f"{missing}", leaf=subkey)
            segs = []
            for r in range(world):
                seg = per_rank[r].reshape(-1)
                if seg.numel() != shard_elems:
                    raise CheckpointCorruptError(
                        f"sharded leaf {subkey!r}: rank {r} segment has "
                        f"{seg.numel()} elements, layout says {shard_elems}",
                        leaf=subkey)
                segs.append(seg)
            return segs[0] if world == 1 else torch.cat(segs)

        if layout["kind"] == "flat_adamw":
            counts = sub.get(f"{key}#count", {})
            if not counts:
                raise CheckpointCorruptError(
                    f"sharded leaf {key!r}: no count entry",
                    leaf=f"{key}#count")
            full[key] = {"kind": "flat_adamw",
                         "count": next(iter(counts.values()))}
            for comp in ("master", "mu", "nu"):
                full[key][comp] = [_full_buffer(f"{key}#{comp}/{gi}", gi)
                                   for gi in range(len(groups))]
        else:
            leaves: List[Any] = []
            li = 0
            while f"{key}#leaf/{li}" in sub:
                per_rank = sub[f"{key}#leaf/{li}"]
                sample = next(iter(per_rank.values()))
                if sample.ndim == 0:
                    leaves.append(sample)
                else:
                    leaves.append(_full_buffer(
                        f"{key}#leaf/{li}", _group_for(groups, per_rank)))
                li += 1
            full[key] = {"kind": layout["kind"], "leaves": leaves,
                         "state_keys": layout.get("state_keys")}
    return replicated, full


def like_target(target, value, key: str):
    """A stored value in the form of its target leaf: a tensor on the
    target's device (its shape must match), a numpy array, a Python
    scalar, or the stored object itself."""
    if isinstance(target, torch.Tensor) and isinstance(value, torch.Tensor):
        if tuple(value.shape) != tuple(target.shape):
            raise CheckpointCorruptError(
                f"checkpoint leaf {key!r} has shape {tuple(value.shape)}, "
                f"the target {tuple(target.shape)} (state structure "
                f"changed?)", leaf=key)
        return value.to(target.device)
    if isinstance(value, torch.Tensor):
        if isinstance(target, (bool, int, float, complex)) \
                and value.numel() == 1:
            return type(target)(value.item())
        if isinstance(target, (np.ndarray, np.generic)) \
                and value.dtype != torch.bfloat16:  # numpy has no bfloat16
            arr = value.numpy()
            return arr if isinstance(target, np.ndarray) else arr[()]
    return value


def restore_step(directory: str, step: int, target_trees: Dict[str, Any],
                 verify: Optional[bool] = None
                 ) -> Tuple[Dict[str, Any], int]:
    """Rebuild ``target_trees``-shaped state from the manifest at ``step``.
    Raises :class:`CheckpointCorruptError` when the cut is
    unrecoverable."""
    if verify is None:
        verify = _get_bool(HOROVOD_CKPT_VERIFY, True)
    manifest = mf.load_manifest(directory, step)
    by_rank = _read_rank_entries(directory, manifest, verify)
    replicated, full = _assemble(manifest, by_rank)
    out: Dict[str, Any] = {}
    index = 0
    for name in sorted(target_trees):
        tree = target_trees[name]
        if tree is None:
            out[name] = None
            continue
        flat, treedef = tree_mod.flatten(tree, is_leaf=zero.is_sharded_state)
        new_flat = []
        for leaf in flat:
            key = f"{name}/{index}"
            index += 1
            if zero.is_sharded_state(leaf):
                if key not in full:
                    raise CheckpointCorruptError(
                        f"checkpoint has no sharded record for {key!r} "
                        f"(state structure changed?)", leaf=key)
                try:
                    new_flat.append(zero.from_full_buffers(
                        leaf, full[key], manifest["sharded"][key]["groups"]))
                except (ValueError, StopIteration) as exc:
                    raise CheckpointCorruptError(
                        f"checkpoint sharded record {key!r} does not fit "
                        f"its target: {exc}", leaf=key) from exc
            else:
                if key not in replicated:
                    raise CheckpointCorruptError(
                        f"checkpoint has no record for leaf {key!r} (state "
                        f"structure changed?)", leaf=key)
                new_flat.append(like_target(leaf, replicated[key], key))
        out[name] = tree_mod.unflatten(treedef, new_flat)
    return out, int(manifest["step"])


def restore_latest(directory: str, target_trees: Dict[str, Any],
                   verify: Optional[bool] = None
                   ) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """Newest consistent cut, or ``(None, None)`` when the directory holds
    no checkpoint at all. Corrupt or torn newer cuts are skipped (with a
    warning); if every published cut is damaged the LAST error propagates:
    silently training from scratch over recoverable data loss is worse
    than failing loudly."""
    steps = mf.all_steps(directory)
    if not steps:
        return None, None
    t0 = time.monotonic()
    last_error: Optional[Exception] = None
    for step in reversed(steps):
        try:
            trees, got = restore_step(directory, step, target_trees,
                                      verify=verify)
        except CheckpointCorruptError as exc:
            last_error = exc
            log.warning("checkpoint at step %d is not restorable (%s); "
                        "falling back to the previous cut", step, exc)
            continue
        stats.RESTORE_SECONDS.observe(time.monotonic() - t0)
        flight_recorder.emit("ckpt_restore", step=got, directory=directory,
                             seconds=round(time.monotonic() - t0, 6))
        return trees, got
    raise last_error  # type: ignore[misc]
