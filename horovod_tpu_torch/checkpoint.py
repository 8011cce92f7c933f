"""Checkpoint / resume: rank-0 save, broadcast restore (port of
``horovod_tpu/checkpoint.py:41-255``).

The reference fixes the convention (``pytorch_imagenet_resnet50.py``):
only rank 0 writes; on resume rank 0's values are made authoritative by a
broadcast, the resume epoch first. This module packages it for trees of
tensors (``state_dict()``s, dicts, lists)::

    hvd.checkpoint.save(ckpt_dir, {"model": model.state_dict(),
                                   "opt": opt.state_dict()}, step=epoch)
    state, step = hvd.checkpoint.restore_latest(ckpt_dir, target=state)

The file (``ckpt_<step>.hvd``) is one shard container of
:mod:`horovod_tpu_torch.ckpt.manifest`, the format of the sharded
checkpoint, keyed by each leaf's ``/``-joined path in the JAX package's
flatten order (:mod:`horovod_tpu_torch.ckpt.tree`). The JAX package
writes flax msgpack here; neither flax nor msgpack is on the card's
machine, so the port keeps one format, not two. Beside it goes the same
``.crc`` sidecar as the JAX package's: ``algorithm``, ``file_crc``,
``bytes`` and per-leaf digests under ``leaves`` (for the same nested dict
of arrays, the same digests). ``restore`` verifies it and raises
:class:`~horovod_tpu_torch.exceptions.CheckpointCorruptError` naming the
damaged leaf. Publishing is atomic (fsync'd tmp + rename) and orphaned
tmps are cleaned by writer liveness (:mod:`horovod_tpu_torch.ckpt.io`).
Sharded multi-writer checkpoints live in :mod:`horovod_tpu_torch.ckpt`.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.ckpt import io as ckpt_io
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import tree as tree_mod
from horovod_tpu_torch.ckpt.restore import like_target
from horovod_tpu_torch.core import basics
from horovod_tpu_torch.exceptions import CheckpointCorruptError
from horovod_tpu_torch.ops import collectives

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.hvd$")


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.hvd")


def _crc_path(path: str) -> str:
    return path + ".crc"


def _leaf_bytes(leaf):
    """The bytes the sidecar digests for a leaf, as the JAX package takes
    them (``np.asarray(leaf)``'s), or None for a leaf that is no array."""
    if isinstance(leaf, torch.Tensor):
        return mf.tensor_bytes(leaf)
    try:
        return np.ascontiguousarray(np.asarray(leaf)).tobytes()
    except Exception:
        return None


def _leaf_crcs(pairs) -> dict:
    """Per-leaf digests keyed by the leaf's path: a restore failure names
    the damaged leaf instead of just the file."""
    out = {}
    for path, leaf in pairs:
        data = _leaf_bytes(leaf)
        if data is not None:
            out[tree_mod.path_key(path)] = ckpt_io.checksum(data)
    return out


def save(directory: str, state: Any, step: int = 0,
         keep: Optional[int] = None) -> Optional[str]:
    """Write ``state`` (a tree of tensors, arrays and plain values) as step
    ``step``. Only rank 0 writes; other ranks return ``None`` at once.
    ``keep`` retains only the newest N checkpoints. The ``.crc`` sidecar
    (whole-file and per-leaf digests) is published first, so a crash
    between the two leaves a checkpoint that fails verification, never a
    verified wrong one."""
    st = basics._ensure_init()
    if st.rank != 0:
        return None
    os.makedirs(directory, exist_ok=True)
    ckpt_io.clean_stale_tmps(directory)
    pairs, _ = tree_mod.flatten_with_path(state)
    pairs = [(path, leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
              else leaf) for path, leaf in pairs]
    entries = [(mf.array_entry if mf.is_array(leaf) else mf.object_entry)(
        tree_mod.path_key(path), leaf) for path, leaf in pairs]
    data = mf.pack_shard(entries, meta={"step": int(step)})
    path = _ckpt_path(directory, step)
    sidecar = json.dumps({
        "algorithm": ckpt_io.CRC_ALGORITHM,
        "file_crc": ckpt_io.checksum(data),
        "bytes": len(data),
        "leaves": _leaf_crcs(pairs),
    }).encode()
    ckpt_io.atomic_write(_crc_path(path), sidecar, base="ckpt")
    ckpt_io.atomic_write(path, data, base="ckpt")
    if keep is not None:
        for old_step in all_steps(directory)[:-keep]:
            old = _ckpt_path(directory, old_step)
            os.unlink(old)
            try:
                os.unlink(_crc_path(old))
            except OSError:
                pass
    return path


def all_steps(directory: str) -> list:
    """Sorted step numbers present in ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT_RE.match,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _verify_sidecar(path: str, data: bytes) -> None:
    """Check ``data`` (and, where it does not match, each leaf) against the
    ``.crc`` sidecar. No sidecar verifies trivially; a mismatch raises
    :class:`CheckpointCorruptError`."""
    try:
        with open(_crc_path(path), "rb") as f:
            sidecar = json.loads(f.read())
    except OSError:
        return
    except ValueError as exc:
        raise CheckpointCorruptError(
            f"checkpoint sidecar {_crc_path(path)} is unreadable: {exc}",
            path=path) from exc
    algorithm = sidecar.get("algorithm")
    if "bytes" in sidecar and len(data) != int(sidecar["bytes"]):
        raise CheckpointCorruptError(
            f"checkpoint {path} has {len(data)} bytes; its sidecar recorded "
            f"{sidecar['bytes']} (truncated or torn write)", path=path)
    if not ckpt_io.verify_checksum(data, sidecar.get("file_crc", 0),
                                   algorithm):
        leaf = _find_bad_leaf(data, sidecar, algorithm)
        raise CheckpointCorruptError(
            f"checkpoint {path} fails its whole-file CRC"
            + (f" (first damaged leaf: {leaf!r})" if leaf else ""),
            path=path, leaf=leaf)


def _find_bad_leaf(data: bytes, sidecar: dict,
                   algorithm: Optional[str]) -> Optional[str]:
    """The first leaf whose bytes miss their digest: the sidecar's for an
    array (its bytes are what the sidecar digested), the container's own
    record for an object; None when the header itself is damaged."""
    try:
        _meta, records, off = mf.parse_header(data)
    except CheckpointCorruptError:
        return None
    want = sidecar.get("leaves", {})
    view = memoryview(data)
    for rec in records:
        start = off + int(rec["offset"])
        digest = want.get(rec["key"]) if rec["kind"] == "array" else None
        if not ckpt_io.verify_checksum(
                view[start:start + int(rec["nbytes"])],
                rec["crc"] if digest is None else digest, algorithm):
            return rec["key"]
    return None


def _broadcast(state: Any) -> Any:
    """Rank 0's values on every rank: tensors on this rank's device tensor
    by tensor, everything else in one pickled object."""
    pairs, treedef = tree_mod.flatten_with_path(state)
    dev = basics.device()
    leaves = [leaf for _, leaf in pairs]
    handles, rest = [], {}
    for i, (path, leaf) in enumerate(pairs):
        if isinstance(leaf, torch.Tensor) and leaf.device == dev:
            handles.append(collectives.broadcast_async_(
                leaf, 0, name=f"checkpoint.restore.{tree_mod.path_key(path)}"))
        else:
            rest[i] = leaf
    rest = collectives.broadcast_object(rest, root_rank=0,
                                        name="checkpoint.restore")
    for h in handles:
        collectives.synchronize(h)
    for i, leaf in rest.items():
        leaves[i] = leaf
    return tree_mod.unflatten(treedef, leaves)


def restore(path: str, target: Any, broadcast: bool = True,
            verify: bool = True) -> Any:
    """Load a checkpoint file into the structure of ``target``; each leaf
    comes back in its target's form (a tensor on the target's device).

    With ``broadcast`` (default), rank 0's values are broadcast, so every
    worker resumes the same state even if their filesystems disagree; a
    rank whose filesystem lacks the file feeds a copy of ``target`` into
    the broadcast. With ``verify`` (default), the bytes are checked against
    the ``.crc`` sidecar first; damage raises
    :class:`CheckpointCorruptError` naming the leaf where it can be
    narrowed down, as does a file that fails to decode."""
    st = basics._ensure_init()
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = f.read()
        if verify:
            _verify_sidecar(path, data)
        try:
            _meta, entries = mf.parse_shard(data, path, verify=verify)
        except CheckpointCorruptError:
            raise
        except Exception as exc:
            raise CheckpointCorruptError(
                f"checkpoint {path} failed to deserialize: {exc}",
                path=path) from exc
        values = {e["key"]: e["value"] for e in entries}
        pairs, treedef = tree_mod.flatten_with_path(target)
        leaves = []
        for p, leaf in pairs:
            key = tree_mod.path_key(p)
            if key not in values:
                raise CheckpointCorruptError(
                    f"checkpoint {path} has no leaf {key!r} (state structure "
                    f"changed?)", path=path, leaf=key)
            leaves.append(like_target(leaf, values[key], key))
        state = tree_mod.unflatten(treedef, leaves)
    elif broadcast and st.rank != 0:
        # overwritten by rank 0's values below
        leaves, treedef = tree_mod.flatten(target)
        state = tree_mod.unflatten(treedef, [
            leaf.detach().clone() if isinstance(leaf, torch.Tensor) else leaf
            for leaf in leaves])
    else:
        raise FileNotFoundError(path)
    if broadcast:
        state = _broadcast(state)
    return state


def restore_latest(directory: str, target: Any,
                   broadcast: bool = True) -> Tuple[Any, Optional[int]]:
    """Restore the newest checkpoint: ``(state, step)``, or ``(target,
    None)`` when there is none (a fresh start). The decision is rank 0's
    (only rank 0 writes, so only it may see the files): its latest step is
    broadcast first, and every rank takes the same branch, so the
    broadcasts inside :func:`restore` line up across the job."""
    local_step = latest_step(directory)
    step = collectives.broadcast_object(local_step, root_rank=0,
                                        name="ckpt_resume_step")
    if step is None:
        return target, None
    return restore(_ckpt_path(directory, step), target,
                   broadcast=broadcast), step
