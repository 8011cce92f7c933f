"""Shard container format and the step manifest (port of
``horovod_tpu/ckpt/manifest.py:51-269``: the same container, byte for
byte, so each package reads what the other wrote).

One checkpoint is ``N`` shard files plus one ``MANIFEST-<step>.json``, all
in one directory:

* **shard file** (``shard-<step>-r<rank>-of-<world>.hvd``): magic, a
  little-endian uint64 header length, a JSON header, then the concatenated
  raw leaf bytes. The header records, per entry, the leaf key, dtype
  (numpy's name: ``float32``, ``bfloat16``, ...), shape, byte extent and
  CRC, plus a *role*: ``own`` (this rank's ZeRO shard), ``replica`` (the
  right neighbour's bytes) or ``replicated`` (this rank's round-robin slice
  of the replicated state). Object entries are pickles of plain Python or
  numpy values, never of torch types, so the JAX package reads them.
* **manifest**: the commit point. It names every shard file with its
  whole-file CRC and records the sharded-state layout (world size and
  flat-group geometry), which lets a restore re-slice into another world
  size. A restore reads only files a manifest names.

Array values go in as CPU tensors or numpy arrays and come out as CPU
tensors (numpy has no bfloat16). :func:`read_shard` reads each leaf
straight into a tensor of its own; :func:`write_shard` streams the
container out of the leaves' own memory, the same bytes as
:func:`pack_shard`. Every parse error, short read or digest mismatch is a
:class:`~horovod_tpu_torch.exceptions.CheckpointCorruptError` carrying the
file path and (for a leaf's damage) the leaf key.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import struct
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.ckpt import io as ckpt_io
from horovod_tpu_torch.ckpt import stats
from horovod_tpu_torch.exceptions import CheckpointCorruptError
from horovod_tpu_torch.parallel.zero import dtype_name

MAGIC = b"HVDSHRD1"
FORMAT = "hvdckpt-1"

MANIFEST_RE = re.compile(r"^MANIFEST-(\d+)\.json$")

ROLE_OWN = "own"
ROLE_REPLICA = "replica"
ROLE_REPLICATED = "replicated"

_HEADER_FIELDS = ("key", "kind", "role", "dtype", "shape", "replica_of",
                  "crc")


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"MANIFEST-{step}.json")


def shard_name(step: int, rank: int, world: int) -> str:
    return f"shard-{step}-r{rank}-of-{world}.hvd"


# ---------------------------------------------------------------------------
# Leaf bytes
# ---------------------------------------------------------------------------

def tensor_bytes(t: torch.Tensor) -> memoryview:
    """The raw bytes of a CPU tensor in row-major order, without a copy
    when it is contiguous."""
    if t.device.type != "cpu":
        raise ValueError(f"shard container: a {t.device} tensor must be "
                         "copied to the host first")
    t = t.detach().resolve_conj().resolve_neg().contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def is_array(x) -> bool:
    """Whether a leaf is stored as an array entry (a tensor, a numpy array
    or scalar) rather than as a pickled object."""
    return hasattr(x, "shape") and hasattr(x, "dtype")


def raw_array(value) -> Tuple[str, list, memoryview]:
    """``(dtype name, shape, bytes)`` of a CPU tensor or a numpy array."""
    if isinstance(value, torch.Tensor):
        return dtype_name(value.dtype), list(value.shape), tensor_bytes(value)
    arr = np.asarray(value)  # (ascontiguousarray makes a 0-d array 1-d)
    return (np.dtype(arr.dtype).name, list(arr.shape),
            memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8)))


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"no torch dtype for {name!r}")
    return dt


# ---------------------------------------------------------------------------
# Shard container
# ---------------------------------------------------------------------------

def array_entry(key: str, value, role: str = ROLE_OWN,
                replica_of: Optional[int] = None) -> dict:
    """Container entry for one array leaf (a CPU tensor or a numpy array,
    0-d included). Its ``data`` views the value's memory."""
    dt, shape, data = raw_array(value)
    return {"key": key, "kind": "array", "role": role, "dtype": dt,
            "shape": shape, "replica_of": replica_of, "data": data,
            "crc": ckpt_io.checksum(data)}


def object_entry(key: str, value: Any, role: str = ROLE_OWN,
                 replica_of: Optional[int] = None) -> dict:
    """Container entry for a plain Python or numpy value (pickled). A
    torch object is refused: the JAX package could not unpickle it."""
    if type(value).__module__.split(".")[0] == "torch":
        raise TypeError(f"shard container: leaf {key!r} is a "
                        f"{type(value).__name__}; object leaves hold plain "
                        "Python or numpy values")
    data = pickle.dumps(value)
    return {"key": key, "kind": "object", "role": role, "dtype": None,
            "shape": None, "replica_of": replica_of, "data": data,
            "crc": ckpt_io.checksum(data)}


def _prefix(entries: List[dict], meta: dict) -> bytes:
    """Magic, header length and header of a container of ``entries``."""
    records = []
    offset = 0
    for e in entries:
        n = memoryview(e["data"]).nbytes
        records.append({k: e[k] for k in _HEADER_FIELDS}
                       | {"offset": offset, "nbytes": n})
        offset += n
    header = json.dumps({
        "meta": dict(meta, crc_algorithm=ckpt_io.CRC_ALGORITHM),
        "entries": records,
    }).encode()
    return MAGIC + struct.pack("<Q", len(header)) + header


def pack_shard(entries: List[dict], meta: dict) -> bytes:
    """Serialize entries into one container blob (header + payload)."""
    return b"".join([_prefix(entries, meta)] + [e["data"] for e in entries])


def write_shard(f, entries: List[dict], meta: dict) -> Tuple[int, int]:
    """Write the container :func:`pack_shard` would make to the open file
    ``f`` straight from the entries' memory; returns ``(bytes, whole-file
    digest)``. The digest runs as the bytes go out
    (:func:`~horovod_tpu_torch.ckpt.io.extend`), so the file is never held
    whole in memory; only where no running digest can be had (the
    ``crc32c`` module) is the blob built first."""
    if not ckpt_io.can_extend():
        blob = pack_shard(entries, meta)
        f.write(blob)
        return len(blob), ckpt_io.checksum(blob)
    prefix = _prefix(entries, meta)
    f.write(prefix)
    crc, n = ckpt_io.extend(0, prefix), len(prefix)
    for e in entries:
        f.write(e["data"])
        crc = ckpt_io.extend(crc, e["data"])
        n += memoryview(e["data"]).nbytes
    return n, crc


def _corrupt(message: str, path, leaf=None) -> CheckpointCorruptError:
    stats.INTEGRITY_FAILURES.inc()
    return CheckpointCorruptError(message, path=path, leaf=leaf)


def _parse_header(head: bytes, path) -> Tuple[dict, List[dict], int]:
    """``(meta, records, payload offset)`` from a container's first bytes
    (at least its magic, length and header)."""
    if len(head) < len(MAGIC) + 8 or not head.startswith(MAGIC):
        raise _corrupt(f"checkpoint shard {path} is truncated or not a "
                       f"shard container (bad magic)", path)
    (header_len,) = struct.unpack_from("<Q", head, len(MAGIC))
    body_off = len(MAGIC) + 8
    try:
        header = json.loads(head[body_off:body_off + header_len])
        meta, records = header["meta"], header["entries"]
    except (ValueError, KeyError, TypeError) as exc:
        raise _corrupt(f"checkpoint shard {path} has an unparseable "
                       f"header: {exc}", path) from exc
    return meta, records, body_off + header_len


def _entry(rec: dict, data, path, algorithm, verify: bool, value=None):
    """One decoded entry: the header fields and its ``value`` (``value``
    given: the tensor ``data`` views)."""
    key = rec.get("key")
    if memoryview(data).nbytes != int(rec["nbytes"]):
        raise _corrupt(
            f"checkpoint shard {path} is truncated at leaf {key!r} (wanted "
            f"{rec['nbytes']} bytes, file holds {memoryview(data).nbytes})",
            path, key)
    if verify and not ckpt_io.verify_checksum(data, rec["crc"], algorithm):
        raise _corrupt(
            f"checkpoint shard {path}: CRC mismatch on leaf {key!r} — bytes "
            f"on disk do not match what was written", path, key)
    entry = dict(rec)
    if rec["kind"] == "array":
        if value is None:
            value = _empty(rec)
            tensor_bytes_into(value)[:] = data
        entry["value"] = value
    else:
        try:
            entry["value"] = pickle.loads(data)
        except Exception as exc:
            raise _corrupt(f"checkpoint shard {path}: object leaf {key!r} "
                           f"failed to decode: {exc}", path, key) from exc
    return entry


def _empty(rec: dict) -> torch.Tensor:
    return torch.empty(rec["shape"], dtype=torch_dtype(rec["dtype"]))


def tensor_bytes_into(t: torch.Tensor) -> memoryview:
    """A writable byte view of a contiguous CPU tensor's memory."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


def parse_header(blob, path=None) -> Tuple[dict, List[dict], int]:
    """``(meta, records, payload offset)`` of a container held in memory;
    each record holds an entry's header fields, ``offset`` and
    ``nbytes``."""
    return _parse_header(bytes(blob[:_head_bound(blob)]), path)


def parse_shard(blob, path=None, verify: bool = True
                ) -> Tuple[dict, List[dict]]:
    """Parse a container held in memory: ``(meta, entries)``, each entry
    its header fields plus a decoded ``value`` (a tensor of its own)."""
    meta, records, off = parse_header(blob, path)
    view = memoryview(blob)
    algorithm = meta.get("crc_algorithm")
    entries = []
    for rec in records:
        start = off + int(rec["offset"])
        entries.append(_entry(rec, view[start:start + int(rec["nbytes"])],
                              path, algorithm, verify))
    return meta, entries


def _head_bound(blob) -> int:
    """Bytes of ``blob`` up to the end of its header (or all of it)."""
    if len(blob) < len(MAGIC) + 8:
        return len(blob)
    (header_len,) = struct.unpack_from("<Q", blob, len(MAGIC))
    return min(len(blob), len(MAGIC) + 8 + header_len)


def read_shard(path: str, verify: bool = True) -> Tuple[dict, List[dict]]:
    """Read a shard container from disk: ``(meta, entries)``, each array
    leaf read straight into a tensor of its own.

    With ``verify`` every leaf's bytes are checked against the recorded
    digest; a mismatch raises :class:`CheckpointCorruptError` naming the
    leaf. Structural damage (bad magic, short file, unparseable header)
    raises with ``leaf=None``."""
    try:
        f = open(path, "rb")
    except OSError as exc:
        raise CheckpointCorruptError(
            f"checkpoint shard unreadable: {path}: {exc}", path=path) from exc
    with f:
        head = f.read(len(MAGIC) + 8)
        if len(head) == len(MAGIC) + 8 and head.startswith(MAGIC):
            (header_len,) = struct.unpack_from("<Q", head, len(MAGIC))
            head += f.read(header_len)
        meta, records, off = _parse_header(head, path)
        algorithm = meta.get("crc_algorithm")
        entries = []
        for rec in records:
            f.seek(off + int(rec["offset"]))
            n = int(rec["nbytes"])
            if rec["kind"] == "array":
                try:
                    value = _empty(rec)
                except (ValueError, RuntimeError) as exc:
                    raise _corrupt(f"checkpoint shard {path}: leaf "
                                   f"{rec.get('key')!r} has an unknown "
                                   f"layout: {exc}", path,
                                   rec.get("key")) from exc
                buf = tensor_bytes_into(value)
                if buf.nbytes != n:
                    raise _corrupt(
                        f"checkpoint shard {path}: leaf {rec.get('key')!r} "
                        f"holds {n} bytes, its dtype and shape {buf.nbytes}",
                        path, rec.get("key"))
                got = f.readinto(buf) if n else 0
                entries.append(_entry(rec, buf[:got], path, algorithm,
                                      verify, value))
            else:
                entries.append(_entry(rec, f.read(n), path, algorithm,
                                      verify))
    return meta, entries


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

def build_manifest(step: int, generation: int, world: int,
                   shards: List[dict], sharded_layout: Dict[str, dict],
                   extra: Optional[dict] = None) -> dict:
    """``shards``: per-rank ``{"rank", "file", "bytes", "crc"}`` records
    (whole-file digest of the published shard). ``sharded_layout``: per
    sharded-state key, ``{"kind", "world", "groups": [[dtype, n,
    shard_elems, padded], ...]}``, enough to re-slice under a new world
    size."""
    manifest = {
        "format": FORMAT,
        "step": int(step),
        "generation": int(generation),
        "world": int(world),
        "time": time.time(),
        "crc_algorithm": ckpt_io.CRC_ALGORITHM,
        "shards": sorted(shards, key=lambda s: int(s["rank"])),
        "sharded": sharded_layout,
    }
    if extra:
        manifest.update(extra)
    return manifest


def write_manifest(directory: str, manifest: dict) -> str:
    path = manifest_path(directory, manifest["step"])
    ckpt_io.atomic_write(path, json.dumps(manifest, indent=1).encode(),
                         base="manifest")
    return path


def load_manifest(directory: str, step: int) -> dict:
    path = manifest_path(directory, step)
    try:
        with open(path, "rb") as f:
            manifest = json.loads(f.read())
    except OSError as exc:
        raise CheckpointCorruptError(
            f"manifest unreadable: {path}: {exc}", path=path) from exc
    except ValueError as exc:
        raise _corrupt(f"manifest {path} is not valid JSON: {exc}",
                       path) from exc
    if manifest.get("format") != FORMAT:
        raise _corrupt(f"manifest {path}: unknown format "
                       f"{manifest.get('format')!r}", path)
    return manifest


def all_steps(directory: str) -> List[int]:
    """Steps with a published manifest, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = MANIFEST_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def verify_manifest_files(directory: str, manifest: dict) -> None:
    """Cheap consistency probe: every shard file the manifest names must
    exist with the recorded size and whole-file digest. Raises
    :class:`CheckpointCorruptError` naming the first damaged file."""
    algorithm = manifest.get("crc_algorithm")
    for rec in manifest["shards"]:
        path = os.path.join(directory, rec["file"])
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError as exc:
            raise CheckpointCorruptError(
                f"manifest names a missing shard file: {path}: {exc}",
                path=path) from exc
        if len(blob) != int(rec["bytes"]):
            raise _corrupt(f"shard file {path} has {len(blob)} bytes; "
                           f"manifest recorded {rec['bytes']} (torn or "
                           f"rewritten)", path)
        if not ckpt_io.verify_checksum(blob, rec["crc"], algorithm):
            raise _corrupt(f"shard file {path} fails its whole-file CRC",
                           path)
