"""Durable-file primitives shared by the sharded checkpoint writer and the
rank-0 :mod:`horovod_tpu_torch.checkpoint` (port of
``horovod_tpu/ckpt/io.py:59-198``; the same names, digests and tmp names).

Three invariants every writer in this package leans on:

* **torn writes are invisible**: payload goes to a ``*.tmp`` sibling, is
  fsync'd, and only then ``os.replace``d over the published name (followed
  by a directory fsync so the rename itself is durable);
* **tmp staleness is keyed on writer liveness, not mtime**: the tmp name
  embeds ``<hostname>.<pid>``, and the cleaner only removes a tmp whose
  writer process is provably gone (``os.kill(pid, 0)``), so two writers
  with skewed clocks never delete each other's fresh tmps;
* **integrity is checksummed**: CRC32C (Castagnoli) when a native module
  is importable, else zlib's CRC-32, chosen as the JAX package chooses, so
  both compute the same digest of the same bytes on one machine; the
  algorithm tag is recorded next to every digest, so a restore verifies
  with the algorithm that wrote it.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
import zlib
from typing import Optional, Tuple

# tmp names look like  <base>.<hostname>.<pid>.<random>.tmp ; the pid is
# only meaningful on the host that wrote it
_TMP_SUFFIX = ".tmp"

# bytes copied at a time where a native crc32c module takes only ``bytes``
_CHUNK = 64 << 20

try:  # pragma: no cover - depends on the environment
    import google_crc32c as _crc32c_mod

    def _extend_crc32c(crc: int, data) -> int:
        # the C module takes ``bytes`` only: feed it bounded copies, never
        # the whole leaf or file at once
        view = memoryview(data).cast("B")
        for off in range(0, view.nbytes, _CHUNK):
            crc = _crc32c_mod.extend(crc, bytes(view[off:off + _CHUNK]))
        return int(crc)

    def _crc32c(data) -> int:
        return _extend_crc32c(0, data)

    CRC_ALGORITHM = "crc32c"
except ImportError:  # pragma: no cover
    _extend_crc32c = None
    try:
        import crc32c as _crc32c_mod  # type: ignore

        def _crc32c(data) -> int:
            return int(_crc32c_mod.crc32c(bytes(data)))

        CRC_ALGORITHM = "crc32c"
    except ImportError:
        _crc32c_mod = None

        def _crc32c(data) -> int:
            return zlib.crc32(data) & 0xFFFFFFFF

        CRC_ALGORITHM = "crc32"


def checksum(data, running: int = 0) -> int:
    """Digest of ``data`` (bytes or a buffer-protocol object), optionally
    chained from a previous call's result. For ``crc32`` the chain is the
    digest of the concatenation; for ``crc32c`` (as in the JAX package) a
    chain mixes the previous digest into the next call's input."""
    if CRC_ALGORITHM == "crc32":
        return zlib.crc32(data, running) & 0xFFFFFFFF
    if running:
        head = running.to_bytes(4, "little")
        if _extend_crc32c is not None:
            return _extend_crc32c(_extend_crc32c(0, head), data)
        return _crc32c(head + bytes(data))
    return _crc32c(data)


def can_extend() -> bool:
    """Whether :func:`extend` runs here: zlib's CRC-32 and
    ``google_crc32c`` carry a running digest; the ``crc32c`` module is
    not relied on for it."""
    return CRC_ALGORITHM == "crc32" or _extend_crc32c is not None


def extend(crc: int, data) -> int:
    """The digest of the bytes that gave ``crc`` followed by ``data``: a
    file's digest computed as it is written (``extend(0, b)`` equals
    ``checksum(b)``). Only where :func:`can_extend`."""
    if CRC_ALGORITHM == "crc32":
        return zlib.crc32(data, crc) & 0xFFFFFFFF
    return _extend_crc32c(crc, data)


def verify_checksum(data, want: int, algorithm: Optional[str]) -> bool:
    """Check ``data`` against a recorded digest, honouring the algorithm
    that wrote it. A digest of an algorithm this host cannot compute is
    unverifiable, not corrupt: the caller decides."""
    if algorithm in (None, "crc32"):
        return (zlib.crc32(data) & 0xFFFFFFFF) == int(want)
    if algorithm == "crc32c" and CRC_ALGORITHM == "crc32c":
        return _crc32c(data) == int(want)
    return True


def hostname() -> str:
    try:
        return socket.gethostname().split(".")[0] or "localhost"
    except OSError:
        return "localhost"


def make_tmp(directory: str, base: str = "ckpt") -> Tuple[int, str]:
    """``mkstemp`` with the writer's identity in the name:
    ``<base>.<hostname>.<pid>.<random>.tmp``."""
    prefix = f"{base}.{hostname()}.{os.getpid()}."
    return tempfile.mkstemp(dir=directory, prefix=prefix, suffix=_TMP_SUFFIX)


def parse_tmp_writer(name: str) -> Tuple[Optional[str], Optional[int]]:
    """(hostname, pid) embedded in a tmp name, or (None, None) for a
    legacy or foreign tmp."""
    if not name.endswith(_TMP_SUFFIX):
        return None, None
    parts = name[:-len(_TMP_SUFFIX)].split(".")
    # <base>.<hostname>.<pid>.<random>: pid is third-from-last
    if len(parts) < 4:
        return None, None
    try:
        return parts[-3], int(parts[-2])
    except ValueError:
        return None, None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # exists but not ours, or indeterminate: keep the file
    return True


# mtime fallback for tmps that carry no writer identity (legacy names, or
# names written by another host, where a local pid probe would alias an
# unrelated process)
STALE_TMP_SECONDS = 600.0


def clean_stale_tmps(directory: str, now: Optional[float] = None) -> int:
    """Remove ``*.tmp`` files whose writer is dead; returns how many.

    A tmp this host wrote is kept while its pid lives, however old, and
    goes at once when the pid is gone. Foreign-host and legacy tmps fall
    back to the mtime window, the only signal there is for them."""
    try:
        names = os.listdir(directory)
    except OSError:
        return 0
    if now is None:
        now = time.time()
    removed = 0
    host = hostname()
    for name in names:
        if not name.endswith(_TMP_SUFFIX):
            continue
        path = os.path.join(directory, name)
        tmp_host, tmp_pid = parse_tmp_writer(name)
        try:
            if tmp_pid is not None and tmp_host == host:
                if _pid_alive(tmp_pid):
                    continue
            elif now - os.path.getmtime(path) <= STALE_TMP_SECONDS:
                continue
            os.unlink(path)
            removed += 1
        except OSError:
            pass  # raced with another cleaner, or already gone
    return removed


def fsync_dir(directory: str) -> None:
    """Durably record a rename in the directory entry: without it a host
    crash after ``os.replace`` can resurface the old (or no) file."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, data, base: str = "ckpt") -> None:
    """Write ``data`` to ``path`` by the fsync'd tmp + rename protocol: a
    crash at any instant leaves either the old ``path`` or the new one,
    never a torn file."""
    directory = os.path.dirname(path) or "."
    fd, tmp = make_tmp(directory, base=base)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
