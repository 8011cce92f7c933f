"""Collective payload digests and the cross-rank agreement vote (port of
``horovod_tpu/integrity/digest.py``).

Two digests ride a checked dispatch of the runtime's executor:

* **the input's non-finite count**, on this rank's own payload before the
  reduction (counted on the device, read at the drain). A NaN that enters
  a sum reaches every rank's result alike, so only the count names the
  rank it came from: :class:`~horovod_tpu_torch.exceptions.NumericalError`
  with ``suspect_rank``.
* **CRC-32 of the reduced bytes** this rank holds (allreduce only: a
  reduce-scatter leaves each rank a different shard, and sends 0). The
  result is replicated by construction, so a disagreement is silent data
  corruption on the minority rank: the majority vote names it in
  :class:`~horovod_tpu_torch.exceptions.CollectiveIntegrityError`.

The exchange is one 12-byte record a rank (int64 count, uint32 CRC),
gathered on the gloo control group by the runtime's cycle thread, in the
negotiated order of the payload traffic, only on every
``HOROVOD_INTEGRITY_INTERVAL``-th eligible dispatch. Every rank computes
the same verdict from the same records and raises in the same dispatch, so
the rollback stays in lockstep. A digest that cannot be computed raises.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from horovod_tpu_torch import flight_recorder
from horovod_tpu_torch import exceptions
from horovod_tpu_torch.metrics import registry as _metrics

_CHECKS = _metrics().counter(
    "horovod_integrity_checks_total",
    "Digest checks performed on fused collective payloads.")
_VIOLATIONS = _metrics().counter(
    "horovod_integrity_violations_total",
    "Integrity violations detected (non-finite payloads, cross-rank "
    "digest divergence, guard-budget exhaustion).",
    labelnames=("kind",))

# one record a rank on the wire: int64 non-finite count + uint32 CRC
_RECORD = struct.Struct("<qI")

# per-lane dispatch counters of the call sites outside the executor
_cadence: Dict[str, int] = {}  # guarded-by: <owner-thread>


def _as_tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.detach()
    a = np.asarray(arr)
    if a.dtype.kind == "V":  # a bfloat16 numpy array (ml_dtypes)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def nonfinite_count_tensor(t: torch.Tensor) -> torch.Tensor:
    """The count of NaN and Inf elements as a 0-d int64 tensor on ``t``'s
    device (no wait for the device); 0 for integer and boolean tensors."""
    if not (t.is_floating_point() or t.is_complex()):
        return torch.zeros((), dtype=torch.int64, device=t.device)
    return t.numel() - torch.isfinite(t).sum()


def nonfinite_count(arr) -> int:
    """Count of NaN and Inf elements of a tensor or array; 0 for integer
    payloads."""
    return int(nonfinite_count_tensor(_as_tensor(arr)))


def checksum(arr) -> int:
    """CRC-32 of the bytes (bitwise, not numeric: -0.0 and 0.0 differ, as
    do two NaN payloads), on the host."""
    t = _as_tensor(arr).contiguous().reshape(-1)
    raw = t.view(torch.uint8) if t.numel() else t.new_empty(0, dtype=torch.uint8)
    return zlib.crc32(raw.cpu().numpy()) & 0xFFFFFFFF


def cadence_due(key: str, interval: Optional[int] = None) -> bool:
    """A lane's dispatch cadence for call sites outside the executor: True
    on the first and every ``interval``-th call for ``key``."""
    from horovod_tpu_torch import integrity

    if not integrity.enabled():
        return False
    if interval is None:
        interval = integrity.interval()
    if interval <= 0:
        return False
    n = _cadence.get(key, 0)
    _cadence[key] = n + 1
    return n % interval == 0


def reset() -> None:
    """Forget the cadence state (tests; an elastic re-form)."""
    _cadence.clear()


def pack_record(nf_count: int, crc: int) -> bytes:
    return _RECORD.pack(int(nf_count), int(crc) & 0xFFFFFFFF)


def exchange(controller, nf_count: int, crc: int) -> List[Tuple[int, int]]:
    """Every rank's (non-finite count, result CRC) record, gathered by the
    controller's ``allgather_blob`` on the gloo control group. Runs on the
    cycle thread, in the same negotiated order on every rank."""
    blobs = controller.allgather_blob(pack_record(nf_count, crc))
    return [_RECORD.unpack(bytes(blob)) for blob in blobs]


def vote(crcs: Sequence[int]) -> Tuple[bool, Optional[int]]:
    """Majority vote over result checksums: ``(diverged, suspect_rank)``,
    the suspect only when exactly one rank holds a minority checksum."""
    tally: Dict[int, List[int]] = {}
    for rank, crc in enumerate(crcs):
        tally.setdefault(crc, []).append(rank)
    if len(tally) <= 1:
        return False, None
    sizes = sorted(len(ranks) for ranks in tally.values())
    # attributable only to a unique single-rank minority: a 1-vs-1 split or
    # a multi-rank minority cannot say who corrupted
    if sizes[0] != 1 or (len(sizes) > 1 and sizes[1] == 1):
        return True, None
    minority = min(tally.values(), key=len)
    return True, minority[0]


def _emit_violation(kind: str, bucket: str, tensor: Optional[str],
                    suspect: Optional[int], detail: str) -> None:
    flight_recorder.emit("integrity_violation", violation=kind,
                         bucket=bucket, tensor=tensor, suspect=suspect,
                         detail=detail)


def verify(records: Sequence[Tuple[int, int]], bucket: str,
           tensor: Optional[str] = None) -> None:
    """The gathered records' verdict. Non-finite inputs outrank checksum
    divergence: a NaN reaches every rank's result and so makes the CRCs
    agree, and the input count is the only signal that names its rank."""
    _CHECKS.inc()
    bad = [(rank, nf) for rank, (nf, _) in enumerate(records) if nf > 0]
    if bad:
        _VIOLATIONS.labels(kind="nonfinite").inc()
        suspect, count = bad[0]
        _emit_violation("nonfinite", bucket, tensor, suspect,
                        f"rank {suspect}: {count} NaN/Inf")
        raise exceptions.NumericalError(
            f"non-finite payload entered collective bucket {bucket!r}: "
            f"rank {suspect} contributed {count} NaN/Inf element(s)",
            bucket=bucket, tensor=tensor, suspect_rank=suspect)
    diverged, suspect = vote([crc for _, crc in records])
    if diverged:
        _VIOLATIONS.labels(kind="divergence").inc()
        _emit_violation("divergence", bucket, tensor, suspect,
                        "checksums " + ",".join(hex(c) for _, c in records))
        raise exceptions.CollectiveIntegrityError(
            f"collective result diverged across ranks in bucket "
            f"{bucket!r} (checksums {[hex(c) for _, c in records]}); "
            f"suspect rank {suspect}",
            bucket=bucket, tensor=tensor, suspect_rank=suspect)


def verify_local(nf_count: int, bucket: str, tensor: Optional[str] = None,
                 suspect_rank: Optional[int] = None) -> None:
    """The verdict of a path with no cross-rank exchange: a non-finite
    count alone convicts."""
    _CHECKS.inc()
    if nf_count <= 0:
        return
    _VIOLATIONS.labels(kind="nonfinite").inc()
    _emit_violation("nonfinite", bucket, tensor, suspect_rank,
                    f"{nf_count} NaN/Inf")
    raise exceptions.NumericalError(
        f"non-finite payload in collective bucket {bucket!r}"
        + (f" from rank {suspect_rank}" if suspect_rank is not None else "")
        + f": {nf_count} NaN/Inf element(s)",
        bucket=bucket, tensor=tensor, suspect_rank=suspect_rank)
