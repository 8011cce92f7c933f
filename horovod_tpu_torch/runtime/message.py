"""Wire messages for controller negotiation.

Port of ``horovod_tpu/runtime/message.py``, byte for byte on the wire;
analogue of the reference's flatbuffers-defined coordination
messages (reference: horovod/common/message.h:45-210,
horovod/common/wire/message.fbs:41-100): a ``Request`` announces one named
tensor ready on one worker; a ``Response`` carries the coordinator's verdict
for one (possibly fused) set of tensors.

Serialization is a compact length-prefixed binary format (struct-packed,
no schema compiler; versioned with a magic byte), the same bytes the JAX
package's runtime writes.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Tuple

from horovod_tpu_torch.runtime import types

_MAGIC = 0x48  # 'H'
# v2: the request op byte carries a reduce-op code (0=sum, 1=average,
# 2=min, 3=max, 4=product) where v1 carried a boolean average byte — a
# version-skewed peer must reject the frame, not misread min as average.
_VERSION = 2

_REQUEST_TYPES = {types.ALLREDUCE: 0, types.ALLGATHER: 1, types.BROADCAST: 2,
                  types.INVALIDATE: 4, types.REDUCESCATTER: 5,
                  types.ALLTOALL: 6}
_REQUEST_TYPES_INV = {v: k for k, v in _REQUEST_TYPES.items()}
_RESPONSE_TYPES = {types.ALLREDUCE: 0, types.ALLGATHER: 1,
                   types.BROADCAST: 2, types.ERROR: 3, types.INVALIDATE: 4,
                   types.REDUCESCATTER: 5, types.ALLTOALL: 6}
_RESPONSE_TYPES_INV = {v: k for k, v in _RESPONSE_TYPES.items()}

# Reduce-op wire codes. Codes 0/1 preserve the *meaning* of the old v1
# boolean ``average`` byte (0=sum, 1=average) so the assignment stays
# self-documenting; version-skewed frames are still rejected outright by
# the _VERSION check above, never interpreted.
_REDUCE_OPS = {types.REDUCE_SUM: 0, types.REDUCE_AVERAGE: 1,
               types.REDUCE_MIN: 2, types.REDUCE_MAX: 3,
               types.REDUCE_PRODUCT: 4}
_REDUCE_OPS_INV = {v: k for k, v in _REDUCE_OPS.items()}


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<I", len(b)) + b


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode("utf-8"), off + n


@dataclasses.dataclass(frozen=True)
class Request:
    """reference: message.h Request (rank, type, dtype, name, root_rank,
    device, shape)."""

    rank: int
    request_type: str
    tensor_name: str
    dtype: str
    shape: Tuple[int, ...]
    root_rank: int = 0
    reduce_op: str = types.REDUCE_AVERAGE

    def pack(self) -> bytes:
        head = struct.pack(
            "<BBiBiB", _MAGIC, _VERSION, self.rank,
            _REQUEST_TYPES[self.request_type], self.root_rank,
            _REDUCE_OPS[self.reduce_op])
        body = _pack_str(self.tensor_name) + _pack_str(self.dtype)
        body += struct.pack("<I", len(self.shape))
        body += struct.pack(f"<{len(self.shape)}q", *self.shape)
        return head + body

    @staticmethod
    def unpack(buf: bytes, off: int = 0) -> Tuple["Request", int]:
        magic, ver, rank, rtype, root, rop = struct.unpack_from("<BBiBiB",
                                                                buf, off)
        if magic != _MAGIC or ver != _VERSION:
            raise ValueError("bad request header")
        off += struct.calcsize("<BBiBiB")
        name, off = _unpack_str(buf, off)
        dtype, off = _unpack_str(buf, off)
        (ndim,) = struct.unpack_from("<I", buf, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}q", buf, off)
        off += 8 * ndim
        return Request(rank, _REQUEST_TYPES_INV[rtype], name, dtype,
                       tuple(shape), root, _REDUCE_OPS_INV[rop]), off


@dataclasses.dataclass
class Response:
    """reference: message.h Response (type, names, error message, devices,
    sizes). A fused response lists several tensor names executed as one
    collective."""

    response_type: str
    tensor_names: List[str] = dataclasses.field(default_factory=list)
    error_message: str = ""
    # per-rank first-dim sizes for allgather (reference: fused allgather
    # add_allgather_response)
    tensor_sizes: List[int] = dataclasses.field(default_factory=list)

    def pack(self) -> bytes:
        out = struct.pack("<BBB", _MAGIC, _VERSION,
                          _RESPONSE_TYPES[self.response_type])
        out += struct.pack("<I", len(self.tensor_names))
        for n in self.tensor_names:
            out += _pack_str(n)
        out += _pack_str(self.error_message)
        out += struct.pack("<I", len(self.tensor_sizes))
        if self.tensor_sizes:
            out += struct.pack(f"<{len(self.tensor_sizes)}q",
                               *self.tensor_sizes)
        return out

    @staticmethod
    def unpack(buf: bytes, off: int = 0) -> Tuple["Response", int]:
        magic, ver, rtype = struct.unpack_from("<BBB", buf, off)
        if magic != _MAGIC or ver != _VERSION:
            raise ValueError("bad response header")
        off += 3
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        names = []
        for _ in range(n):
            s, off = _unpack_str(buf, off)
            names.append(s)
        err, off = _unpack_str(buf, off)
        (ns,) = struct.unpack_from("<I", buf, off)
        off += 4
        sizes = list(struct.unpack_from(f"<{ns}q", buf, off))
        off += 8 * ns
        return Response(_RESPONSE_TYPES_INV[rtype], names, err, sizes), off


def pack_request_list(requests: List[Request]) -> bytes:
    out = struct.pack("<I", len(requests))
    for r in requests:
        out += r.pack()
    return out


def unpack_request_list(buf: bytes) -> List[Request]:
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = []
    for _ in range(n):
        r, off = Request.unpack(buf, off)
        out.append(r)
    return out


def pack_response_list(responses: List[Response]) -> bytes:
    out = struct.pack("<I", len(responses))
    for r in responses:
        out += r.pack()
    return out


def unpack_response_list(buf: bytes) -> List[Response]:
    (n,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out = []
    for _ in range(n):
        r, off = Response.unpack(buf, off)
        out.append(r)
    return out
