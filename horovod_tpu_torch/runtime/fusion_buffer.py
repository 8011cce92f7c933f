"""The size-bucket policy of flat fused payloads (port of
``bucket_elems`` in ``horovod_tpu/runtime/fusion_buffer.py:91-105``).

ZeRO's flat layout pads each per-rank shard to a bucket, so every rank's
shard has the same length and the pad holds the reduction identity. The
persistent fusion-buffer pool of the reference waits for the enqueue
runtime.
"""

from __future__ import annotations


def bucket_elems(nelems: int, itemsize: int, quantum_bytes: int) -> int:
    """Element count of the size bucket holding ``nelems`` items.

    Payloads at or under the quantum keep their exact size; larger ones
    round up to the next power-of-two multiple of the quantum."""
    nbytes = nelems * itemsize
    if quantum_bytes <= 0 or nbytes <= quantum_bytes:
        return nelems
    bucket = quantum_bytes
    while bucket < nbytes:
        bucket <<= 1
    return -(-bucket // itemsize)  # ceil: quantum need not divide itemsize
