"""The port's durable-file primitives and shard container against the JAX
package's (``horovod_tpu/ckpt/io.py``, ``manifest.py``): the same digests
of the same bytes, shard files that each package reads from the other,
byte for byte, tmp hygiene keyed on writer liveness, and the atomic
publish."""

import os
import subprocess

import ml_dtypes
import numpy as np
import pytest
import torch

from horovod_tpu.ckpt import io as jio
from horovod_tpu.ckpt import manifest as jmf
from horovod_tpu_torch.ckpt import io as tio
from horovod_tpu_torch.ckpt import manifest as tmf
from horovod_tpu_torch.exceptions import CheckpointCorruptError

RNG = np.random.default_rng(0)


def _write(path, blob):
    with open(path, "wb") as f:
        f.write(blob)


@pytest.mark.parametrize("n", [0, 1, 7, 4096, 1 << 20])
def test_checksum_equals_the_jax_packages(n):
    data = RNG.integers(0, 256, n, dtype=np.uint8).tobytes()
    assert tio.CRC_ALGORITHM == jio.CRC_ALGORITHM
    assert tio.checksum(data) == jio.checksum(data)
    # chained, and over a buffer (a tensor's memory) instead of bytes
    assert tio.checksum(data[n // 2:], tio.checksum(data[:n // 2])) == \
        jio.checksum(data[n // 2:], jio.checksum(data[:n // 2]))
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    assert tio.checksum(tmf.tensor_bytes(t)) == jio.checksum(data)
    want = jio.checksum(data)
    for algorithm, digest in ((jio.CRC_ALGORITHM, want),
                              ("crc32", jio.zlib.crc32(data)),
                              (None, jio.zlib.crc32(data))):
        assert tio.verify_checksum(data, digest, algorithm)
        assert tio.verify_checksum(data, digest ^ 1, algorithm) == \
            jio.verify_checksum(data, digest ^ 1, algorithm)


def _arrays():
    """The same leaves as numpy (JAX side) and as torch tensors (port)."""
    f32 = RNG.standard_normal((3, 5)).astype(np.float32)
    bf = RNG.standard_normal(6).astype(ml_dtypes.bfloat16)
    i32 = np.int32(7)
    b = np.array([True, False, True])
    i64 = np.arange(4, dtype=np.int64) - 2
    empty = np.zeros((0, 3), np.float32)
    jax_side = [f32, bf, np.asarray(i32), b, i64, empty]
    torch_side = [torch.from_numpy(f32),
                  torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32), torch.from_numpy(b),
                  torch.from_numpy(i64), torch.zeros(0, 3)]
    return jax_side, torch_side


def _entries(mod, arrays, obj):
    roles = (mod.ROLE_OWN, mod.ROLE_REPLICATED, mod.ROLE_REPLICA)
    out = [mod.array_entry(f"params/{i}", a, role=roles[i % 3],
                           replica_of=(1 if i % 3 == 2 else None))
           for i, a in enumerate(arrays)]
    out.append(mod.object_entry("meta/9", obj, role=mod.ROLE_REPLICATED))
    return out


META = {"step": 4, "generation": 0, "rank": 1, "world": 2}


def test_shard_container_is_the_same_bytes_and_cross_reads(tmp_path):
    jax_side, torch_side = _arrays()
    obj = {"epoch": 3, "lr": 0.5, "names": ["a", "b"]}
    jblob = jmf.pack_shard(_entries(jmf, jax_side, obj), META)
    tblob = tmf.pack_shard(_entries(tmf, torch_side, obj), META)
    assert tblob == jblob
    # the streamed write is the same container, with the blob's digest
    path = str(tmp_path / "streamed.hvd")
    with open(path, "wb") as f:
        n, crc = tmf.write_shard(f, _entries(tmf, torch_side, obj), META)
    assert open(path, "rb").read() == jblob
    assert (n, crc) == (len(jblob), jio.checksum(jblob))
    # the port reads what the JAX package wrote ...
    _write(str(tmp_path / "j.hvd"), jblob)
    for meta, entries in (tmf.read_shard(str(tmp_path / "j.hvd")),
                          tmf.parse_shard(jblob)):
        assert meta["step"] == 4 and meta["crc_algorithm"] == \
            jio.CRC_ALGORITHM
        for e, want in zip(entries, torch_side):
            assert e["value"].dtype == want.dtype
            assert e["value"].shape == want.shape
            assert torch.equal(e["value"], want), e["key"]
        assert entries[-1]["value"] == obj
        assert [e["role"] for e in entries[:3]] == ["own", "replicated",
                                                    "replica"]
        assert entries[2]["replica_of"] == 1
    # ... and the JAX package reads what the port wrote
    meta, entries = jmf.read_shard(path)
    for e, want in zip(entries, jax_side):
        assert e["value"].dtype == want.dtype
        assert e["value"].tobytes() == np.asarray(want).tobytes(), e["key"]
    assert entries[-1]["value"] == obj


def test_streamed_write_chains_the_zlib_digest(tmp_path, monkeypatch):
    """Where no native crc32c is importable (zlib's CRC-32), the writer
    streams the container and chains the whole-file digest as it goes."""
    monkeypatch.setattr(tio, "CRC_ALGORITHM", "crc32")
    _, torch_side = _arrays()
    entries = _entries(tmf, torch_side, [1, 2])
    blob = tmf.pack_shard(entries, META)
    path = str(tmp_path / "s.hvd")
    with open(path, "wb") as f:
        n, crc = tmf.write_shard(f, entries, META)
    assert open(path, "rb").read() == blob
    assert (n, crc) == (len(blob), jio.zlib.crc32(blob))
    meta, got = tmf.read_shard(path)
    assert meta["crc_algorithm"] == "crc32"
    assert all(torch.equal(e["value"], t) for e, t in zip(got, torch_side))


@pytest.mark.skipif(not tio.can_extend(),
                    reason="the crc32c module gives no running digest")
def test_write_shard_streams_with_a_running_digest(tmp_path, monkeypatch):
    """Whatever the algorithm, the writer streams the container from the
    leaves' memory (the blob is never built) and runs the file's digest as
    it goes; a digest taken a few bytes at a time equals the JAX
    package's."""
    monkeypatch.setattr(tio, "_CHUNK", 7)
    monkeypatch.setattr(tmf, "pack_shard",
                        lambda *a: pytest.fail("the blob was built"))
    jax_side, torch_side = _arrays()
    jblob = jmf.pack_shard(_entries(jmf, jax_side, [1]), META)
    path = str(tmp_path / "s.hvd")
    with open(path, "wb") as f:
        n, crc = tmf.write_shard(f, _entries(tmf, torch_side, [1]), META)
    assert open(path, "rb").read() == jblob
    assert (n, crc) == (len(jblob), jio.checksum(jblob))
    assert tio.extend(tio.checksum(jblob[:50]), memoryview(jblob)[50:]) == \
        jio.checksum(jblob)
    assert tio.checksum(jblob[9:], tio.checksum(jblob[:9])) == \
        jio.checksum(jblob[9:], jio.checksum(jblob[:9]))


def test_object_leaves_refuse_torch_objects():
    with pytest.raises(TypeError, match="plain Python or numpy"):
        tmf.object_entry("meta/0", torch.device("cpu"))


@pytest.mark.parametrize("reader", ["read_shard", "parse_shard"])
def test_damage_names_the_leaf_in_a_jax_written_shard(tmp_path, reader):
    jax_side, _ = _arrays()
    blob = bytearray(jmf.pack_shard(_entries(jmf, jax_side, {"k": 1}), META))
    path = str(tmp_path / "s.hvd")

    def read(data):
        _write(path, bytes(data))
        if reader == "read_shard":
            return tmf.read_shard(path)
        return tmf.parse_shard(bytes(data), path)

    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF  # inside the last (object) leaf
    with pytest.raises(CheckpointCorruptError) as ei:
        read(flipped)
    assert ei.value.leaf == "meta/9" and path in str(ei.value)
    first = blob.index(jax_side[0].tobytes()) + 3
    flipped = bytearray(blob)
    flipped[first] ^= 0x10
    with pytest.raises(CheckpointCorruptError) as ei:
        read(flipped)
    assert ei.value.leaf == "params/0"
    with pytest.raises(CheckpointCorruptError) as ei:
        read(blob[:-3])
    assert "truncated" in str(ei.value) and ei.value.leaf == "meta/9"
    with pytest.raises(CheckpointCorruptError) as ei:
        read(b"not a shard container at all")
    assert ei.value.leaf is None
    # verify=False lets a flipped payload byte through
    flipped = bytearray(blob)
    flipped[first] ^= 0x10
    _write(path, bytes(flipped))
    _meta, entries = tmf.read_shard(path, verify=False)
    assert not torch.equal(entries[0]["value"],
                           torch.from_numpy(jax_side[0]))


def test_manifest_round_trip_and_verification(tmp_path):
    d = str(tmp_path)
    _, torch_side = _arrays()
    blob = tmf.pack_shard(_entries(tmf, torch_side, 1), META)
    name = tmf.shard_name(1, 0, 1)
    _write(os.path.join(d, name), blob)
    manifest = tmf.build_manifest(
        1, 0, 1, [{"rank": 0, "file": name, "bytes": len(blob),
                   "crc": tio.checksum(blob)}], {})
    tmf.write_manifest(d, manifest)
    assert tmf.all_steps(d) == jmf.all_steps(d) == [1]
    got = tmf.load_manifest(d, 1)
    assert got == jmf.load_manifest(d, 1)
    tmf.verify_manifest_files(d, got)
    jmf.verify_manifest_files(d, got)
    _write(os.path.join(d, name), blob[:-1])
    with pytest.raises(CheckpointCorruptError):
        tmf.verify_manifest_files(d, tmf.load_manifest(d, 1))
    _write(tmf.manifest_path(d, 2), b"{not json")
    with pytest.raises(CheckpointCorruptError):
        tmf.load_manifest(d, 2)


# ---------------------------------------------------------------------------
# Tmp hygiene: staleness keyed on writer liveness, not mtime
# ---------------------------------------------------------------------------

def test_tmp_names_parse_as_the_jax_packages():
    for name in ("base.myhost.123.r4nd.tmp", "legacy.tmp",
                 "a.b.notanint.c.tmp", "published.hvd",
                 f"shard-2-r1-of-2.hvd.{tio.hostname()}.77.ab.tmp"):
        assert tio.parse_tmp_writer(name) == jio.parse_tmp_writer(name)
    assert tio.hostname() == jio.hostname()


def test_live_writers_old_tmp_survives(tmp_path):
    d = str(tmp_path)
    fd, tmp = tio.make_tmp(d)
    os.close(fd)
    assert tio.parse_tmp_writer(os.path.basename(tmp)) == \
        (tio.hostname(), os.getpid())
    os.utime(tmp, (1.0, 1.0))  # looks hours stale by mtime
    assert tio.clean_stale_tmps(d) == 0
    assert os.path.exists(tmp)


def test_dead_writers_fresh_tmp_removed(tmp_path):
    d = str(tmp_path)
    proc = subprocess.Popen(["sleep", "0"])
    proc.wait()
    tmp = os.path.join(d, f"ckpt.{tio.hostname()}.{proc.pid}.x1y2.tmp")
    _write(tmp, b"torn")
    assert tio.clean_stale_tmps(d) == 1
    assert not os.path.exists(tmp)


def test_foreign_host_tmp_falls_back_to_mtime(tmp_path):
    d = str(tmp_path)
    tmp = os.path.join(d, f"ckpt.elsewhere.{os.getpid()}.ab.tmp")
    _write(tmp, b"torn")
    assert tio.clean_stale_tmps(d) == 0  # fresh: kept
    os.utime(tmp, (1.0, 1.0))
    assert tio.clean_stale_tmps(d) == 1  # stale: removed


def test_atomic_write_publishes_whole_or_not_at_all(tmp_path, monkeypatch):
    path = str(tmp_path / "f.bin")
    tio.atomic_write(path, b"first")
    assert open(path, "rb").read() == b"first"
    tio.atomic_write(path, memoryview(b"second"))
    assert open(path, "rb").read() == b"second"
    assert os.listdir(tmp_path) == ["f.bin"]

    def boom(*_):
        raise OSError("disk gone at the rename")

    monkeypatch.setattr(os, "replace", boom)
    with pytest.raises(OSError):
        tio.atomic_write(path, b"third")
    assert open(path, "rb").read() == b"second"  # the old file stands
    assert os.listdir(tmp_path) == ["f.bin"]     # and no tmp is left
