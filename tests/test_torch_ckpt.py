"""The port's sharded checkpoint against the JAX package's (mirrors
tests/test_ckpt.py): ZeRO's layout, export and re-slice bit-equal to the
JAX package's at 2->3, 3->2 and 2->1; the generic kind through a
bit-equal resume; the two-phase commit and its restore at world 1, keep-N,
torn and corrupt cuts, the replica fallback; P2 checkpoint directories
that each package restores from the other bit for bit; the snapshot's
copy-on-commit and ``copy=False``'s refusals; the commit fault's parser
and the launch rank it keys on."""

import os
import sys
import threading

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.ckpt import manifest as jmf
from horovod_tpu.ckpt import restore as jrst
from horovod_tpu.ckpt import writer as jwr
from horovod_tpu.parallel import zero as jzero
from horovod_tpu_torch.ckpt import io as ckpt_io
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import restore as rst
from horovod_tpu_torch.ckpt import stats
from horovod_tpu_torch.ckpt import writer as wr
from horovod_tpu_torch.elastic import fault_inject
from horovod_tpu_torch.exceptions import CheckpointCorruptError
from horovod_tpu_torch.parallel import zero

QUANTUM = 16  # bytes: small enough that the shards pad differently
SHAPES = (((5, 3), "float32"), ((7,), "float32"), ((6,), "bfloat16"))


@pytest.fixture
def world1():
    hvd.shutdown()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _write(path, blob):
    with open(path, "wb") as f:
        f.write(blob)


# ---------------------------------------------------------------------------
# Layout, export and re-slice against the JAX package
# ---------------------------------------------------------------------------

def _specs(world, rank):
    ours = zero.build_spec(
        [zero.LeafMeta(s, getattr(torch, d)) for s, d in SHAPES], world,
        rank, QUANTUM)
    theirs = jzero.build_spec(
        [np.zeros(s, ml_dtypes.bfloat16 if d == "bfloat16" else d)
         for s, d in SHAPES], world, rank, QUANTUM)
    return ours, theirs


def _np(x):
    """Raw bytes of a tensor or an array, for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().view(torch.uint8).numpy().tobytes() \
            if x.ndim else x.reshape(1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _states(kind, world, rank, fill=None):
    """(port state, JAX state) of ``kind`` for ``rank`` of ``world``:
    zeros, or this rank's slices of the full buffers ``fill``."""
    ours, theirs = _specs(world, rank)

    def shard(gi, g, comp="leaves", f32=False):
        dt = ml_dtypes.bfloat16 if g.dtype == "bfloat16" and not f32 \
            else np.float32
        if fill is None:
            return np.zeros(g.shard_elems, dt)
        lo = rank * g.shard_elems
        return np.asarray(fill[comp][gi][lo:lo + g.shard_elems]).astype(dt)

    if kind == "flat_adamw":
        comps = {c: [shard(gi, g, c, True) for gi, g in enumerate(
            theirs.groups)] for c in ("master", "mu", "nu")}
        count = 0 if fill is None else 9
        jstate = jzero.FlatAdamState(theirs, np.int32(count), *[
            tuple(comps[c]) for c in ("master", "mu", "nu")])
        tstate = zero.FlatAdamState(ours, count, *[
            tuple(_torch(a) for a in comps[c])
            for c in ("master", "mu", "nu")])
        return tstate, jstate
    shards = [shard(gi, g) for gi, g in enumerate(theirs.groups)]
    if kind == "sharded_params":
        return (zero.ShardedParams(ours, ("a", "b", "h"),
                                   [_torch(s) for s in shards]),
                jzero.ShardedParams(theirs, jax.tree_util.tree_structure(
                    {"a": 0, "b": 0, "h": 0}), tuple(shards)))
    return (zero.ShardedGrads(ours, tuple(_torch(s) for s in shards)),
            jzero.ShardedGrads(theirs, tuple(shards)))


def _full(kind, world, seed):
    """Full old flat buffers: random real elements, zero pad."""
    rng = np.random.default_rng(seed)
    _, spec = _specs(world, 0)
    comps = ("master", "mu", "nu") if kind == "flat_adamw" else ("leaves",)
    out = {}
    for c in comps:
        out[c] = []
        for g in spec.groups:
            dt = np.float32 if kind == "flat_adamw" or g.dtype == "float32" \
                else ml_dtypes.bfloat16
            buf = np.zeros(g.padded, dt)
            buf[:g.n] = rng.standard_normal(g.n).astype(dt)
            out[c].append(buf)
    if kind == "flat_adamw":
        out["count"] = np.int32(9)
    return out


KINDS = ("flat_adamw", "sharded_params", "sharded_grads")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("old,new", [(2, 3), (3, 2), (2, 1)])
def test_layout_export_and_reslice_are_the_jax_packages(kind, old, new):
    full = _full(kind, old, seed=old * 10 + new)
    # the writing world: layout and exports equal, rank by rank
    for r in range(old):
        ours, theirs = _states(kind, old, r, fill=full)
        assert zero.is_sharded_state(ours)
        assert zero.layout_of(ours) == jzero.layout_of(theirs)
        mine, want = zero.export_shard_arrays(ours), \
            jzero.export_shard_arrays(theirs)
        assert mine.keys() == want.keys() and mine["kind"] == want["kind"]
        for k in mine:
            if k == "kind":
                continue
            if k == "count":
                assert mine[k].dtype == torch.int32 and mine[k].ndim == 0
                assert _np(mine[k]) == _np(want[k])
                continue
            assert [_np(x) for x in mine[k]] == [_np(x) for x in want[k]]
    old_groups = zero.layout_of(_states(kind, old, 0)[0])["groups"]
    tfull = {k: ([_torch(b) for b in v] if isinstance(v, list) else v)
             for k, v in full.items()}
    for r in range(new):
        t_target, j_target = _states(kind, new, r)
        got = zero.from_full_buffers(t_target, tfull, old_groups)
        want = jzero.from_full_buffers(j_target, full, old_groups)
        assert type(got).__name__ == type(want).__name__
        assert got.spec.world == new and got.spec.rank == r
        comps = ("master", "mu", "nu") if kind == "flat_adamw" \
            else ("shards",)
        for c in comps:
            assert [_np(x) for x in getattr(got, c)] == \
                [_np(x) for x in getattr(want, c)], (c, r)
        if kind == "flat_adamw":
            assert got.count == int(want.count) == 9


def test_generic_kind_reslices_its_inner_state():
    """A ``sharded_update`` state re-sliced into world 3: each group's
    shard and its 1-D state entries take this rank's slice, a 0-d entry
    (AdamW's ``step``) comes back whole."""
    rng = np.random.default_rng(5)
    old_spec, _ = _specs(2, 0)
    keys = [["exp_avg", "exp_avg_sq", "step"]] * len(old_spec.groups)
    leaves, want = [], []
    for g in old_spec.groups:
        dt = zero.group_dtype(g)
        bufs = [torch.zeros(g.padded, dtype=dt) for _ in range(3)]
        for b in bufs:
            b[:g.n] = torch.from_numpy(rng.standard_normal(g.n)).to(dt)
        leaves += [bufs[0], bufs[1], bufs[2], torch.tensor(4.0)]
        want.append(bufs)
    for r in range(3):
        spec, _ = _specs(3, r)
        inner = torch.optim.AdamW([torch.zeros(g.shard_elems,
                                               dtype=zero.group_dtype(g))
                                   for g in spec.groups], lr=0.5)
        target = zero.ShardedOptState(spec, inner)
        got = zero.from_full_buffers(
            target, {"kind": "generic", "leaves": leaves, "state_keys": keys},
            [[g.dtype, g.n, g.shard_elems, g.padded]
             for g in old_spec.groups])
        assert got.inner is not inner and got.inner.param_groups[0]["lr"] \
            == 0.5
        for gi, (g, shard) in enumerate(zip(spec.groups,
                                            got.inner.param_groups[0][
                                                "params"])):
            lo, hi = r * g.shard_elems, (r + 1) * g.shard_elems
            real = [torch.cat([b[:g.n], torch.zeros(g.padded, dtype=b.dtype)])
                    [lo:hi] for b in want[gi]]
            assert torch.equal(shard, real[0])
            st = got.inner.state[shard]
            assert torch.equal(st["exp_avg"], real[1])
            assert torch.equal(st["exp_avg_sq"], real[2])
            assert float(st["step"]) == 4.0


def test_generic_kind_resumes_bit_for_bit(world1, tmp_path):
    def params_of():
        torch.manual_seed(0)
        return {"w": torch.randn(5, 3), "b": torch.randn(7),
                "h": torch.randn(6).to(torch.bfloat16)}

    def opt_of(params):
        return hvd.sharded_update(
            torch.optim.AdamW(list(params.values()), lr=1e-2,
                              weight_decay=1e-3),
            named_parameters=params.items())

    def step(params, opt, i):
        g = {k: torch.full_like(v, 0.1 * (i + 1)) for k, v in params.items()}
        opt.step(grads=g)

    params = params_of()
    opt = opt_of(params)
    for i in range(2):
        step(params, opt, i)
    mgr = wr.CheckpointManager(str(tmp_path), async_write=False, keep=2)
    mgr.commit({"params": params, "opt": opt.state}, step=2)
    layout = mf.load_manifest(str(tmp_path), 2)["sharded"]["opt/0"]
    assert layout["kind"] == "generic"
    assert layout["state_keys"] == [["exp_avg", "exp_avg_sq", "step"]] * 2
    for i in range(2, 4):
        step(params, opt, i)

    fresh = {k: torch.zeros_like(v) for k, v in params_of().items()}
    opt2 = opt_of(fresh)
    trees, got = rst.restore_latest(str(tmp_path), {
        "params": fresh, "opt": opt2.init(fresh)})
    assert got == 2
    with torch.no_grad():
        for k, v in trees["params"].items():
            fresh[k].copy_(v)
    opt2.state = trees["opt"]
    for i in range(2, 4):
        step(fresh, opt2, i)
    for k in params:
        assert torch.equal(fresh[k], params[k]), k


# ---------------------------------------------------------------------------
# Two-phase commit, one writer
# ---------------------------------------------------------------------------

def _trees(scale):
    return {"params": {"w": torch.full((6,), float(scale)),
                       "b": torch.tensor(float(scale))},
            "extra": None}


def _target():
    return {"params": {"w": torch.zeros(6), "b": torch.tensor(0.0)},
            "extra": None}


class TestCommitRestore:
    def test_default_world_is_the_process_world(self, world1, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=False, keep=4)
        mgr.commit(_trees(1), step=1)
        mgr.close()
        assert mf.all_steps(d) == [1]
        assert mf.load_manifest(d, 1)["world"] == 1

    def test_commit_restore_roundtrip(self, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=False, keep=4)
        mgr.commit(_trees(1), step=1, generation=0, rank=0, world=1)
        mgr.commit(_trees(2), step=2, generation=0, rank=0, world=1)
        mgr.close()
        assert mf.all_steps(d) == [1, 2]
        trees, step = rst.restore_latest(d, _target())
        assert step == 2 and trees["extra"] is None
        assert torch.equal(trees["params"]["w"], torch.full((6,), 2.0))
        assert float(trees["params"]["b"]) == 2.0

    def test_gc_keeps_last_k_and_reuses_slabs(self, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=False, keep=2)
        for s in (1, 2, 3, 4):
            mgr.commit(_trees(s), step=s, generation=0, rank=0, world=1)
            if s == 1:
                first = mgr.slab_allocations
        assert first == 1 and mgr.slab_allocations == 1
        mgr.close()
        assert mf.all_steps(d) == [3, 4]
        assert not os.path.exists(os.path.join(d, mf.shard_name(1, 0, 1)))
        assert mgr.last_commit["step"] == 4 and mgr.last_commit["bytes"] == \
            os.path.getsize(os.path.join(d, mf.shard_name(4, 0, 1)))

    def test_async_commit_flushes_on_wait(self, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=True, keep=2)
        mgr.commit(_trees(5), step=5, generation=0, rank=0, world=1)
        mgr.wait()
        mgr.close()
        trees, step = rst.restore_latest(d, _target())
        assert step == 5
        assert torch.equal(trees["params"]["w"], torch.full((6,), 5.0))

    def test_torn_newest_falls_back_and_all_corrupt_raises(self, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=False, keep=4)
        mgr.commit(_trees(1), step=1, generation=0, rank=0, world=1)
        mgr.commit(_trees(2), step=2, generation=0, rank=0, world=1)
        mgr.close()
        shard2 = os.path.join(d, mf.shard_name(2, 0, 1))
        blob = bytearray(open(shard2, "rb").read())
        blob[-1] ^= 0xFF
        _write(shard2, bytes(blob))
        before = stats.INTEGRITY_FAILURES.value
        trees, step = rst.restore_latest(d, _target())
        assert step == 1  # damaged cut skipped, previous restored
        assert torch.equal(trees["params"]["w"], torch.full((6,), 1.0))
        assert stats.INTEGRITY_FAILURES.value > before
        _write(os.path.join(d, mf.shard_name(1, 0, 1)), b"")
        with pytest.raises(CheckpointCorruptError):
            rst.restore_latest(d, _target())

    def test_staged_tmp_invisible_to_restore(self, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=False, keep=4)
        mgr.commit(_trees(1), step=1, generation=0, rank=0, world=1)
        mgr.close()
        fd, _tmp = ckpt_io.make_tmp(d, base=mf.shard_name(2, 0, 1))
        with os.fdopen(fd, "wb") as f:
            f.write(b"half a shard, writer died here")
        assert mf.all_steps(d) == [1]
        assert rst.restore_latest(d, _target())[1] == 1

    def test_restore_empty_dir(self, tmp_path):
        assert rst.restore_latest(str(tmp_path), _target()) == (None, None)

    def test_structure_change_is_loud(self, tmp_path):
        d = str(tmp_path)
        mgr = wr.CheckpointManager(d, async_write=False, keep=4)
        mgr.commit(_trees(1), step=1, generation=0, rank=0, world=1)
        mgr.close()
        target = _target()
        target["params"]["new_leaf"] = torch.zeros(2)
        with pytest.raises(CheckpointCorruptError):
            rst.restore_step(d, 1, target)
        target = _target()
        target["params"]["w"] = torch.zeros(7)
        with pytest.raises(CheckpointCorruptError):
            rst.restore_step(d, 1, target)


class TestReplicaFallback:
    def _publish_world2(self, d):
        """A 2-rank checkpoint whose rank-0 file also carries rank 1's
        bytes as replica entries (what the neighbour ring produces)."""
        w0 = torch.arange(4, dtype=torch.float32)
        w1 = torch.arange(4, dtype=torch.float32) * 10
        shards = []
        for rank, entries in (
            (0, [mf.array_entry("params/0", w0, role=mf.ROLE_REPLICATED),
                 mf.array_entry("params/1", w1, role=mf.ROLE_REPLICA,
                                replica_of=1)]),
            (1, [mf.array_entry("params/1", w1, role=mf.ROLE_REPLICATED)]),
        ):
            blob = mf.pack_shard(entries, meta={"step": 3, "rank": rank})
            name = mf.shard_name(3, rank, 2)
            _write(os.path.join(d, name), blob)
            shards.append({"rank": rank, "file": name, "bytes": len(blob),
                           "crc": ckpt_io.checksum(blob)})
        mf.write_manifest(d, mf.build_manifest(3, 0, 2, shards, {}))
        return w0, w1

    def test_missing_shard_recovered_from_replica(self, tmp_path):
        d = str(tmp_path)
        w0, w1 = self._publish_world2(d)
        os.unlink(os.path.join(d, mf.shard_name(3, 1, 2)))
        before = stats.REPLICA_RESTORES.value
        target = {"params": {"a": torch.zeros(4), "b": torch.zeros(4)}}
        trees, step = rst.restore_step(d, 3, target)
        assert step == 3
        assert torch.equal(trees["params"]["a"], w0)
        assert torch.equal(trees["params"]["b"], w1)
        assert stats.REPLICA_RESTORES.value == before + 1

    def test_unrecoverable_without_replica(self, tmp_path):
        d = str(tmp_path)
        self._publish_world2(d)
        os.unlink(os.path.join(d, mf.shard_name(3, 0, 2)))
        target = {"params": {"a": torch.zeros(4), "b": torch.zeros(4)}}
        with pytest.raises(CheckpointCorruptError):
            rst.restore_step(d, 3, target)


# ---------------------------------------------------------------------------
# P2 checkpoint directories across the packages
# ---------------------------------------------------------------------------

def _p2(world, rank, seed):
    """A P2-shaped pair of trees (parameters + a flat AdamW state) for
    ``rank`` of ``world``, the same values as numpy and as torch."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, (shape, dt) in zip(("a", "b", "h"), SHAPES):
        a = rng.standard_normal(shape).astype(
            ml_dtypes.bfloat16 if dt == "bfloat16" else dt)
        params[name] = a
    full = _full("flat_adamw", world, seed)
    tstate, jstate = _states("flat_adamw", world, rank, fill=full)
    return ({"params": {k: _torch(v) for k, v in params.items()},
             "opt": tstate},
            {"params": params, "opt": jstate}, full)


def _same_p2(ours, theirs):
    for k in theirs["params"]:
        assert _np(ours["params"][k]) == _np(theirs["params"][k]), k
    for c in ("master", "mu", "nu"):
        assert [_np(x) for x in getattr(ours["opt"], c)] == \
            [_np(x) for x in getattr(theirs["opt"], c)], c
    assert int(ours["opt"].count) == int(theirs["opt"].count)


def test_a_jax_written_p2_directory_restores_bit_for_bit(tmp_path):
    d = str(tmp_path)
    tree_t, tree_j, _ = _p2(1, 0, seed=1)
    mgr = jwr.CheckpointManager(d, async_write=False, keep=2)
    mgr.commit(tree_j, step=7, generation=0, rank=0, world=1)
    mgr.close()
    zeros_t, _zeros_j, _ = _p2(1, 0, seed=2)
    trees, step = rst.restore_latest(d, zeros_t)
    assert step == 7
    _same_p2(trees, tree_j)
    assert all(trees["params"][k].dtype == tree_t["params"][k].dtype
               for k in tree_t["params"])


def test_a_port_written_p2_directory_restores_in_the_jax_package(tmp_path):
    d = str(tmp_path)
    tree_t, tree_j, _ = _p2(1, 0, seed=3)
    mgr = wr.CheckpointManager(d, async_write=True, keep=2)
    mgr.commit(tree_t, step=4, generation=0, rank=0, world=1)
    mgr.close()
    assert jmf.load_manifest(d, 4)["sharded"] == \
        {"opt/0": jzero.layout_of(tree_j["opt"])}
    _, zeros_j, _ = _p2(1, 0, seed=4)
    trees, step = jrst.restore_latest(d, zeros_j)
    assert step == 4
    _same_p2(tree_t, trees)


def test_a_jax_world2_p2_directory_restores_into_world3(tmp_path):
    """Two JAX writers (the shared-filesystem fallback), three port
    readers: each new rank's shards are its slices of the full buffers."""
    d = str(tmp_path)
    for rank in (1, 0):
        _, tree_j, full = _p2(2, rank, seed=5)
        mgr = jwr.CheckpointManager(d, async_write=False, keep=2,
                                    barrier_timeout=5.0)
        mgr.commit(tree_j, step=1, generation=0, rank=rank, world=2)
        mgr.close()
    for r in range(3):
        target, _, _ = _p2(3, r, seed=6)
        trees, step = rst.restore_latest(d, target)
        _, want_j, _ = _p2(3, r, seed=5)
        spec = trees["opt"].spec
        assert step == 1 and (spec.world, spec.rank) == (3, r)
        # the same full buffers, sliced for world 3
        _tstate, jstate = _states("flat_adamw", 3, r, fill=full)
        _same_p2(trees, {"params": want_j["params"], "opt": jstate})


# ---------------------------------------------------------------------------
# The snapshot: copy-on-commit, copy=False
# ---------------------------------------------------------------------------

def _blocked_writer(monkeypatch):
    """Hold the writer thread at its first step until the event is set."""
    go = threading.Event()
    real = ckpt_io.clean_stale_tmps

    def held(directory, now=None):
        assert go.wait(30)
        return real(directory, now)

    monkeypatch.setattr(ckpt_io, "clean_stale_tmps", held)
    return go


def test_copy_on_commit_keeps_the_committed_bytes(tmp_path, monkeypatch):
    go = _blocked_writer(monkeypatch)
    w = torch.arange(6, dtype=torch.float32)
    mgr = wr.CheckpointManager(str(tmp_path), async_write=True, keep=2)
    mgr.commit({"params": {"w": w}, "meta": [{"epoch": 1}]}, step=1, rank=0,
               world=1)
    w.add_(100)  # an in-place update right after commit() returns
    go.set()
    mgr.close()
    trees, _ = rst.restore_latest(str(tmp_path), {
        "params": {"w": torch.zeros(6)}, "meta": [{"epoch": 0}]})
    assert torch.equal(trees["params"]["w"], torch.arange(6.0))
    assert trees["meta"] == [{"epoch": 1}]


def test_async_commits_under_fast_thread_switches_keep_each_step(tmp_path):
    """Stress: 24 asynchronous commits of a tensor that the training thread
    updates in place right after each, with the interpreter switching
    threads every microsecond: every published step holds its own value,
    and the slabs stay bounded (one written, one queued)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = torch.zeros(4096)
        mgr = wr.CheckpointManager(str(tmp_path), async_write=True, keep=30)
        for s in range(1, 25):
            w.fill_(float(s))
            mgr.commit({"w": w, "s": s}, step=s, rank=0, world=1)
            w.fill_(-1.0)
        mgr.close()
    finally:
        sys.setswitchinterval(old)
    assert mf.all_steps(str(tmp_path)) == list(range(1, 25))
    assert mgr.slab_allocations <= 2
    for s in (1, 7, 24):
        trees, _ = rst.restore_step(str(tmp_path), s, {"w": torch.zeros(4096),
                                                       "s": 0})
        assert trees["s"] == s and torch.equal(trees["w"],
                                               torch.full((4096,), float(s)))


def test_a_third_commit_waits_for_the_slot_before_its_snapshot(
        tmp_path, monkeypatch):
    """With one commit being written and one queued, a third takes no
    snapshot (allocates no slab) until the first is written, then reuses
    the slab that the first gave back."""
    gate = threading.Event()
    mgr = wr.CheckpointManager(str(tmp_path), async_write=True, keep=5)
    write = mgr._write_commit
    monkeypatch.setattr(mgr, "_write_commit",
                        lambda p: gate.wait(30) and write(p))
    w = torch.zeros(1024)
    for s in (1, 2):
        w.fill_(float(s))
        mgr.commit({"w": w}, step=s, rank=0, world=1)
    w.fill_(3.0)
    third = threading.Thread(
        target=mgr.commit, args=({"w": w}, 3), kwargs={"rank": 0, "world": 1})
    third.start()
    third.join(0.5)
    assert third.is_alive() and mgr.slab_allocations == 2
    gate.set()
    third.join(30)
    mgr.close()
    assert not third.is_alive() and mgr.slab_allocations == 2
    assert mf.all_steps(str(tmp_path)) == [1, 2, 3]
    for s in (1, 2, 3):
        trees, _ = rst.restore_step(str(tmp_path), s, {"w": torch.zeros(1024)})
        assert torch.equal(trees["w"], torch.full((1024,), float(s)))


def test_copy_false_refuses_device_tensors(tmp_path):
    mgr = wr.CheckpointManager(str(tmp_path), async_write=False)
    with pytest.raises(ValueError, match="copy=False"):
        mgr.commit({"params": {"w": torch.empty(4, device="meta")}}, step=1,
                   rank=0, world=1, copy=False)
    assert mf.all_steps(str(tmp_path)) == []


def test_copy_false_abandons_a_commit_whose_tensor_changed(tmp_path,
                                                          monkeypatch):
    go = _blocked_writer(monkeypatch)
    w = torch.arange(6, dtype=torch.float32)
    mgr = wr.CheckpointManager(str(tmp_path), async_write=True, keep=2)
    before = stats.COMMITS_ABANDONED.value
    mgr.commit({"params": {"w": w}}, step=1, rank=0, world=1, copy=False)
    w.mul_(2)  # the promise broken
    go.set()
    mgr.close()
    assert stats.COMMITS_ABANDONED.value == before + 1
    assert mf.all_steps(str(tmp_path)) == []
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # kept, it publishes as it is
    mgr = wr.CheckpointManager(str(tmp_path), async_write=False)
    mgr.commit({"params": {"w": w}}, step=2, rank=0, world=1, copy=False)
    assert mf.all_steps(str(tmp_path)) == [2]


# ---------------------------------------------------------------------------
# The fault parsers
# ---------------------------------------------------------------------------

def test_parse_fault_matches_the_jax_package():
    for text in ("kill:rank=2:phase=publish:step=7:code=19",
                 "kill:rank=0:phase=stage", "", None):
        got, want = wr.parse_fault(text), jwr.parse_fault(text)
        assert (got is None and want is None) or tuple(got) == tuple(want)
    for bad in ("pause:rank=0:phase=stage", "kill:rank=0",
                "kill:rank=0:phase=flush"):
        with pytest.raises(ValueError):
            wr.parse_fault(bad)


def test_initial_rank_is_frozen_at_its_first_read(monkeypatch):
    """The commit-phase fault names the launch rank, which a later change
    of HOROVOD_RANK (a re-form renumbering survivors) must not move."""
    from horovod_tpu.elastic import fault_inject as jfi

    monkeypatch.setattr(fault_inject, "_initial_rank", None)
    monkeypatch.setattr(jfi, "_initial_rank", None)
    monkeypatch.setenv("HOROVOD_RANK", "3")
    assert fault_inject.initial_rank() == jfi.initial_rank() == 3
    monkeypatch.setenv("HOROVOD_RANK", "1")
    assert fault_inject.initial_rank() == jfi.initial_rank() == 3
