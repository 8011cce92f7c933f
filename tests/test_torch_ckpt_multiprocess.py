"""The port's sharded checkpoint across real writer processes (mirrors
tests/test_ckpt_multiprocess.py): 2- and 3-rank gloo worlds on a
``FileStore`` commit with neighbour replicas and restore into the other
size; a kill at each commit phase, and a barrier timeout, leave the
previous cut restorable and bit-identical; on a machine with two cards or
more, the same commit with one rank a card. Workers:
tests/torch_ckpt_worker.py."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.ckpt import io as ckpt_io
from horovod_tpu_torch.ckpt import manifest as mf
from horovod_tpu_torch.ckpt import restore as rst
from horovod_tpu_torch.parallel import zero

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_ckpt_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_ckpt_worker as worker  # noqa: E402


def _run_world(mode, world, tmp, env=None, timeout=180, device=()):
    base = dict(os.environ, PYTHONPATH=REPO)
    for k in ("HOROVOD_CKPT_FAULT", "HOROVOD_CKPT_REPLICATION"):
        base.pop(k, None)
    base.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(r), str(world), str(tmp),
         *device],
        env=base, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [p.returncode for p in procs], outs


def _target(world, rank, step=1):
    """A fresh state of the worker's trees for ``rank`` of ``world``:
    the layout the restore re-slices into, zeros everywhere."""
    params = {k: torch.zeros_like(v) for k, v in
              worker.params_at(step).items()}
    q = zero._quantum_bytes()
    spec = zero.build_spec(list(params.values()), world, rank, q)
    opt = zero.FlatAdamState(
        spec, 0, *[tuple(torch.zeros(g.shard_elems) for g in spec.groups)
                   for _ in range(3)])
    sp = zero.ShardedParams(spec, tuple(params), tuple(
        torch.zeros(g.shard_elems, dtype=zero.group_dtype(g))
        for g in spec.groups))
    return {"params": params, "opt": opt, "sp": sp,
            "meta": {"epoch": 0, "note": ""}}


def _full(tmp, world, step, kind, comp):
    """The writing world's full flat buffers of one component, from each
    rank's own exports: one a group."""
    owns = [torch.load(os.path.join(tmp, f"own-r{r}-s{step}.pt"))[kind]
            for r in range(world)]
    return [torch.cat([o[comp][gi] for o in owns])
            for gi in range(len(owns[0][comp]))]


def _check_restored_into(tmp, old_world, new_world, step):
    """Every rank of ``new_world`` restores ``step``: each shard equals
    its slice of the old world's full buffers, the rest bit-equal."""
    layout = mf.load_manifest(os.path.join(tmp, "ckpts"), step)["sharded"]
    groups = layout["opt/2"]["groups"]
    fulls = {("opt", c): _full(tmp, old_world, step, "opt", c)
             for c in ("master", "mu", "nu")}
    fulls[("sp", "leaves")] = _full(tmp, old_world, step, "sp", "leaves")
    seen = {}
    for r in range(new_world):
        trees, got = rst.restore_latest(os.path.join(tmp, "ckpts"),
                                        _target(new_world, r, step))
        assert got == step
        assert trees["meta"] == {"epoch": step, "note": "plain"}
        opt, sp = trees["opt"], trees["sp"]
        assert opt.count == 1 and opt.spec.world == new_world
        for (kind, comp), full in fulls.items():
            shards = getattr(trees[kind], "shards" if kind == "sp" else comp)
            for gi, g in enumerate(opt.spec.groups):
                n = int(groups[gi][1])
                lo = r * g.shard_elems
                want = torch.zeros(g.shard_elems, dtype=shards[gi].dtype)
                real = full[gi][:n]
                if lo < n:
                    k = min(lo + g.shard_elems, n) - lo
                    want[:k] = real[lo:lo + k]
                assert torch.equal(shards[gi], want), (kind, comp, r, gi)
        seen[r] = trees["params"]
    want = torch.load(os.path.join(tmp, f"own-r0-s{step}.pt"))["params"]
    for r in range(new_world):
        assert seen[r].keys() == want.keys()
        for k in want:
            assert torch.equal(seen[r][k], want[k]), (r, k)


@pytest.mark.parametrize("world,other", [(2, 3), (3, 2)])
def test_commits_with_replicas_restore_into_the_other_size(tmp_path, world,
                                                          other):
    rcs, outs = _run_world("replicas", world, tmp_path)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-3000:]
    d = str(tmp_path / "ckpts")
    assert mf.all_steps(d) == [1, 2]
    manifest = mf.load_manifest(d, 2)
    assert manifest["world"] == world
    assert manifest["sharded"]["opt/2"]["kind"] == "flat_adamw"
    assert manifest["sharded"]["sp/6"]["kind"] == "sharded_params"
    # each file holds its right neighbour's bytes as replica entries
    for r in range(world):
        _meta, entries = mf.read_shard(
            os.path.join(d, mf.shard_name(2, r, world)))
        reps = {e["replica_of"] for e in entries if e["role"] == "replica"}
        assert reps == {(r + 1) % world}
    _check_restored_into(tmp_path, world, other, 2)
    _check_restored_into(tmp_path, world, world, 2)
    # a lost shard file restores from its left neighbour's replica section
    os.unlink(os.path.join(d, mf.shard_name(2, world - 1, world)))
    _check_restored_into(tmp_path, world, other, 2)


@pytest.mark.gpu
def test_commits_across_the_cards_restore_on_the_host(tmp_path):
    """One rank a card: the flat AdamW step on each card, the replica
    ring's ragged allgather on NCCL, the snapshot of CUDA tensors into
    pinned slabs, and the commit barrier on the store ``hvd.init()`` made
    the world from; restored on the host into half the world and into the
    whole, and from the replica section once a shard file is lost."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices or more")
    world = torch.cuda.device_count()
    rcs, outs = _run_world("replicas", world, tmp_path, timeout=600,
                           device=("cuda",))
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-3000:]
    d = str(tmp_path / "ckpts")
    assert mf.all_steps(d) == [1, 2]
    assert mf.load_manifest(d, 2)["world"] == world
    _check_restored_into(tmp_path, world, world // 2, 2)
    _check_restored_into(tmp_path, world, world, 2)
    os.unlink(os.path.join(d, mf.shard_name(2, world - 1, world)))
    _check_restored_into(tmp_path, world, world // 2, 2)


@pytest.mark.parametrize("phase", ["stage", "barrier", "publish"])
def test_kill_at_a_commit_phase_keeps_the_previous_cut(tmp_path, phase):
    rcs, outs = _run_world(
        "fault", 2, tmp_path,
        env={"HOROVOD_CKPT_FAULT": f"kill:rank=1:phase={phase}:step=2"
                                   ":code=21"})
    assert rcs[1] == 21, outs[1][-2000:]
    assert rcs[0] == 0, outs[0][-2000:]
    assert "ABANDONED 1" in outs[0] and "WORKER_DONE 0" in outs[0]
    d = str(tmp_path / "ckpts")
    assert mf.all_steps(d) == [1]
    trees, step = rst.restore_latest(d, {"params": {"w": torch.zeros(4)}})
    assert step == 1
    assert torch.equal(trees["params"]["w"], torch.full((4,), 1.0))
    tmps = [n for n in os.listdir(d) if n.endswith(".tmp")]
    if phase == "publish":  # renamed before the kill: nothing staged
        assert tmps == []
    else:  # the dead writer's staged tmp, reclaimed now its pid is gone
        assert len(tmps) == 1, tmps
        assert ckpt_io.clean_stale_tmps(d) == 1


def test_barrier_timeout_abandons_the_commit(tmp_path):
    rcs, outs = _run_world("skip", 2, tmp_path)
    assert rcs == [0, 0], [o[-2000:] for o in outs]
    assert "ABANDONED 1" in outs[0]
    d = str(tmp_path / "ckpts")
    assert mf.all_steps(d) == [1]
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    trees, step = rst.restore_latest(d, {"params": {"w": torch.zeros(4)}})
    assert step == 1 and np.array_equal(trees["params"]["w"].numpy(),
                                        np.ones(4, np.float32))
