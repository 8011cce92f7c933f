"""The port's elastic layer across real worker processes (mirrors
tests/test_elastic_multiprocess.py): 3-rank gloo worlds whose pytest
process hosts the port's ``RendezvousServer`` (the launcher's part).

* ``kill:rank=1:step=3``: the survivors catch ``WorkerLostError``, re-form
  to 2 ranks through the store, roll back to the last commit and finish
  with ``w == step``;
* a ``hang`` caught by ``HOROVOD_COLLECTIVE_TIMEOUT`` as a
  ``WorkerStallError`` naming the hung rank;
* ZeRO-1: after the kill, ``zero.resync`` gives shards bit-equal to the
  JAX package's ``from_full_buffers`` of the same full buffers, the dead
  rank's moments from its neighbour replica, and without the replica the
  neutral fill;
* a ``bitflip`` voted out by the digests, rolled back in place, ending on
  the clean run's bits.

On four cards (``gpu``), one rank a card with an NCCL data group: a small
transformer on ZeRO-1 loses rank 2 at step 3 and the survivors re-form
and finish. Workers: tests/torch_elastic_worker.py."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from horovod_tpu_torch.run.rendezvous import RendezvousServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
QUANTUM = 16  # bytes: the shards pad differently at 3 and 2 ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world(mode, tmp, env=None, world=3, timeout=120, cuda=False,
           wait_for=None):
    """Run ``world`` workers of ``mode``; (return codes, outputs). Ranks
    in ``wait_for`` (default all) are waited for; the others are killed
    once those are done (a hung rank)."""
    server = RendezvousServer(host="127.0.0.1")
    port = server.start()
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in list(base):
        if k.startswith("HOROVOD_"):
            base.pop(k)
    base.update({
        "HOROVOD_SIZE": str(world),
        "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{_free_port()}",
        "HOROVOD_RENDEZVOUS_HTTP_ADDR": "127.0.0.1",
        "HOROVOD_RENDEZVOUS_HTTP_PORT": str(port),
        "HOROVOD_ELASTIC": "1",
        # a dead peer surfaces within seconds, a re-form settles fast
        "HOROVOD_GLOO_TIMEOUT_SECONDS": "5",
        "HOROVOD_ELASTIC_SETTLE_SECONDS": "0.5",
        "HOROVOD_ELASTIC_MIN_WORKERS": "2",
        "HOROVOD_FUSION_BUCKET_QUANTUM": str(QUANTUM),
    })
    base.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, WORKER, mode, str(tmp)] + (["cuda"] if cuda else []),
        env=dict(base, HOROVOD_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = [""] * world
    try:
        for r in (range(world) if wait_for is None else wait_for):
            outs[r] = procs[r].communicate(timeout=timeout)[0]
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                outs[r] = p.communicate()[0]
        server.stop()
    return [p.returncode for p in procs], outs


def _field(out: str, key: str) -> str:
    return out.split(f"{key}=", 1)[1].split()[0]


def _survivors_finished(rcs, outs, size=2, steps=8):
    for i in (0, 2):
        assert rcs[i] == 0, (i, outs[i][-3000:])
        assert "DONE" in outs[i], (i, outs[i][-3000:])
        assert _field(outs[i], "size") == str(size), outs[i][-2000:]
        assert _field(outs[i], "step") == str(steps), outs[i][-2000:]
        assert _field(outs[i], "generation") == "1", outs[i][-2000:]


def test_kill_rank1_at_step3_survivors_finish(tmp_path):
    rcs, outs = _world("dp", tmp_path, env={
        "HOROVOD_FAULT_INJECT": "kill:rank=1:step=3:code=17",
        "DP_ONES": "1"})
    assert rcs[1] == 17, outs[1][-3000:]
    _survivors_finished(rcs, outs)
    for i in (0, 2):
        assert _field(outs[i], "w") == "8", outs[i][-2000:]
        assert _field(outs[i], "restarts") == "1"
        assert _field(outs[i], "seen").startswith("WorkerLostError")


def test_hang_is_a_worker_stall_by_the_collective_timeout(tmp_path):
    """Rank 1's training thread sleeps at step 3 while its cycle thread
    goes on: its announcement never comes, the coordinator's deadline
    names it, and the survivors re-form without it."""
    rcs, outs = _world("dp", tmp_path, env={
        "HOROVOD_FAULT_INJECT": "hang:rank=1:step=3:seconds=60",
        "HOROVOD_COLLECTIVE_TIMEOUT": "2",
        # a cached request re-enters negotiation once it is this stale
        "HOROVOD_STALL_CHECK_TIME_SECONDS": "0.5",
        "DP_ONES": "1"}, wait_for=(0, 2))
    _survivors_finished(rcs, outs)
    assert _field(outs[0], "seen") == "WorkerStallError:1", outs[0][-2000:]
    # the other survivor saw the coordinator's shutdown bit
    assert _field(outs[2], "seen").startswith("WorkersDown"), outs[2][-2000:]
    assert _field(outs[0], "w") == _field(outs[2], "w") == "8"


def _bf16(t: torch.Tensor) -> np.ndarray:
    import ml_dtypes

    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _np(t) -> np.ndarray:
    t = torch.as_tensor(t)
    return _bf16(t) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("replica", [True, False])
def test_zero_resync_is_the_jax_from_full_buffers(tmp_path, replica):
    from horovod_tpu.parallel import zero as jzero

    env = {"HOROVOD_FAULT_INJECT": "kill:rank=1:step=3:code=17"}
    if not replica:
        env["HOROVOD_CKPT_REPLICATION"] = "0"
    rcs, outs = _world("zero", tmp_path, env=env)
    assert rcs[1] == 17, outs[1][-3000:]
    _survivors_finished(rcs, outs)
    # the survivors' last commit: step 2 when the replica exchange of
    # step 3 met the dead rank, step 3 without the exchange (the failure
    # surfaced at step 4's collective); the dead rank's last is step 2
    synced = torch.load(tmp_path / "resynced-r0.pt")
    step = synced["step"]
    assert step == (2 if replica else 3)
    own = [torch.load(tmp_path / f"own-r{r}-s{step if r != 1 else 2}.pt")
           for r in range(3)]
    old_groups = own[0]["layout"]["groups"]
    assert own[0]["layout"]["world"] == 3
    leaves = [_np(v) for v in synced["params"].values()]
    jold = jzero.build_spec(leaves, 3, 0, QUANTUM)
    full = {"kind": "flat_adamw",
            "count": np.int32(int(own[0]["export"]["count"]))}
    for c in ("master", "mu", "nu"):
        full[c] = []
        for gi, g in enumerate(jold.groups):
            segs = [_np(own[r]["export"][c][gi]) for r in range(3)]
            if not replica:  # rank 1's segment takes the neutral fill
                segs[1] = (jzero._np_pack_group(leaves, g).astype(np.float32)
                           [g.shard_elems:2 * g.shard_elems]
                           if c == "master" else np.zeros_like(segs[1]))
            full[c].append(np.concatenate(segs))
    restores = {float(_field(outs[i], "replica_restores")) for i in (0, 2)}
    # with the replica: master, mu and nu of 2 groups, the generic state's
    # shard and 2 moments of 2 groups, a shard of 2 groups each for sp, sg
    assert restores == ({16.0} if replica else {0.0})
    for new_rank, old_rank in ((0, 0), (1, 2)):
        got = torch.load(tmp_path / f"resynced-r{old_rank}.pt")
        assert got["step"] == step
        spec = jzero.build_spec(leaves, 2, new_rank, QUANTUM)
        target = jzero.FlatAdamState(spec, np.int32(0), *[
            tuple(np.zeros(g.shard_elems, np.float32) for g in spec.groups)
            for _ in range(3)])
        want = jzero.from_full_buffers(target, full, old_groups)
        assert got["layout"] == jzero.layout_of(want)
        for c in ("master", "mu", "nu"):
            for a, b in zip(got["export"][c], getattr(want, c)):
                assert _np(a).tobytes() == np.asarray(b).tobytes(), \
                    (c, new_rank)
        assert int(got["export"]["count"]) == int(want.count) == step
    if replica:  # the dead rank's moments were not the neutral fill
        assert any(np.any(_np(own[1]["export"]["mu"][gi]) != 0)
                   for gi in range(len(old_groups)))
        # all four kinds: the new shards, gathered, are the old ones
        new = [torch.load(tmp_path / f"resynced-r{r}.pt") for r in (0, 2)]
        for name in ("optimizer", "gen", "sp", "sg"):
            lay = own[0]["kinds"][name][1]
            assert [n["kinds"][name][1]["world"] for n in new] == [2, 2]
            comps = [k for k, v in own[0]["kinds"][name][0].items()
                     if isinstance(v, list)]
            for c in comps:
                for li, old0 in enumerate(own[0]["kinds"][name][0][c]):
                    if old0.ndim == 0:  # a step count: the root's
                        assert all(torch.equal(n["kinds"][name][0][c][li],
                                               old0) for n in new)
                        continue
                    # the generic export is, a group, its shard and then
                    # its state entries
                    gi = li if name != "gen" else li // (1 + len(
                        lay["state_keys"][0]))
                    n_real = lay["groups"][gi][1]
                    old = torch.cat([o["kinds"][name][0][c][li]
                                     for o in own])[:n_real]
                    got = torch.cat([n["kinds"][name][0][c][li]
                                     for n in new])[:n_real]
                    assert torch.equal(old, got), (name, c, li)
    for i in (0, 2):
        assert _field(outs[i], "shard_world") == "2"


def test_bitflip_rolls_back_in_place_to_the_clean_runs_bits(tmp_path):
    clean_rcs, clean = _world("dp", tmp_path / "clean")
    assert clean_rcs == [0, 0, 0], clean
    rcs, outs = _world("dp", tmp_path / "flip", env={
        "HOROVOD_INTEGRITY": "1", "HOROVOD_INTEGRITY_INTERVAL": "1",
        "HOROVOD_FAULT_INJECT": "bitflip:1:after=3"})
    want = _field(clean[0], "w_hex")
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-3000:]
        assert _field(out, "replays") == "1"
        assert _field(out, "generation") == "0"  # no re-form
        # the vote named rank 1 on every rank
        assert _field(out, "seen") == "CollectiveIntegrityError:1"
        assert _field(out, "w_hex") == want


@pytest.mark.gpu
def test_four_cards_lose_rank2_and_resync_from_the_replica(tmp_path):
    """One rank a card, NCCL data group: rank 2 dies at step 3; the three
    survivors abort their groups, re-form through the store this process
    hosts, resync ZeRO-1 with rank 2's moments from rank 1's replica, and
    finish; their flight dumps name rank 2 as the culprit."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    flight = tmp_path / "flight"
    rcs, outs = _world("transformer", tmp_path, world=4, timeout=600,
                       cuda=True, env={
                           "HOROVOD_FAULT_INJECT":
                               "kill:rank=2:step=3:code=17",
                           "HOROVOD_ELASTIC_MIN_WORKERS": "3",
                           "HOROVOD_FLIGHT_RECORDER_DIR": str(flight)})
    assert rcs[2] == 17, outs[2][-3000:]
    # the survivors' flight dumps exist and the postmortem names rank 2
    from horovod_tpu_torch import flight_recorder

    dumps = flight_recorder.load_dumps(str(flight))
    assert {0, 1, 3} <= {d["launch_rank"] for d in dumps}, dumps
    assert flight_recorder.suspect_culprit(dumps)[0] == 2
    own = [torch.load(tmp_path / f"own-r{r}-s2.pt") for r in range(4)]
    for i in (0, 1, 3):
        assert rcs[i] == 0, (i, outs[i][-3000:])
        assert _field(outs[i], "size") == "3"
        assert _field(outs[i], "step") == "8"
        assert float(_field(outs[i], "replica_restores")) > 0
    # the re-sharded moments, gathered, are the old world's bit for bit
    got = [torch.load(tmp_path / f"resynced-r{r}.pt") for r in (0, 1, 3)]
    old_groups = own[0]["layout"]["groups"]
    for c in ("master", "mu", "nu"):
        for gi, (_, n, _, _) in enumerate(old_groups):
            old = torch.cat([o["export"][c][gi] for o in own])[:n]
            new = torch.cat([g["export"][c][gi] for g in got])[:n]
            assert torch.equal(old, new), (c, gi)
