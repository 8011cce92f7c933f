"""One rank of the port's gloo worlds for tests/test_torch_ckpt_multiprocess.py
and tests/test_torch_checkpoint.py.

    python tests/torch_ckpt_worker.py <mode> <rank> <world> <tmpdir> [cuda]

Joins the world through a ``FileStore`` (``<tmpdir>/store``), on the CPU
or, given ``cuda``, on card ``<rank>`` (an NCCL data group); the
checkpoint directory is ``<tmpdir>/ckpts``. Modes:

* ``replicas``: a ZeRO-1 flat AdamW state (two dtype groups) after one
  step, stage-3 parameter shards, replicated parameters and a plain-value
  leaf; at steps 1 and 2 the neighbour-replica exchange, then an async
  commit. Each rank saves its own exports (``own-r<rank>-s<step>.pt``, on
  the host) for the test to check the restore against.
* ``fault``: synchronous commits of steps 1 and 2 under the caller's
  ``HOROVOD_CKPT_FAULT`` (a barrier timeout of 3 s); the survivor prints
  its abandon count.
* ``skip``: rank 1 commits step 1 only, so rank 0's step 2 times out at
  the barrier.
* ``restore0``: rank 0 saves a rank-0 checkpoint in its own directory;
  every rank restores the latest from its own directory (only rank 0's
  holds the file) and prints what it got.
"""

import os
import sys

import torch

LEAVES = {"a": (5, 3), "b": (7,), "h": (6,)}


def params_at(step: int, device="cpu") -> dict:
    """The same replicated parameters on every rank, from the step."""
    out = {}
    for i, (k, shape) in enumerate(sorted(LEAVES.items())):
        n = torch.Size(shape).numel()
        out[k] = (torch.arange(n, dtype=torch.float32, device=device) * 0.25
                  + i + step).reshape(shape)
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def trees_at(hvd, step: int, device="cpu") -> dict:
    params = params_at(step, device)
    opt = hvd.sharded_adamw(1e-2, weight_decay=1e-3)
    state = opt.init(params)
    grads = {k: torch.full_like(v, 0.125 * (hvd.rank() + 1))
             for k, v in params.items()}
    params, state = opt.apply(params, state, grads)
    return {"params": params, "opt": state,
            "sp": hvd.shard_params(params_at(step, device)),
            "meta": {"epoch": step, "note": "plain"}}


def main() -> int:
    mode, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    device = torch.device(sys.argv[5], rank) if len(sys.argv) > 5 \
        else torch.device("cpu")
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(world),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmp}/store")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ckpt import replica, stats
    from horovod_tpu_torch.ckpt import writer as wr
    from horovod_tpu_torch.parallel import zero

    d = os.path.join(tmp, "ckpts")
    hvd.init(device=device)
    if mode == "replicas":
        mgr = wr.CheckpointManager(d, async_write=True, keep=3,
                                   barrier_timeout=60.0)
        for step in (1, 2):
            trees = trees_at(hvd, step, device)
            _items, _layout, exchange = wr.build_rank_payload(
                trees, rank, world)
            assert replica.enabled()
            replica.exchange(exchange, step)
            src, got_step, keys = replica.holdings()
            assert (src, got_step) == ((rank + 1) % world, step), \
                (src, got_step)
            # the sharded keys are every rank's; the "item:" slices differ
            assert {k for k in keys if not k.startswith("item:")} == \
                {"opt/2", "sp/6"}
            held = replica.lookup("opt/2", step)
            assert held[0] == src and held[1]["kind"] == "flat_adamw"
            assert replica.lookup("opt/2", step - 1) is None
            mgr.commit(trees, step=step)
            own = {k: zero.export_shard_arrays(trees[k])
                   for k in ("opt", "sp")}
            own["params"] = {k: v.cpu() for k, v in trees["params"].items()}
            torch.save(own, os.path.join(tmp, f"own-r{rank}-s{step}.pt"))
        mgr.close()
        assert stats.COMMITS_ABANDONED.value == 0
        replica.clear("test over")
        assert replica.holdings() == (-1, -1, ()) and \
            replica.export_store() is None
    elif mode in ("fault", "skip"):
        mgr = wr.CheckpointManager(d, async_write=False, keep=10,
                                   barrier_timeout=3.0)
        for step in (1, 2):
            if mode == "skip" and rank == 1 and step == 2:
                break
            w = torch.full((4,), float(step))
            mgr.commit({"params": {"w": w}}, step=step)
        mgr.close()
        print("ABANDONED", int(stats.COMMITS_ABANDONED.value), flush=True)
    elif mode == "restore0":
        mine = os.path.join(tmp, f"r{rank}")
        saved = {"model": {"w": torch.arange(6.0) * 7,
                           "n": torch.tensor(3, dtype=torch.int64)},
                 "opt": {"lr": 0.5, "state": [torch.ones(2)]}}
        hvd.checkpoint.save(mine, saved, step=4)
        assert (rank == 0) == os.path.exists(os.path.join(mine,
                                                          "ckpt_4.hvd"))
        target = {"model": {"w": torch.zeros(6),
                            "n": torch.tensor(0, dtype=torch.int64)},
                  "opt": {"lr": 0.0, "state": [torch.zeros(2)]}}
        got, step = hvd.checkpoint.restore_latest(mine, target)
        assert step == 4, step
        assert torch.equal(got["model"]["w"], saved["model"]["w"])
        assert torch.equal(got["model"]["n"], saved["model"]["n"])
        assert got["opt"]["lr"] == 0.5
        assert torch.equal(got["opt"]["state"][0], torch.ones(2))
        assert torch.equal(target["model"]["w"], torch.zeros(6))
    else:
        raise ValueError(mode)
    hvd.shutdown()
    print("WORKER_DONE", rank, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
