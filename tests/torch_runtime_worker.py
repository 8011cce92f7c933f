"""One rank of the port's 2- and 3-rank gloo worlds for
tests/test_torch_data_plane.py.

Started through ``torch.multiprocessing`` (spawn). Reads the shared inputs
from ``inputs.npz``, joins the world through a ``FileStore`` (rank 0 also
writes ``HOROVOD_TIMELINE``), and writes what it got to ``rank<r>.npz``:

* each of the five reductions over a group of tensors in f32, bf16 and
  int32 (one grouped enqueue: fused bins), the runtime's allreduce calls
  for each group; broadcast, allgather and reduce-scatter of each dtype;
* the same groups again on new runtimes at a 256-byte threshold (several
  bins a group), at pipeline depths 2 and 1;
* with ``bert``: 4 steps of a tiny BERT under ``DistributedOptimizer
  (AdamW)`` on this rank's batch, the parameters after each step and the
  runtime's counts a step (allreduce calls, cycles that executed a
  response, cache hits, slabs, groups).
"""

import os

import numpy as np
import torch

OPS = ("sum", "average", "min", "max", "product")
DTYPES = ("float32", "bfloat16", "int32")
N_GROUP = 4
BERT = dict(vocab_size=64, d_model=64, num_layers=2, num_heads=4, d_ff=128,
            max_seq=32)
STEPS = 4


def _np(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def _collectives(hvd, inp, rank: int, size: int, out: dict, tag: str) -> None:
    from horovod_tpu_torch.runtime import runtime

    ops = dict(sum=hvd.Sum, average=hvd.Average, min=hvd.Min, max=hvd.Max,
               product=hvd.Product)
    for dt in DTYPES:
        xs = [torch.from_numpy(inp[f"x{i}_{dt}"][rank]).to(getattr(torch, dt))
              for i in range(N_GROUP)]
        for op in OPS:
            before = runtime.COUNTS["allreduce"]
            got = hvd.grouped_allreduce(xs, op=ops[op], name=f"{dt}.{op}")
            out[f"{tag}calls_{dt}_{op}"] = np.asarray(
                runtime.COUNTS["allreduce"] - before)
            for i, g in enumerate(got):
                out[f"{tag}ar_{dt}_{op}_{i}"] = _np(g)
        out[f"{tag}bcast_{dt}"] = _np(hvd.broadcast(xs[0], root_rank=size - 1,
                                                    name=f"{dt}.bcast"))
        out[f"{tag}ag_{dt}"] = _np(hvd.allgather(xs[1], name=f"{dt}.ag"))
        out[f"{tag}rs_{dt}"] = _np(hvd.reducescatter(xs[2], op=hvd.Sum,
                                                     name=f"{dt}.rs"))


def _bert(hvd, inp, rank: int, out: dict) -> None:
    from horovod_tpu_torch.models import transformer as ttr
    from horovod_tpu_torch.runtime import runtime

    model = ttr.BertBase(dtype=torch.float32, device="cpu", **BERT)
    # rank 1 starts from other weights; the broadcast makes them rank 0's
    model.load_state_dict({k[2:]: torch.from_numpy(inp[k] + rank)
                           for k in inp.files if k.startswith("p.")})
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    toks, pos, lab = (torch.from_numpy(inp[k][rank])
                      for k in ("tokens", "pos", "labels"))
    snaps = [dict(runtime.COUNTS)]
    for step in range(STEPS):
        opt.zero_grad()
        loss = ttr.masked_lm_loss_gathered(model(toks, output="hidden"),
                                           model.token_embed, pos, lab)
        loss.backward()
        opt.step()
        snaps.append(dict(runtime.COUNTS))
        for k, p in model.named_parameters():
            out[f"step{step}.{k}"] = p.detach().numpy().copy()
    for key in ("allreduce", "busy_cycles", "cache_hits", "slabs", "groups"):
        out[f"bert_{key}"] = np.asarray([b[key] - a[key] for a, b in
                                         zip(snaps, snaps[1:])])


def run(rank: int, size: int, tmpdir: str, bert: bool) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store",
                      HOROVOD_TIMELINE=os.path.join(tmpdir, "timeline.json"))
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.utils import env

    # tiny shapes: more threads only contend with a loaded host's other
    # processes
    torch.set_num_threads(1)
    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        out = {}
        _collectives(hvd, inp, rank, size, out, "")
        # new runtimes on the same groups (each stop goes out as the
        # shutdown bit, so every rank's loop ends in the same cycle), at a
        # 256-byte threshold, so a group makes several bins, first at
        # pipeline depth 2, then 1
        # (a runtime reads the knobs init() parsed: re-parse them)
        st = state.global_state()
        os.environ["HOROVOD_FUSION_THRESHOLD"] = "256"
        for depth in ("2", "1"):
            st.runtime.stop()
            st.runtime = None
            os.environ["HOROVOD_CYCLE_PIPELINE_DEPTH"] = depth
            st.config = env.Config.from_env()
            _collectives(hvd, inp, rank, size, out, f"depth{depth}_")
        del os.environ["HOROVOD_CYCLE_PIPELINE_DEPTH"]
        del os.environ["HOROVOD_FUSION_THRESHOLD"]
        st.runtime.stop()
        st.runtime = None
        st.config = env.Config.from_env()
        if bert:
            _bert(hvd, inp, rank, out)
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()


def run_world(rank: int, size: int, tmpdir: str, device: str) -> None:
    """One rank of a world on ``device`` ("cuda": one card a rank, NCCL
    data group): a grouped allreduce fused into one call, Average, the
    unfused ops (a ragged allgather and an alltoall among them), 3
    ``DistributedOptimizer`` steps of a small MLP on this rank's data, and
    ZeRO stages 1-3 (``_zero_stages``); raises on any disagreement."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.runtime import runtime

    hvd.init(device=None if device == "cuda" else device)
    try:
        dev = hvd.device()
        total = size * (size + 1) / 2
        xs = [torch.full((n,), rank + 1.0, device=dev)
              for n in (3, 1000, 70000)]
        before = runtime.COUNTS["allreduce"]
        outs = hvd.grouped_allreduce(xs, op=hvd.Sum, name="world.sum")
        assert runtime.COUNTS["allreduce"] - before == 1
        assert all(bool((o == total).all()) for o in outs)
        avg = hvd.allreduce(torch.full((5,), rank + 1.0, device=dev))
        assert bool((avg == total / size).all())
        got = hvd.allgather(torch.full((2, 3), float(rank), device=dev))
        want = torch.arange(size, device=dev).float().repeat_interleave(2)
        assert torch.equal(got[:, 0], want)
        rs = hvd.reducescatter(torch.ones(size * 2, device=dev), op=hvd.Sum)
        assert torch.equal(rs, torch.full((2,), float(size), device=dev))
        b = hvd.broadcast(torch.full((4,), float(rank), device=dev),
                          root_rank=size - 1)
        assert bool((b == size - 1).all())
        # a ragged allgather (rank r gives r + 1 rows; int64 past 2**40)
        # and an alltoall
        rows = torch.full((rank + 1, 2), 2 ** 40 + rank, device=dev)
        got = hvd.allgather(rows, name="world.ragged")
        want = torch.cat([torch.full((r + 1, 2), 2 ** 40 + r, device=dev)
                          for r in range(size)])
        assert torch.equal(got, want), got
        x = torch.arange(size * 2, device=dev).float()
        got = hvd.alltoall(x + 100 * rank, name="world.a2a")
        want = torch.cat([x[2 * rank:2 * rank + 2] + 100 * r
                          for r in range(size)])
        assert torch.equal(got, want), got

        torch.manual_seed(rank)  # other weights on each rank at first
        model = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                    torch.nn.ReLU(),
                                    torch.nn.Linear(64, 8)).to(dev)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1),
            named_parameters=model.named_parameters())
        x = torch.randn(16, 64, device=dev)  # this rank's batch
        for _ in range(3):
            opt.zero_grad()
            model(x).square().mean().backward()
            opt.step()
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        every = hvd.allgather(flat[None], name="world.params")
        assert all(torch.equal(every[0], every[r]) for r in range(size))
        _zero_stages(hvd, dev, x, size)
    finally:
        hvd.shutdown()


def _zero_stages(hvd, dev, x, size: int) -> None:
    """ZeRO stages 1, 2 and 3 on one layout (a reduce-scatter plan's
    buckets), 3 steps of ``sharded_adamw`` each from the same weights on
    this rank's data: each rank holds exactly 1/size of every padded group
    (gradient and parameter shards), and stages 2 and 3 end bit-equal to
    stage 1."""

    def mlp():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(64, 64), torch.nn.ReLU(),
                                   torch.nn.Linear(64, 8)).to(dev)

    models = [mlp() for _ in range(3)]
    params = [dict(m.named_parameters()) for m in models]
    plans = [hvd.GradReleasePlan(reduce_scatter=True, bucket_bytes=256,
                                 name=f"world.zero{stage}")
             for stage in (2, 3)]
    part = plans[0].zero_partition(params[1])
    assert plans[1].zero_partition(params[2]) == part and len(part) >= 3
    opt = hvd.sharded_adamw(1e-2, partition=part)
    s1, s2 = opt.init(params[0]), opt.init(params[1])
    sp = hvd.shard_params(params[2], partition=part)
    s3 = opt.init(sp)

    def one_1_over_size(spec, shards):
        assert len(shards) == len(spec.groups) == len(part)
        for g, s in zip(spec.groups, shards):
            assert g.padded == size * g.shard_elems
            assert s.numel() == g.shard_elems and s.device == dev

    one_1_over_size(sp.spec, sp.shards)
    leaves = list(params[2].values())
    for _ in range(3):
        models[0].zero_grad(set_to_none=True)
        models[0](x).square().mean().backward()
        _, s1 = opt.apply(params[0], s1,
                          {k: p.grad for k, p in params[0].items()})
        models[1].zero_grad(set_to_none=True)
        plans[0].tag(params[1])
        models[1](x).square().mean().backward()
        sg = plans[0].gather()
        one_1_over_size(sg.spec, sg.shards)
        _, s2 = opt.apply(params[1], s2, sg)
        with torch.no_grad():
            for _, bucket in hvd.iter_param_buckets(sp):
                for i, t in bucket.items():
                    leaves[i].copy_(t)
        models[2].zero_grad(set_to_none=True)
        plans[1].tag(params[2])
        models[2](x).square().mean().backward()
        sp, s3 = opt.apply(sp, s3, plans[1].gather())
        one_1_over_size(sp.spec, sp.shards)
    full = hvd.gather_params(sp)
    for k, p in params[0].items():
        assert torch.equal(params[1][k], p), f"stage 2 {k}"
        assert torch.equal(full[k], p), f"stage 3 {k}"
