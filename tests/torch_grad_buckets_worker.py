"""One rank of the port's 2-rank gloo world for
tests/test_torch_grad_buckets.py.

Started through ``torch.multiprocessing`` (spawn); joins the world through
a ``FileStore``, runs every scenario and writes what it got to
``rank<r>.npz``:

* the allreduce release against ``allreduce_gradients`` on the same
  gradients, float32 and bfloat16, average and sum, as raw bytes
  (``ar_<case>_<leaf>_{plan,plain}``);
* the reduce-scatter release against ``scatter_gradients`` with the plan's
  partition (``rs_<group>_{plan,plain}``), each group's shard and padded
  lengths, and whether any ``.grad`` outlived the backward;
* ``make_train_step`` over 3 steps of a small MLP on this rank's data
  with and without a plan: ``DistributedOptimizer(AdamW)`` with an
  allreduce plan (``step_ar_*``), ``sharded_adamw`` with a reduce-scatter
  plan and a partition-aligned layout (``step_rs_*``), each beside the
  same optimizer without a plan (``*_none_*``);
* the collectives requested and the response-cache hits a step under a
  plan beside a ``DistributedOptimizer`` (``counts``).
"""

import os

import numpy as np
import torch


def _model(seed: int = 0) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 3))


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.uint8).numpy().copy()


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.runtime import runtime
    from horovod_tpu_torch.training import make_train_step

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    try:
        out = {}
        # the allreduce release against the plain allreduce
        for dt in (torch.float32, torch.bfloat16):
            for average in (True, False):
                case = f"{str(dt)[6:]}_{'avg' if average else 'sum'}"
                trees = []
                for _ in range(2):
                    trees.append({
                        "w": torch.nn.Parameter(
                            (torch.linspace(-2, 2, 256) * (rank + 1)).to(dt)),
                        "b": torch.nn.Parameter(
                            (torch.linspace(0.5, 1.5, 64) + rank).to(dt))})
                plan = hvd.GradReleasePlan(bucket_bytes=256, average=average,
                                           name=case)
                plan.tag(trees[0])
                sum(p.float().square().sum() for p in trees[0].values()
                    ).backward()
                got = plan.gather()
                sum(p.float().square().sum() for p in trees[1].values()
                    ).backward()
                want = hvd.allreduce_gradients(
                    {k: p.grad for k, p in trees[1].items()},
                    average=average)
                for k in ("w", "b"):
                    out[f"ar_{case}_{k}_plan"] = _bytes(got[k])
                    out[f"ar_{case}_{k}_plain"] = _bytes(want[k])

        # the reduce-scatter release against scatter_gradients
        models = [_model(), _model()]
        x = torch.randn(8, 6, generator=torch.Generator().manual_seed(rank))
        plan = hvd.GradReleasePlan(reduce_scatter=True, bucket_bytes=256,
                                   name="rs")
        params = dict(models[0].named_parameters())
        part = plan.zero_partition(params)
        plan.tag(params)
        models[0](x).square().mean().backward()
        sg = plan.gather()
        out["rs_grads_left"] = np.asarray(
            sum(p.grad is not None for p in params.values()))
        models[1](x).square().mean().backward()
        want = hvd.scatter_gradients(
            {k: p.grad for k, p in models[1].named_parameters()},
            partition=part)
        assert sg.spec == want.spec
        for gi, (a, b) in enumerate(zip(sg.shards, want.shards)):
            out[f"rs_{gi}_plan"] = _bytes(a)
            out[f"rs_{gi}_plain"] = _bytes(b)
        out["rs_lengths"] = np.asarray(
            [[g.shard_elems, g.padded, s.numel()]
             for g, s in zip(sg.spec.groups, sg.shards)])
        out["rs_part"] = np.asarray([len(c) for c in part])

        # make_train_step with and without a plan
        y = torch.randint(0, 3, (8,),
                          generator=torch.Generator().manual_seed(rank))
        for label in ("ar", "rs"):
            for planned in (False, True):
                model = _model()
                params = dict(model.named_parameters())
                if label == "ar":
                    opt = hvd.DistributedOptimizer(
                        torch.optim.AdamW(model.parameters(), lr=1e-2),
                        named_parameters=model.named_parameters())
                    plan = (hvd.GradReleasePlan(bucket_bytes=512,
                                                name="step_ar")
                            if planned else False)
                else:
                    plan = (hvd.GradReleasePlan(reduce_scatter=True,
                                                bucket_bytes=256,
                                                name="step_rs")
                            if planned else False)
                    opt = hvd.sharded_adamw(
                        1e-2, partition=plan.zero_partition(params)
                        if planned else None)
                step = make_train_step(model, opt, grad_release=plan)
                collectives.reset_counts()
                hits = []
                for _ in range(3):
                    before = runtime.COUNTS["cache_hits"]
                    step(x, y)
                    hits.append(runtime.COUNTS["cache_hits"] - before)
                tag = f"step_{label}_{'plan' if planned else 'none'}"
                for k, p in params.items():
                    out[f"{tag}_{k}"] = _bytes(p)
                out[f"{tag}_counts"] = np.asarray(
                    [collectives.COUNTS[k] for k in
                     ("allreduce", "reducescatter", "allgather")])
                out[f"{tag}_hits"] = np.asarray(hits)
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
