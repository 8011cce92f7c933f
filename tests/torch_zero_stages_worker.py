"""One rank of the port's 2-rank gloo world for
tests/test_torch_zero_stages.py.

Started through ``torch.multiprocessing`` (spawn). Reads the shared inputs
from ``inputs.npz``, joins the world through a ``FileStore``, runs every
scenario in one world and writes what it got to ``rank<r>.npz``:

* stage 2: ``sharded_adamw`` applied to whole gradients and to the
  ``ShardedGrads`` of ``scatter_gradients`` (``scatter_*``);
* stage 3: ``shard_params`` then ``gather_params`` (``round_*``, and each
  group's shard length), and 4 steps of ``sharded_adamw`` over
  ``ShardedParams`` beside 4 steps over the whole parameters
  (``s1_<step>_*``, ``s3_<step>_*``);
* ``iter_param_buckets`` over one group a leaf with a window of 2: the
  leaves it yields (``bucket_*``) and the most allgathers in flight;
* ``sharded_update``: a small MLP 3 steps through the replicated
  ``DistributedOptimizer(SGD)`` and through ``shard_optimizer_states=
  True`` (``mlp_*``); 4 steps of momentum SGD and of AdamW over the uneven
  leaves with this rank's gradients, sharded (``sgdm_<step>_*``,
  ``adamw_<step>_*``) and replicated on allreduced gradients
  (``*_rep_<step>_*``); the inner optimizer's state bytes.
"""

import os

import numpy as np
import torch

LEAVES = ("a", "b", "c.w", "h")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().copy()


def _params(inp, dtype_h=torch.bfloat16) -> dict:
    params = {k: torch.from_numpy(inp[f"p_{k}"]).clone() for k in LEAVES}
    params["h"] = params["h"].to(dtype_h)
    return params


def _grads(inp, step: int, rank: int) -> dict:
    grads = {k: torch.from_numpy(inp[f"g{step}_{k}"][rank]).clone()
             for k in LEAVES}
    grads["h"] = grads["h"].to(torch.bfloat16)
    return grads


def run(rank: int, size: int, tmpdir: str) -> None:
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collectives

    torch.set_num_threads(1)
    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        out = {}
        opt = hvd.sharded_adamw(1e-2, weight_decay=1e-3)

        # stage 2: scatter, then apply, against apply on whole gradients
        full, pre = _params(inp), _params(inp)
        s_full, s_pre = opt.init(full), opt.init(pre)
        opt.apply(full, s_full, _grads(inp, 0, rank))
        sg = hvd.scatter_gradients(_grads(inp, 0, rank), spec=s_pre.spec)
        assert isinstance(sg, hvd.ShardedGrads)
        opt.apply(pre, s_pre, sg)
        for k in LEAVES:
            out[f"scatter_full_{k}"] = _np(full[k])
            out[f"scatter_pre_{k}"] = _np(pre[k])

        # stage 3: the round trip, and 4 steps against stage 1
        sp = hvd.shard_params(_params(inp))
        out["shard_elems"] = np.asarray(
            [[g.shard_elems, g.padded, s.numel()]
             for g, s in zip(sp.spec.groups, sp.shards)])
        back = hvd.gather_params(sp)
        for k in LEAVES:
            out[f"round_{k}"] = back[k].view(torch.int16).numpy().copy() \
                if k == "h" else back[k].numpy().copy()
        p1 = _params(inp)
        s1 = opt.init(p1)
        s3 = opt.init(sp)
        for step in range(4):
            grads = _grads(inp, step, rank)
            _, s1 = opt.apply(p1, s1, grads)
            sg = hvd.scatter_gradients(grads, spec=s3.spec)
            sp, s3 = opt.apply(sp, s3, sg)
            assert isinstance(sp, hvd.ShardedParams)
            got = hvd.gather_params(sp)
            for k in LEAVES:
                out[f"s1_{step}_{k}"] = _np(p1[k])
                out[f"s3_{step}_{k}"] = _np(got[k])

        # iter_param_buckets: one group a leaf, a window of 2
        sp = hvd.shard_params(_params(inp), partition=[[0], [1], [2], [3]])
        state = {"in_flight": 0, "most": 0}
        real_ag, real_sync = collectives.allgather_async, \
            collectives.synchronize

        def allgather_async(tensor, name=None):
            state["in_flight"] += 1
            state["most"] = max(state["most"], state["in_flight"])
            return real_ag(tensor, name=name)

        def synchronize(handle):
            state["in_flight"] -= 1
            return real_sync(handle)

        collectives.allgather_async = allgather_async
        collectives.synchronize = synchronize
        try:
            seen = []
            for gi, bucket in hvd.iter_param_buckets(sp, prefetch=2):
                for i, t in bucket.items():
                    seen.append(i)
                    out[f"bucket_{LEAVES[i]}"] = _np(t)
        finally:
            collectives.allgather_async = real_ag
            collectives.synchronize = real_sync
        out["bucket_seen"] = np.asarray(seen)
        out["bucket_most_in_flight"] = np.asarray(state["most"])

        # sharded_update: replicated SGD against sharded SGD on an MLP
        x = torch.from_numpy(inp["mlp_x"][rank])
        for label, sharded in (("rep", False), ("zero", True)):
            torch.manual_seed(0)
            model = torch.nn.Sequential(torch.nn.Linear(6, 8),
                                        torch.nn.Tanh(),
                                        torch.nn.Linear(8, 3))
            o = hvd.DistributedOptimizer(
                torch.optim.SGD(model.parameters(), lr=0.5),
                named_parameters=model.named_parameters(),
                shard_optimizer_states=sharded)
            for _ in range(3):
                o.zero_grad()
                model(x).square().mean().backward()
                o.step()
            for k, p in model.named_parameters():
                out[f"mlp_{label}_{k}"] = p.detach().numpy().copy()
        # momentum SGD and AdamW over the uneven f32 leaves
        for label, build in (
                ("sgdm", lambda ps: torch.optim.SGD(ps, lr=0.1,
                                                    momentum=0.9)),
                ("adamw", lambda ps: torch.optim.AdamW(
                    ps, lr=1e-2, weight_decay=1e-3))):
            params = {k: torch.nn.Parameter(v) for k, v in
                      _params(inp, torch.float32).items()}
            rep = {k: torch.nn.Parameter(v) for k, v in
                   _params(inp, torch.float32).items()}
            o = hvd.sharded_update(build(list(params.values())),
                                   named_parameters=params.items())
            o_rep = build(list(rep.values()))
            for step in range(4):
                grads = {k: g.float() for k, g in
                         _grads(inp, step, rank).items()}
                o.step(grads=grads)
                for k, p in rep.items():
                    p.grad = hvd.allreduce(grads[k], name=f"rep.{k}")
                o_rep.step()
                for k in LEAVES:
                    out[f"{label}_{step}_{k}"] = _np(params[k])
                    out[f"{label}_rep_{step}_{k}"] = _np(rep[k])
            out[f"{label}_state_bytes"] = np.asarray(sum(
                t.numel() * t.element_size()
                for st in o.state.inner.state.values() for t in st.values()
                if isinstance(t, torch.Tensor) and t.ndim))
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()
