"""One rank of the port's two-level collectives' worlds, for
tests/test_torch_hierarchy.py (4 gloo ranks) and
tests/test_torch_hierarchy_multiprocess.py (the chaos case; one rank a
card in the four-card test).

    python tests/torch_hierarchy_worker.py <mode> <tmpdir> [cuda]

The launcher's contract comes from the environment (``HOROVOD_RANK``,
``HOROVOD_SIZE``, ``HOROVOD_COORDINATOR_ADDR``, the knobs under test).
Modes:

* ``parity``: the same payloads through the flat and the two-level
  collectives (``HOROVOD_HIERARCHY_GROUP_SIZE`` 2, contiguous slices, then
  group size 0 over host names that put ranks {0, 2} and {1, 3} together):
  fused allreduces of int64 and float32 by Sum, Average, Min and Max (a
  bin whose length is odd), named async enqueues fused in one cycle,
  reduce-scatter and allgather (equal and ragged), and the float payload
  under ``fp16`` and ``ieee_fp16`` compression. Saves every result to
  ``parity-r<rank>.pt`` with the comms ledger's lanes, the hierarchy's
  group counts and ``hierarchy_plan`` events, and the digests run.
* ``autotune``: int64 allreduces until the tuner freezes; saves each
  ``autotune_commit`` event, the swept knobs, the start's probe
  (``HOROVOD_AUTOTUNE_PROBE``) and the comms rooflines to
  ``autotune-r<rank>.pt``.
* ``chaos``: ``w`` grows by the average of ones under ``@hvd.elastic.run``
  with a commit a step (``HOROVOD_FAULT_INJECT`` kills a rank); prints
  ``DONE`` with the step, ``w``, the generation, whether a hierarchy is
  on, the chaos delays fired and the groups built and destroyed.
* ``bert`` (the cards): BERT-Large at full width, 5 steps on the hooks
  path and on P2 (ZeRO-1, ``sharded_adamw``), each flat, two-level and
  two-level under ``fp16``; saves the losses, the median step ms of the
  last three steps and the comms ledger to ``bert-r<rank>.pt``.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)

WORLD_SIZES = (7, 1000, 34)  # one bin of 1041 elements: odd, so padded
OPS = ("sum", "average", "min", "max")


def _payloads(rank: int) -> dict:
    rng = np.random.RandomState(100 + rank)
    return {
        "int": [rng.randint(-2 ** 40, 2 ** 40, n).astype(np.int64)
                for n in WORLD_SIZES],
        # small integers in float32: every partial sum is exact
        "exact": [rng.randint(-1000, 1000, n).astype(np.float32)
                  for n in WORLD_SIZES],
        "float": [rng.randn(n).astype(np.float32) for n in WORLD_SIZES],
        "rs": rng.randint(-2 ** 40, 2 ** 40, (8, 3)).astype(np.int64),
        "rs_float": rng.randn(8, 3).astype(np.float32),
        "ag": np.full((3, 2), 2 ** 40 + rank, np.int64),
        "ragged": np.full((rank + 1, 2), 7 * rank, np.int64),
    }


def _collectives(hvd, dev, rank: int, tag: str, out: dict) -> None:
    ops = dict(sum=hvd.Sum, average=hvd.Average, min=hvd.Min, max=hvd.Max)
    p = _payloads(rank)
    for kind in ("int", "exact", "float"):
        xs = [torch.from_numpy(a).to(dev) for a in p[kind]]
        for op in OPS:
            got = hvd.grouped_allreduce([x.clone() for x in xs],
                                        op=ops[op], name=f"{tag}{kind}.{op}")
            out[f"{tag}ar_{kind}_{op}"] = [g.cpu().numpy() for g in got]
    # named async enqueues, fused by the cycle that negotiates them
    handles = [hvd.allreduce_async(torch.from_numpy(a).to(dev), op=hvd.Sum,
                                   name=f"{tag}async.{i}")
               for i, a in enumerate(p["int"])]
    out[f"{tag}async"] = [hvd.synchronize(h).cpu().numpy() for h in handles]
    for key, op in (("rs", "sum"), ("rs", "average"), ("rs_float", "sum")):
        got = hvd.reducescatter(torch.from_numpy(p[key]).to(dev),
                                op=ops[op], name=f"{tag}{key}.{op}")
        out[f"{tag}{key}_{op}"] = got.cpu().numpy()
    for key in ("ag", "ragged"):
        out[f"{tag}{key}"] = hvd.allgather(
            torch.from_numpy(p[key]).to(dev), name=f"{tag}{key}").cpu() \
            .numpy()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _set(cfg, **knobs) -> None:
    for k, v in knobs.items():
        setattr(cfg, k, v)


def parity(hvd, dev, rank: int, tmp: str) -> None:
    from horovod_tpu_torch import comms, flight_recorder
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.runtime import hierarchy

    cfg = state.global_state().config
    out = {}
    _set(cfg, hierarchical_allreduce=False, hierarchical_allgather=False)
    _collectives(hvd, dev, rank, "flat.", out)
    _set(cfg, hierarchical_allreduce=True, hierarchical_allgather=True,
         hierarchy_group_size=2)
    _collectives(hvd, dev, rank, "hier.", out)
    # host-derived grouping: ranks {0, 2} and {1, 3} share a host
    os.environ["HOROVOD_HOSTNAME"] = f"host{rank % 2}"
    _set(cfg, hierarchy_group_size=0)
    _collectives(hvd, dev, rank, "hosts.", out)
    rt = state.global_state().runtime
    out["hosts_plan"] = rt.executor._hier.plan.layout
    _set(cfg, hierarchy_group_size=2)
    for codec in ("fp16", "ieee_fp16"):
        _set(cfg, hierarchy_compression=codec)
        xs = [torch.from_numpy(a).to(dev)
              for a in _payloads(rank)["float"]]
        got = hvd.grouped_allreduce(xs, op=hvd.Sum, name=f"{codec}.float")
        out[f"{codec}_float"] = [g.cpu().numpy() for g in got]
        got = hvd.reducescatter(
            torch.from_numpy(_payloads(rank)["rs_float"]).to(dev),
            op=hvd.Sum, name=f"{codec}.rs")
        out[f"{codec}_rs"] = got.cpu().numpy()
    _sync(dev)
    out["digests"] = rt.executor.digest_checks
    hvd.shutdown()  # the lanes' device times are read as the runtime stops
    comms.tracker().sweep()
    out["lanes"] = {k: v for k, v in comms.tracker().ledger()["lanes"]
                    .items()}
    out["stats"] = dict(hierarchy.STATS)
    out["plans"] = [e for e in flight_recorder.recorder()._events
                    if e["kind"] == "hierarchy_plan"]
    torch.save(out, os.path.join(tmp, f"parity-r{rank}.pt"))


def autotune(hvd, dev, rank: int, tmp: str) -> None:
    from horovod_tpu_torch import flight_recorder
    from horovod_tpu_torch.core import state

    want = sum(np.arange(4, dtype=np.int64) + 2 ** 40)
    rt = None
    for i in range(400):
        x = torch.full((1000 + i % 7,), 2 ** 40 + rank, dtype=torch.int64,
                       device=dev)
        got = hvd.allreduce(x, op=hvd.Sum, name=f"tune.{i % 3}")
        assert bool((got == int(want)).all()), got
        rt = state.global_state().runtime
        # the freeze lands after the cycle's results, so a rank may see it
        # one allreduce before another: leave together, once every rank
        # has seen it
        frozen = torch.tensor([0 if rt._autotune_active else 1], device=dev)
        if int(hvd.allreduce(frozen, op=hvd.Min, name="tune.frozen")):
            break
    from horovod_tpu_torch import comms

    pm = rt.param_manager
    events = [{k: v for k, v in e.items() if k != "t"}
              for e in flight_recorder.recorder()._events
              if e["kind"] == "autotune_commit"]
    torch.save({"events": events, "frozen": not rt._autotune_active,
                "swept": pm.swept_knobs if pm is not None else None,
                "iterations": i + 1, "probe": rt.probe,
                "rooflines": dict(comms.tracker()._roofline)},
               os.path.join(tmp, f"autotune-r{rank}.pt"))
    hvd.shutdown()


def chaos(hvd, dev, rank: int, tmp: str) -> None:
    from horovod_tpu_torch.core import state as state_mod
    from horovod_tpu_torch.runtime import hierarchy
    from horovod_tpu_torch.utils import resilience

    total = int(os.environ.get("CHAOS_TOTAL_STEPS", "5"))
    state = hvd.elastic.ArrayState(
        params={"w": torch.zeros(4, device=dev)}, optimizer=None, step=0)

    @hvd.elastic.run
    def train(state):
        while state.step < total:
            g = hvd.allreduce(torch.ones(4, device=dev), average=True,
                              name="chaos_grad")
            state.params["w"] += g
            state.step += 1
            state.commit()
        return state

    train(state)
    rt = state_mod.global_state().runtime
    injected = resilience._CHAOS_INJECTED.labels(kind="netdelay").value
    print(f"DONE rank={hvd.rank()} size={hvd.size()} step={state.step} "
          f"w={float(state.params['w'][0].cpu()):g} "
          f"generation={hvd.elastic.restarts()} "
          f"hier_enabled={rt.executor._hier is not None} "
          f"injected={injected:g} built={hierarchy.STATS['built']} "
          f"destroyed={hierarchy.STATS['destroyed']}", flush=True)
    hvd.shutdown()


def bert(hvd, dev, rank: int, tmp: str) -> None:
    from horovod_tpu_torch import comms
    from horovod_tpu_torch.core import state as state_mod
    from horovod_tpu_torch.models.transformer import (BertLarge,
                                                      masked_lm_loss_gathered)

    steps, batch, seq, n_pred = 5, 8, 512, 76
    # BERT_TINY=1: a 2-layer stand-in, to rehearse the mode on the CPU
    widths = (dict(vocab_size=512, max_seq=64, num_layers=2, d_model=64,
                   num_heads=2, d_ff=128)
              if os.environ.get("BERT_TINY") == "1"
              else dict(vocab_size=30522, max_seq=512))
    if "num_layers" in widths:
        batch, seq, n_pred = 2, 64, 8
    rng = np.random.RandomState(rank)
    toks = torch.from_numpy(rng.randint(0, widths["vocab_size"],
                                        (batch, seq))).to(dev)
    pos = torch.from_numpy(np.stack([rng.choice(seq, n_pred, replace=False)
                                     for _ in range(batch)])).to(dev)
    lab = torch.gather(toks, 1, pos)
    out = {}
    cfg = state_mod.global_state().config
    runs = (("flat", False, "none"), ("hier", True, "none"),
            ("fp16", True, "fp16"))
    for path in ("hooks", "zero"):
        for label, hier, codec in runs:
            _set(cfg, hierarchical_allreduce=hier,
                 hierarchical_allgather=hier, hierarchy_group_size=2,
                 hierarchy_compression=codec)
            model = BertLarge(**widths, device=dev, seed=0)
            params = dict(model.named_parameters())
            if path == "hooks":
                opt = hvd.DistributedOptimizer(
                    torch.optim.AdamW(model.parameters(), lr=1e-4,
                                      weight_decay=1e-4),
                    named_parameters=model.named_parameters())
                zero_grad, update = opt.zero_grad, opt.step
            else:
                tx = hvd.sharded_adamw(1e-4)
                box = [tx.init(params)]
                zero_grad = lambda: model.zero_grad(set_to_none=True)  # noqa

                def update():
                    grads = {k: v.grad for k, v in params.items()}
                    _, box[0] = tx.apply(params, box[0], grads)
            losses, times = [], []
            for _ in range(steps):
                _sync(dev)
                t0 = time.perf_counter()
                zero_grad()
                loss = masked_lm_loss_gathered(
                    model(toks, output="hidden"), model.token_embed, pos,
                    lab)
                loss.backward()
                update()
                losses.append(float(loss))  # waits for the step's kernels
                times.append(time.perf_counter() - t0)
            out[f"{path}.{label}"] = losses
            out[f"{path}.{label}.ms"] = 1e3 * float(np.median(times[2:]))
            del model, params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    _sync(dev)
    hvd.shutdown()
    out["lanes"] = comms.tracker().ledger()["lanes"]
    out["keys"] = [k for k in comms.tracker().ledger()["keys"]
                   if k.get("lane", "").startswith("hier")]
    torch.save(out, os.path.join(tmp, f"bert-r{rank}.pt"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(mode, tmp, env=None, world=4, timeout=240, cuda=False,
              script=WORKER):
    """``world`` workers of ``script``'s ``mode`` (this file's by default);
    returns their outputs (each must exit 0)."""
    base = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in list(base):
        if k.startswith("HOROVOD_"):
            base.pop(k)
    base.update({"HOROVOD_SIZE": str(world),
                 "HOROVOD_COORDINATOR_ADDR": f"127.0.0.1:{_free_port()}",
                 "HOROVOD_GLOO_TIMEOUT_SECONDS": "20"})
    base.update(env or {})
    procs = [subprocess.Popen(
        [sys.executable, script, mode, str(tmp)] + (["cuda"] if cuda else []),
        env=dict(base, HOROVOD_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = [""] * world
    try:
        for r, p in enumerate(procs):
            outs[r] = p.communicate(timeout=timeout)[0]
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                outs[r] = p.communicate()[0]
    for r, p in enumerate(procs):
        assert p.returncode == 0, (r, outs[r][-4000:])
    return outs


def main() -> int:
    mode, tmp = sys.argv[1], sys.argv[2]
    cuda = len(sys.argv) > 3 and sys.argv[3] == "cuda"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import fault_inject

    launch = fault_inject.initial_rank()
    hvd.init(device=torch.device("cuda", launch) if cuda else "cpu")
    dev = hvd.device()
    dict(parity=parity, autotune=autotune, chaos=chaos, bert=bert)[mode](
        hvd, dev, hvd.rank(), tmp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
