"""One rank of the port's elastic gloo worlds for
tests/test_torch_elastic_multiprocess.py (and, given ``cuda``, of its
four-card test).

    python tests/torch_elastic_worker.py <mode> <tmpdir> [cuda]

The launcher's contract comes from the environment: ``HOROVOD_RANK``,
``HOROVOD_SIZE``, ``HOROVOD_COORDINATOR_ADDR`` (the first world's TCP
store), ``HOROVOD_RENDEZVOUS_HTTP_ADDR``/``_PORT`` (the store the test
process hosts), ``HOROVOD_ELASTIC=1`` and the fault under test in
``HOROVOD_FAULT_INJECT``. Modes, each ``ELASTIC_TOTAL_STEPS`` (8) steps
under ``@hvd.elastic.run`` with a commit a step:

* ``dp``: ``w`` (4 floats) grows by the average over the ranks of a
  gradient that depends on the rank and the step; with ones-like
  gradients ``w == step`` whatever the world size (``DP_ONES=1``). Prints
  the exception classes the training function saw and ``w``'s bytes.
* ``zero``: ZeRO-1 ``sharded_adamw`` over three leaves (two f32, one
  bf16) whose gradients are the same on every rank, beside the three
  other ZeRO kinds held as they were made: a ``sharded_update`` AdamW
  state after one step (``gen``), stage-3 parameter shards (``sp``) and
  stage-2 gradient shards (``sg``). After every commit each rank saves
  its shard exports (``own-r<launch rank>-s<step>.pt``); when the
  function is entered again after a re-form, the re-sharded states'
  exports and layouts and the synced parameters
  (``resynced-r<launch rank>.pt``).
* ``transformer`` (with ``cuda``: one rank a card, NCCL data group): a
  small causal transformer on ZeRO-1 ``sharded_adamw``, the same saves as
  ``zero``.

Prints ``DONE rank=... size=... step=... generation=... restarts=...
replays=... replica_restores=... seen=...`` at the end.
"""

import os
import sys

import torch

TOTAL = int(os.environ.get("ELASTIC_TOTAL_STEPS", "8"))
LEAVES = {"a": ((5, 3), torch.float32), "b": ((7,), torch.float32),
          "h": ((6,), torch.bfloat16)}


def zero_params(device) -> dict:
    out = {}
    for i, (k, (shape, dt)) in enumerate(sorted(LEAVES.items())):
        n = torch.Size(shape).numel()
        out[k] = (torch.arange(n, dtype=torch.float32) * 0.25 + i - 1.5) \
            .reshape(shape).to(device=device, dtype=dt)
    return out


def zero_grads(params: dict, step: int) -> dict:
    """The same on every rank: the average is the world-size-free update."""
    return {k: (torch.sin(torch.arange(v.numel(), dtype=torch.float32)
                          + step) * 0.5).reshape(v.shape).to(v)
            for k, v in params.items()}


def main() -> int:
    mode, tmp = sys.argv[1], sys.argv[2]
    cuda = len(sys.argv) > 3 and sys.argv[3] == "cuda"
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ckpt import stats
    from horovod_tpu_torch.elastic import fault_inject
    from horovod_tpu_torch.integrity import rollback
    from horovod_tpu_torch.parallel import zero

    launch = fault_inject.initial_rank()
    if cuda:
        hvd.init(device=torch.device("cuda", launch))
    else:
        hvd.init(device="cpu")
    dev = hvd.device()
    seen = []

    if mode == "dp":
        ones = os.environ.get("DP_ONES") == "1"
        state = hvd.elastic.ArrayState(
            params={"w": torch.zeros(4, device=dev)}, optimizer=None, step=0)

        def step_fn(state):
            grad = (torch.ones(4, device=dev) if ones else
                    torch.full((4,), 0.5 * (launch + 1) + 0.25 * state.step,
                               device=dev)
                    + torch.arange(4, dtype=torch.float32, device=dev) / 7)
            g = hvd.allreduce(grad, average=True, name="elastic_grad")
            state.params["w"] += g
    else:
        if mode == "zero":
            params = zero_params(dev)
            model = None
        else:
            from horovod_tpu_torch.models.transformer import Transformer

            # head dim 64 and bf16 compute: the flash kernels' shapes
            model = Transformer(vocab_size=128, d_model=128, num_layers=2,
                                num_heads=2, d_ff=256, max_seq=64,
                                causal=True, dtype=torch.bfloat16,
                                device=dev, seed=0)
            params = dict(model.named_parameters())
        tx = hvd.sharded_adamw(1e-2, weight_decay=1e-3)
        kinds = {}
        if model is None:
            gp = zero_params(dev)
            gopt = hvd.sharded_update(
                torch.optim.AdamW(list(gp.values()), lr=1e-2),
                named_parameters=list(gp.items()))
            _, kinds["gen"] = gopt.update(zero_grads(gp, 0), gopt.init(gp),
                                          gp)
            kinds["sp"] = hvd.shard_params(zero_params(dev))
            kinds["sg"] = hvd.scatter_gradients(
                zero_grads(zero_params(dev), 1))
        state = hvd.elastic.ArrayState(
            params=model if model is not None else params,
            optimizer=tx.init(params), step=0, **kinds)
        tokens = (torch.arange(2 * 64, device=dev).reshape(2, 64) * 7) % 128

        def step_fn(state):
            p = (dict(model.named_parameters()) if model is not None
                 else state.params)
            if model is None:
                grads = zero_grads(p, state.step)
            else:
                from horovod_tpu_torch.models.transformer import \
                    causal_lm_loss

                model.zero_grad(set_to_none=True)
                causal_lm_loss(model(tokens), tokens).backward()
                grads = {k: v.grad for k, v in p.items()}
            _, state.optimizer = tx.apply(p, state.optimizer, grads)

    def save(state, name):
        view = hvd.elastic.state._view(state.params)
        names = [n for n in ("optimizer", "gen", "sp", "sg")
                 if hasattr(state, n)]
        torch.save({"export": zero.export_shard_arrays(state.optimizer),
                    "layout": zero.layout_of(state.optimizer),
                    "kinds": {n: (zero.export_shard_arrays(getattr(state, n)),
                                  zero.layout_of(getattr(state, n)))
                              for n in names},
                    "step": state.step,
                    "params": {k: v.detach().cpu().clone()
                               for k, v in view.items()}},
                   os.path.join(tmp, name))

    entered = []

    @hvd.elastic.run
    def train(state):
        entered.append(hvd.elastic.restarts())
        if mode != "dp" and hvd.elastic.restarts() > 0 and \
                not os.path.exists(os.path.join(tmp, f"resynced-r{launch}.pt")):
            save(state, f"resynced-r{launch}.pt")
        try:
            while state.step < TOTAL:
                step_fn(state)
                state.step += 1
                state.commit()
                if mode != "dp":
                    save(state, f"own-r{launch}-s{state.step}.pt")
        except Exception as exc:
            seen.append(type(exc).__name__ + ":" + ",".join(
                str(r) for r in getattr(exc, "ranks", None)
                or ([getattr(exc, "suspect_rank")]
                    if getattr(exc, "suspect_rank", None) is not None
                    else [])))
            raise
        return state

    train(state)
    extra = ""
    if mode == "dp":
        w = state.params["w"].cpu()
        extra = (f" w={float(w[0]):g} "
                 f"w_hex={w.numpy().tobytes().hex()}")
    else:
        extra = f" shard_world={state.optimizer.spec.world}"
    print(f"DONE rank={hvd.rank()} size={hvd.size()} step={state.step} "
          f"generation={hvd.elastic.restarts()} "
          f"restarts={hvd.elastic.runner._RESTARTS_TOTAL.value:g} "
          f"replays={rollback.replays()} "
          f"replica_restores={stats.REPLICA_RESTORES.value:g} "
          f"entered={entered} seen={'|'.join(seen) or '-'}{extra}",
          flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
