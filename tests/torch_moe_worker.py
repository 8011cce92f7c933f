"""One rank of the port's expert-parallel worlds for tests/test_torch_moe.py.

``run(rank, size, tmpdir, device)`` joins a world through a ``FileStore``
(``device="cpu"``: gloo; ``"cuda"``: one card a rank, NCCL) and writes
``rank<r>.npz``. On the CPU it reads ``inputs.npz`` (written by the test
from numpy seeds) and drives:

* ``switch_moe`` on this rank's tokens and router logits with a ``tanh(h
  @ w)`` expert, at an ample capacity and at one short enough to drop
  tokens: the output, the router probabilities and the gradients of
  ``sum(y * dy)`` in the tokens, the logits and this rank's expert;
  ``load_balance_loss`` of the probabilities, averaged over the ranks and
  alone;
* the MoE LM (``MoeLM`` from the same ``RandomState`` as the JAX
  package's ``init_moe_lm``): logits and aux of this rank's tokens, then
  ``STEPS`` training steps with ``DistributedOptimizer(Adam)`` over the
  shared parameters and a plain Adam over this rank's experts, recording
  the first step's gradients and parameters after it, the losses, and the
  response-cache hits and collectives requested each step.

On the card (``device="cuda"``) it runs :func:`cards`: the routing of a
small MoE LM against a local recomputation from the allgathered tokens,
router logits and experts, then ``STEPS`` training steps; it raises on any
disagreement.
"""

import os

import numpy as np
import torch

STEPS = 3
LR = 3e-3
LM = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, d_ff=64,
          max_seq=16)
LM_BATCH = 2  # sequences a rank
DIM, TOKENS = 8, 16  # switch_moe's width and tokens a rank


def _expert_fn(p, h):
    return torch.tanh(h @ p)


def _switch(out, tag, x, logits, w, dy, capacity):
    from horovod_tpu_torch.parallel import ep

    x, logits, w = (t.clone().requires_grad_() for t in (x, logits, w))
    y, probs = ep.switch_moe(x, logits, _expert_fn, w, capacity,
                             name=f"sw.{tag}")
    (y * dy).sum().backward()
    out.update({f"sw.{tag}.y": y.detach().numpy(),
                f"sw.{tag}.probs": probs.detach().numpy(),
                f"sw.{tag}.dx": x.grad.numpy(),
                f"sw.{tag}.dlogits": logits.grad.numpy(),
                f"sw.{tag}.dw": w.grad.numpy()})
    return probs.detach()


def _split(model):
    """(name, tensor) of the shared parameters and of this rank's experts."""
    named = list(model.named_parameters())
    return ([(n, p) for n, p in named if n.startswith("shared.")],
            [(n, p) for n, p in named if n.startswith("experts.")])


def train_steps(model, tokens, capacity, steps, after_backward=None,
                after_update=None):
    """``steps`` MoE LM steps: ``DistributedOptimizer(Adam)`` over the
    shared parameters (averaged over the ranks), a plain Adam over this
    rank's experts (``MoeLM`` scales their gradients by 1/size). Returns
    the losses; ``after_backward(i)`` runs once step ``i``'s gradients are
    reduced, ``after_update(i)`` after its updates."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import moe

    shared, experts = _split(model)
    opt_s = hvd.DistributedOptimizer(
        torch.optim.Adam([p for _, p in shared], lr=LR),
        named_parameters=shared)
    opt_e = torch.optim.Adam([p for _, p in experts], lr=LR)
    losses = []
    for i in range(steps):
        opt_s.zero_grad()
        opt_e.zero_grad()
        loss = moe.moe_lm_loss(model, tokens, capacity)
        loss.backward()
        opt_s.synchronize()
        if after_backward is not None:
            after_backward(i)
        with opt_s.skip_synchronize():
            opt_s.step()
        opt_e.step()
        losses.append(loss.item())
        if after_update is not None:
            after_update(i)
    return losses


def run(rank: int, size: int, tmpdir: str, device: str = "cpu",
        scenario: str = "") -> None:
    """One rank; ``scenario`` "cards" (the default on ``device="cuda"``)
    runs :func:`cards`, which a CPU world rehearses."""
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_LOCAL_RANK=str(rank),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    if device == "cuda" or scenario == "cards":
        hvd.init(device=None if device == "cuda" else device)
        try:
            cards(rank, size)
        finally:
            hvd.shutdown()
        return
    from horovod_tpu_torch.models import moe
    from horovod_tpu_torch.ops import collectives
    from horovod_tpu_torch.parallel import ep
    from horovod_tpu_torch.runtime import runtime

    inp = np.load(os.path.join(tmpdir, "inputs.npz"))
    hvd.init(device="cpu")
    try:
        out = {}
        x = torch.from_numpy(inp["x"][rank])
        logits = torch.from_numpy(inp["logits"][rank])
        w = torch.from_numpy(inp["w"][rank])
        dy = torch.from_numpy(inp["dy"][rank])
        probs = _switch(out, "ample", x, logits, w, dy, TOKENS)
        _switch(out, "short", x, logits, w, dy, int(inp["short"]))
        out["lb"] = ep.load_balance_loss(probs, name="lb").numpy()
        out["lb_local"] = ep.load_balance_loss(probs).numpy()

        tokens = torch.from_numpy(inp["tokens"][rank])
        capacity = int(inp["capacity"])
        model = moe.MoeLM(**LM, device="cpu", seed=int(inp["seed"]))
        with torch.no_grad():
            lm_logits, aux = moe.apply_moe_lm(model, tokens, capacity)
        out.update({"lm.logits": lm_logits.numpy(), "lm.aux": aux.numpy()})
        names = [n for n, _ in model.named_parameters()]
        hits, requested = [], []
        marks = {"hits": runtime.COUNTS["cache_hits"]}

        def after_backward(i):
            if i == 0:
                out.update({f"lm.g.{n}": p.grad.numpy().copy()
                            for n, p in model.named_parameters()})
            hits.append(runtime.COUNTS["cache_hits"] - marks["hits"])
            requested.append(sum(collectives.COUNTS.values()))
            marks["hits"] = runtime.COUNTS["cache_hits"]
            collectives.reset_counts()

        def after_update(i):
            if i == 0:
                out.update({f"lm.p.{n}": p.detach().numpy().copy()
                            for n, p in model.named_parameters()})

        collectives.reset_counts()
        losses = train_steps(model, tokens, capacity, STEPS, after_backward,
                             after_update)
        out.update({"lm.losses": np.array(losses), "lm.hits": np.array(hits),
                    "lm.requested": np.array(requested),
                    "lm.names": np.array(names)})
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()


def start(tmpdir, size: int, device: str = "cpu",
          scenario: str = "") -> list:
    """Start the world's ranks in spawned processes."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run,
                         args=(r, size, str(tmpdir), device, scenario))
             for r in range(size)]
    for p in procs:
        p.start()
    return procs


def join(procs, tmpdir, timeout: int = 240) -> list:
    """Wait for the ranks; their outputs (none from a world of cards)."""
    for p in procs:
        p.join(timeout=timeout)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    files = [os.path.join(str(tmpdir), f"rank{r}.npz")
             for r in range(len(procs))]
    return [dict(np.load(f)) for f in files if os.path.exists(f)]


CARD_LM = dict(vocab_size=512, d_model=256, num_layers=2, num_heads=4,
               d_ff=512, max_seq=128)


def cards(rank: int, size: int) -> None:
    """One rank a card: the MoE LM's routing against a local
    recomputation, then ``STEPS`` training steps with finite losses."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import moe
    from horovod_tpu_torch.parallel import ep

    dev = hvd.device()
    model = moe.MoeLM(**CARD_LM, device=dev, seed=0)
    rng = np.random.RandomState(100 + rank)
    tokens = torch.from_numpy(rng.randint(
        0, CARD_LM["vocab_size"], (2, CARD_LM["max_seq"]))).to(dev)
    n_tok = tokens.numel()
    capacity = n_tok  # ample: every token kept
    seen = []
    real = ep.switch_moe

    def recorded(x, gate_logits, expert_fn, params, cap, *, name):
        y, probs = real(x, gate_logits, expert_fn, params, cap, name=name)
        seen.append((x.detach(), gate_logits.detach(), y.detach()))
        return y, probs

    ep.switch_moe = recorded
    try:
        with torch.no_grad():
            logits, aux = moe.apply_moe_lm(model, tokens, capacity)
    finally:
        ep.switch_moe = real
    assert torch.isfinite(logits).all() and torch.isfinite(aux)
    worst = 0.0
    for layer, (x, gl, y) in enumerate(seen):
        xs = hvd.allgather(x, name=f"check.{layer}.x")
        gls = hvd.allgather(gl, name=f"check.{layer}.gate")
        xp = model.experts.layers[layer]
        wi = hvd.allgather(xp.wi.detach()[None], name=f"check.{layer}.wi")
        wo = hvd.allgather(xp.wo.detach()[None], name=f"check.{layer}.wo")
        probs = torch.softmax(gls.float(), -1)
        idx = probs.argmax(-1)
        gate = probs.gather(-1, idx[:, None])
        ref = torch.zeros_like(xs)
        for e in range(size):  # each token through its argmax expert
            sel = idx == e
            h = torch.nn.functional.gelu(xs[sel] @ wi[e], approximate="tanh")
            ref[sel] = gate[sel] * (h @ wo[e])
        mine = ref[rank * n_tok:(rank + 1) * n_tok]
        err = ((y - mine).norm() / mine.norm()).item()
        worst = max(worst, err)
        assert err <= 2e-2, (layer, err)
        # every expert served some rank's tokens
        assert len(set(idx.tolist())) > 1
    losses = train_steps(model, tokens, capacity, STEPS)
    assert all(np.isfinite(losses)), losses
    print(f"rank {rank}: routing within {worst:.2e} of the local "
          f"recomputation; losses {losses}", flush=True)
