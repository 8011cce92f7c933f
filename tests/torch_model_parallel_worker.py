"""One rank of the port's model-parallel worlds, for
tests/test_torch_sequence_parallel.py, test_torch_tp.py (with the axes'
groups and the lane guard), test_torch_pp.py (gloo, on the CPU) and
test_torch_model_parallel_multiprocess.py (one rank a card).

``start(tmpdir, size, mode, env)`` spawns the ranks, ``join`` waits and
returns each rank's ``rank<r>.npz``. The CPU modes (``mode`` may chain
several, comma-separated, in one world) read ``inputs.npz``
(written by the test from numpy seeds) and write what the test holds
against the JAX package:

* ``seq``: ring attention causal and not (``o`` and the gradients of
  ``sum(o * do)``), Ulysses the same, Ulysses' indivisible-heads error, and
  when the inputs hold its tokens and weights, a 2-layer causal
  ``Transformer`` with ``attention_fn`` set to each strategy and
  ``pos_offset`` set to the shard's position: its logits, its shard's
  causal LM loss and the gradients of the ranks' summed losses;
* ``tp`` (4 ranks, ``HOROVOD_LOCAL_SIZE=2``): two SGD steps of
  ``tp_train_step`` over ``local`` x ``cross``, unfused and with a fused
  ``qkv`` (replicated by the rules); the losses, the plan's dims and this
  rank's shards after the steps;
* ``pp``: ``pipeline_apply`` with ``last_stage_value``, forward and
  gradients, then Adam steps; one stage a rank;
* ``groups`` (4 ranks, the autotuner sweeping the two-level hierarchy):
  the ``local`` and ``cross`` groups made from this thread while the
  runtime's thread builds its own (an allreduce in flight), ring steps on
  both axes once it is done, until the tuner freezes; then the lane
  guard's clear and raise cases, and the model-parallel entry points
  refusing to start with a named collective in flight.

On the cards (``device="cuda"``, one rank a card, NCCL) :func:`cards`
runs ring and Ulysses on GPT-2-small (the gradients averaged after the
backward, with no runtime collective in flight beside the attention's),
Megatron TP x DP on BERT-Large and the GPipe pipeline on GPT-2-small's
layers at full width against each card's own unsharded run; mode
``rehearse`` runs it at toy widths on gloo.
"""

import os
import sys
import time

import numpy as np
import torch

B, H, D = 2, 6, 32
S_LOCAL = 32
LM = dict(vocab_size=64, d_model=48, num_layers=2, num_heads=6, d_ff=96)
TP_LM = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, d_ff=64,
             max_seq=16)
PP_DIM, PP_MICRO, PP_MB, PP_STEPS, PP_LR = 8, 6, 2, 150, 3e-3
TP_STEPS, TP_LR = 2, 0.1


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _attention(out, tag, fn, q, k, v, do):
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    o = fn(q, k, v)
    (o * do).sum().backward()
    out.update({f"{tag}.o": _np(o), f"{tag}.dq": _np(q.grad),
                f"{tag}.dk": _np(k.grad), f"{tag}.dv": _np(v.grad)})


def seq(hvd, rank, size, inp, out):
    import torch.distributed as dist

    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)

    sh = slice(rank * S_LOCAL, (rank + 1) * S_LOCAL)
    q, k, v, do = (torch.from_numpy(inp[n][:, :, sh]).contiguous()
                   for n in ("q", "k", "v", "do"))
    for causal in (True, False):
        c = "c" if causal else "n"
        _attention(out, f"ring.{c}", lambda q, k, v, causal=causal:
                   hvd.ring_attention(q, k, v, None, causal), q, k, v, do)
        _attention(out, f"uly.{c}", lambda q, k, v, causal=causal:
                   hvd.ulysses_attention(q, k, v, causal=causal),
                   q, k, v, do)
    bad = q[:, :size + 1]
    try:
        hvd.ulysses_attention(bad, bad, bad)
    except ValueError as exc:
        out["uly.err"] = np.array(str(exc))
    if "tokens" not in inp:
        return
    tokens = torch.from_numpy(inp["tokens"][:, sh]).long()
    sd = {k[3:]: torch.from_numpy(v) for k, v in inp.items()
          if k.startswith("sd.")}
    for name, fn in (("ring", hvd.ring_attention),
                     ("uly", hvd.ulysses_attention)):
        model = Transformer(**LM, max_seq=S_LOCAL * size, causal=True,
                            dtype=torch.float32, device="cpu",
                            attention_fn=fn)
        model.load_state_dict(sd)
        logits = model(tokens, pos_offset=rank * S_LOCAL)
        loss = causal_lm_loss(logits, tokens)
        loss.backward()
        out[f"lm.{name}.logits"] = _np(logits)
        out[f"lm.{name}.loss"] = _np(loss)
        for n, p in model.named_parameters():
            g = p.grad.clone()
            dist.all_reduce(g)  # the ranks' summed losses
            out[f"lm.{name}.g.{n}"] = _np(g)


def tp(hvd, rank, size, inp, out):
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss,
                                                      fuse_qkv_state)
    from horovod_tpu_torch.parallel import tp as tp_mod

    tokens = torch.from_numpy(inp["tokens"]).long()
    rows = tokens.shape[0] // hvd.cross_size()
    mine = tokens[hvd.cross_rank() * rows:(hvd.cross_rank() + 1) * rows]
    sd = {k[3:]: torch.from_numpy(v) for k, v in inp.items()
          if k.startswith("sd.")}
    for tag, fused in (("tp", False), ("fused", True)):
        model = Transformer(**TP_LM, causal=True, dtype=torch.float32,
                            device="cpu", fused_qkv=fused,
                            attention_fn=hvd.xla_attention)
        opt = torch.optim.SGD(model.parameters(), lr=TP_LR, momentum=0.9)
        params = fuse_qkv_state(sd) if fused else sd
        placed, step, batch_group = hvd.tp_train_step(
            model, opt, params, hvd.transformer_tp_rules("local"),
            loss_fn=lambda lg, t: causal_lm_loss(lg, t), batch_axis="cross")
        assert batch_group is not None
        out[f"{tag}.losses"] = np.array(
            [float(step(mine, mine)) for _ in range(TP_STEPS)])
        plan = tp_mod.params_shardings(placed, "local",
                                       hvd.transformer_tp_rules("local"))
        for n, p in placed.items():
            out[f"{tag}.p.{n}"] = _np(p)
            out[f"{tag}.dim.{n}"] = np.array(
                -1 if plan[n] is None else plan[n].dim)


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pp(hvd, rank, size, inp, out):
    x = torch.from_numpy(inp["x"])
    target = torch.from_numpy(inp["target"])
    mine = {k: torch.from_numpy(inp[f"{k}{rank}"]).requires_grad_()
            for k in ("w", "b")}
    got = hvd.pipeline_apply(_stage, mine, x)
    out["pp.out"] = _np(hvd.last_stage_value(got))
    loss = hvd.last_stage_value(((got - target) ** 2).mean())
    loss.backward()
    out["pp.loss"] = _np(loss)
    out.update({f"pp.g{k}": _np(p.grad) for k, p in mine.items()})
    # convergence: the JAX test's mapping, Adam(3e-3), 150 steps
    goal = torch.from_numpy(inp["goal"])
    opt = torch.optim.Adam(list(mine.values()), lr=PP_LR)
    losses = []
    for _ in range(PP_STEPS):
        opt.zero_grad()
        loss = hvd.last_stage_value(
            ((hvd.pipeline_apply(_stage, mine, x) - goal) ** 2).mean())
        loss.backward()
        opt.step()
        losses.append(float(loss))
    out["pp.losses"] = np.array(losses)


def groups(hvd, rank, size, inp, out):
    import torch.distributed as dist

    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.ops.flash_attention import attention_reference
    from horovod_tpu_torch.parallel import _util
    from horovod_tpu_torch.runtime import hierarchy

    c10d = dist.distributed_c10d
    gen = torch.Generator().manual_seed(0)
    full = [torch.randn(1, 2, 4 * 2, 16, generator=gen) for _ in range(3)]
    worst, counts, made = 0.0, [], None
    for i in range(400):
        # int64: exact whatever the tuner picks (its cross-hop compression
        # narrows floating payloads only)
        x = torch.full((1000 + i % 7,), 2 ** 40 + rank, dtype=torch.int64)
        h = hvd.allreduce_async(x, op=hvd.Sum, name=f"tune.{i % 3}")
        if i == 3:  # the axes' groups, while the tuner sweeps
            before = c10d._world.group_count
            made = [_util.axis_group(a) for a in ("local", "cross")]
            counts.append(c10d._world.group_count - before)
        want = sum(2 ** 40 + r for r in range(size))
        assert int(hvd.synchronize(h)[0]) == want
        if made is not None:  # the lane is clear now (the guard)
            for axis in ("local", "cross"):
                ranks = _util.axis_ranks(axis)
                me = ranks.index(rank)
                q, k, v = (t[:, :, me * 4:(me + 1) * 4] for t in full)
                o = hvd.ring_attention(q, k, v, axis, True)
                ref = attention_reference(*full, causal=True)
                worst = max(worst, float(
                    (o - ref[:, :, me * 4:(me + 1) * 4]).abs().max()))
        rt = state.global_state().runtime
        frozen = torch.tensor([0 if rt._autotune_active else 1])
        if i > 3 and int(hvd.allreduce(frozen, op=hvd.Min,
                                       name="tune.frozen")):
            break
    out["groups.iterations"] = np.array(i + 1)
    out["groups.ring_err"] = np.array(worst)
    out["groups.count_moved"] = np.array(counts)
    out["groups.hier_built"] = np.array(hierarchy.STATS["built"])
    out["groups.names"] = np.array([c10d._get_process_group_name(g)
                                    for g in made])
    # the lane guard: clear with nothing in flight ...
    hvd.assert_collective_lane_clear()
    # ... raises on rank 0 while its "lane.a" waits for its peers ...
    handle = None
    if rank == 0:
        handle = hvd.allreduce_async(torch.ones(4), name="lane.a")
        try:
            hvd.assert_collective_lane_clear()
        except hvd.OrderedLaneError as exc:
            out["lane.raised"] = np.array(str(exc))
        # the model-parallel entry points check before any collective of
        # theirs, so no peer is left waiting
        q = full[0][:, :, :4]
        for name, call in (
                ("ring", lambda: hvd.ring_attention(q, q, q, "local")),
                ("ulysses", lambda: hvd.ulysses_attention(q, q, q, "local")),
                ("pipeline", lambda: hvd.pipeline_apply(
                    lambda p, h: h, None, q[None], "local"))):
            try:
                call()
            except hvd.OrderedLaneError:
                out[f"lane.{name}"] = np.array(True)
    else:
        hvd.assert_collective_lane_clear()
    dist.barrier()  # the default group: the runtime issues nothing there
    if rank != 0:
        handle = hvd.allreduce_async(torch.ones(4), name="lane.a")
    assert float(hvd.synchronize(handle)[0]) == 1.0
    # ... and clear again once it is done
    hvd.assert_collective_lane_clear()
    out["lane.cleared"] = np.array(True)


def run(rank: int, size: int, tmpdir: str, mode: str, env: dict,
        device: str = "cpu") -> None:
    os.environ.update(env)
    os.environ.update(HOROVOD_RANK=str(rank), HOROVOD_SIZE=str(size),
                      HOROVOD_COORDINATOR_ADDR=f"file://{tmpdir}/store")
    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    if device == "cuda" or mode == "rehearse":
        # the card is the rank's, whatever HOROVOD_LOCAL_SIZE groups
        hvd.init(device=torch.device("cuda", rank) if device == "cuda"
                 else "cpu")
        try:
            cards(hvd, rank, size, tmpdir, mode)
        finally:
            hvd.shutdown()
        return
    hvd.init(device="cpu")
    try:
        inp = dict(np.load(os.path.join(tmpdir, "inputs.npz")))
        out = {}
        for one in mode.split(","):
            dict(seq=seq, tp=tp, pp=pp, groups=groups)[one](hvd, rank, size,
                                                            inp, out)
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"), **out)
    finally:
        hvd.shutdown()


def start(tmpdir, size: int, mode: str, env=None, device: str = "cpu"):
    """Start the world's ranks in spawned processes."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, size, str(tmpdir), mode,
                                           dict(env or {}), device))
             for r in range(size)]
    for p in procs:
        p.start()
    return procs


def join(procs, tmpdir, timeout: int = 240) -> list:
    """Wait for the ranks; their outputs (none from a world of cards)."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.monotonic()))
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive) and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    files = [os.path.join(str(tmpdir), f"rank{r}.npz")
             for r in range(len(procs))]
    return [dict(np.load(f)) for f in files if os.path.exists(f)]


# ---------------------------------------------------------------------------
# One rank a card (and its CPU rehearsal at toy widths)
# ---------------------------------------------------------------------------

GPT = dict(vocab_size=50257, d_model=768, num_layers=12, num_heads=12,
           d_ff=3072)
BERT = dict(vocab_size=30522, d_model=1024, num_layers=24, num_heads=16,
            d_ff=4096, max_seq=512)
CARDS = dict(gpt=GPT, seq=8192, seq_batch=2, bert=BERT, bert_batch=8,
             bert_predictions=76, pp_micro=8, pp_mb=2, pp_seq=1024, steps=5)
REHEARSAL = dict(
    gpt=dict(vocab_size=96, d_model=64, num_layers=4, num_heads=4, d_ff=128),
    seq=64, seq_batch=2,
    bert=dict(vocab_size=96, d_model=64, num_layers=2, num_heads=4,
              d_ff=128, max_seq=32), bert_batch=2, bert_predictions=5,
    pp_micro=4, pp_mb=2, pp_seq=16, steps=3)
#: the losses' limits against the unsharded runs, relative. The ring
#: rounds each partial output to bfloat16 before the float32 merge (2^-8
#: of an element) where one flash pass rounds once; Megatron's row-parallel
#: products are rounded to bfloat16 per rank before their float32 sum; the
#: gradients are averaged in another order. A wrong mask, offset or shard
#: moves the loss by whole percents.
LIMITS = dict(ring=5e-3, ulysses=5e-3, tp=5e-3, pp=1e-4)
CARDS_DEADLINE = 480  # seconds for all the cases; about 3 minutes on H100s


def _timed(step, steps, dev):
    """``steps`` calls of ``step() -> loss``; the losses, the median ms of
    the calls after the first and the peak bytes allocated."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step()))  # waits for the step
        times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return dict(losses=losses, ms=float(np.median(times[1:])), peak=peak)


def _free(dev):
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _report(hvd, label, run, ref=None, limit=None):
    """Rank 0 prints a run (its step ms, the largest peak of any card)
    beside its unsharded reference; every rank holds the losses to the
    limit."""
    rank = hvd.rank()
    peak = int(hvd.allreduce(torch.tensor([run["peak"]],
                                          device=hvd.device()),
                             op=hvd.Max, name=f"cards.peak.{label}")[0])
    line = (f"{label}: losses " + " ".join(f"{x:.6f}" for x in run["losses"])
            + f"; step {run['ms']:.2f} ms; peak {peak / 2**30:.2f} GiB "
            "(the largest card's)")
    worst = None
    if ref is not None:
        worst = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                        ref["losses"]))
        line += f"; worst relative difference {worst:.3e} (limit {limit})"
    if rank == 0:
        print(line, flush=True)
    assert all(np.isfinite(run["losses"])), (label, run["losses"])
    if worst is not None:
        assert worst <= limit, (label, worst, limit)


def _seq_cases(hvd, cfg, dev, rank, size):
    """GPT-2-small over a sequence of ``seq`` sharded on the world, by ring
    and by Ulysses, ``steps`` AdamW steps, against each card's own
    unsharded run over the whole sequence with the same loss (the mean of
    the shards' causal LM losses)."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)

    seq, sl = cfg["seq"], cfg["seq"] // size
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg["gpt"]["vocab_size"], (cfg["seq_batch"], seq))).to(dev)

    def adamw(model):
        return torch.optim.AdamW(model.parameters(), lr=1e-4,
                                 weight_decay=1e-4)

    model = Transformer(**cfg["gpt"], max_seq=seq, causal=True, device=dev,
                        seed=0)
    opt = adamw(model)

    def whole():
        opt.zero_grad()
        logits = model(tokens)
        loss = sum(causal_lm_loss(logits[:, i * sl:(i + 1) * sl],
                                  tokens[:, i * sl:(i + 1) * sl])
                   for i in range(size)) / size
        loss.backward()
        opt.step()
        return loss.detach()

    ref = _timed(whole, cfg["steps"], dev)
    _report(hvd, f"unsharded, seq {seq} on one card", ref)
    del model, opt
    _free(dev)
    mine = tokens[:, rank * sl:(rank + 1) * sl]
    for name, fn in (("ring", hvd.ring_attention),
                     ("ulysses", hvd.ulysses_attention)):
        model = Transformer(**cfg["gpt"], max_seq=seq, causal=True,
                            device=dev, seed=0, attention_fn=fn)
        opt = adamw(model)
        params = dict(model.named_parameters())

        def sharded():
            opt.zero_grad()
            loss = causal_lm_loss(model(mine, pos_offset=rank * sl), mine)
            loss.backward()
            # averaged after the backward: no runtime collective in flight
            # beside the attention's (the lane guard)
            grads = hvd.allreduce_gradients(
                {k: p.grad for k, p in params.items()},
                name=f"cards.{name}.grads")
            for k, g in grads.items():
                params[k].grad = g
            opt.step()
            return hvd.allreduce(loss.detach(), name=f"cards.{name}.loss")

        _report(hvd, f"{name}, seq {seq} as {size} x {sl}",
                _timed(sharded, cfg["steps"], dev), ref, LIMITS[name])
        del model, opt
        _free(dev)


def _tp_case(hvd, cfg, dev, rank):
    """BERT-Large under TP over ``local`` x DP over ``cross``, ``bert_batch``
    sequences a DP rank, SGD, against each card's own unsharded run over
    the global batch (the same masked positions, as many a sequence)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models.transformer import (
        Transformer, sample_masked_positions)

    bert, n_dp = cfg["bert"], hvd.cross_size()
    rows, seq = cfg["bert_batch"] * n_dp, bert["max_seq"]
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, bert["vocab_size"], (rows, seq))
    pos = sample_masked_positions(rng, rows, seq, cfg["bert_predictions"])
    labels = np.full((rows, seq), -100)
    np.put_along_axis(labels, pos, np.take_along_axis(tokens, pos, 1), 1)
    # [MASK] (103 in BERT's vocab)
    np.put_along_axis(tokens, pos, min(103, bert["vocab_size"] - 1), 1)
    tokens, labels = (torch.from_numpy(a).to(dev) for a in (tokens, labels))

    def mlm(logits, y):
        return F.cross_entropy(logits.flatten(0, 1), y.flatten())

    def sgd(model):
        return torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)

    model = Transformer(**bert, causal=False, device=dev, seed=0)
    opt = sgd(model)

    def whole():
        opt.zero_grad()
        loss = mlm(model(tokens), labels)
        loss.backward()
        opt.step()
        return loss.detach()

    ref = _timed(whole, cfg["steps"], dev)
    _report(hvd, f"unsharded BERT ({bert['num_layers']} x "
            f"{bert['d_model']}), batch {rows} x {seq} on one card", ref)
    del model, opt
    _free(dev)
    model = Transformer(**bert, causal=False, device=dev, seed=0)
    opt = sgd(model)
    _, step, _ = hvd.tp_train_step(
        model, opt, dict(model.named_parameters()),
        hvd.transformer_tp_rules("local"), loss_fn=mlm, batch_axis="cross")
    b = cfg["bert_batch"]
    mine = slice(hvd.cross_rank() * b, (hvd.cross_rank() + 1) * b)
    run = _timed(lambda: step(tokens[mine], labels[mine]), cfg["steps"], dev)
    _report(hvd, f"TP {hvd.local_size()} x DP {n_dp}, batch {b} x {seq} a "
            "DP rank", run, ref, LIMITS["tp"])
    del model, opt, step
    _free(dev)


def _pp_case(hvd, cfg, dev, rank, size):
    """GPT-2-small's layers as ``size`` stages, ``pp_micro`` microbatches
    of ``pp_mb`` x ``pp_seq``, AdamW over the layers (the embeddings and
    the head fixed), against each card's own sequential stack over the
    same microbatches."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      causal_lm_loss)

    gpt, seq = cfg["gpt"], cfg["pp_seq"]
    n_micro, mb = cfg["pp_micro"], cfg["pp_mb"]
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, gpt["vocab_size"], (n_micro, mb, seq))).to(dev)
    per = gpt["num_layers"] // size

    def build():
        model = Transformer(**gpt, max_seq=seq, causal=True, device=dev,
                            seed=0)
        for p in (model.token_embed, model.pos_embed,
                  *model.final_norm.parameters()):
            p.requires_grad_(False)
        with torch.no_grad():
            x = torch.stack([
                model.token_embed[t].to(model.dtype)
                + model.pos_embed[:seq].to(model.dtype) for t in tokens])
        return model, x

    def head_loss(model, out):
        return sum(causal_lm_loss(
            (model.final_norm(out[i]) @ model.token_embed.to(
                model.dtype).T).float(), tokens[i])
            for i in range(n_micro)) / n_micro

    def run_stack(layers, h):
        for layer in layers:
            h = layer(h)
        return h

    model, x = build()
    opt = torch.optim.AdamW(model.layers.parameters(), lr=1e-4)

    def whole():
        opt.zero_grad()
        out = torch.stack([run_stack(model.layers, x[i])
                           for i in range(n_micro)])
        loss = head_loss(model, out)
        loss.backward()
        opt.step()
        return loss.detach()

    ref = _timed(whole, cfg["steps"], dev)
    _report(hvd, f"sequential {gpt['num_layers']} layers, {n_micro} x {mb}"
            f" x {seq} on one card", ref)
    del model, opt, x
    _free(dev)
    model, x = build()
    stage = model.layers[rank * per:(rank + 1) * per]
    opt = torch.optim.AdamW(stage.parameters(), lr=1e-4)
    last = rank == size - 1

    def piped():
        opt.zero_grad()
        out = hvd.pipeline_apply(run_stack, stage, x)
        local = head_loss(model, out) if last else out.float().sum() * 0
        loss = hvd.last_stage_value(local)
        loss.backward()
        opt.step()
        return loss.detach()

    _report(hvd, f"pipeline {size} stages x {per} layers, {n_micro} "
            f"microbatches of {mb} x {seq}", _timed(piped, cfg["steps"], dev),
            ref, LIMITS["pp"])
    del model, opt, x
    _free(dev)


def cards(hvd, rank, size, tmpdir, mode):
    """Ring and Ulysses, Megatron TP x DP and the pipeline at full width,
    one rank a card; raises when a loss misses its limit. ``mode``
    "rehearse" runs the same at toy widths on the CPU."""
    import faulthandler

    dev = hvd.device()
    cfg = REHEARSAL if mode == "rehearse" else CARDS
    if rank == 0 and dev.type == "cuda":
        from horovod_tpu_torch.utils.measure import card_line

        print(f"{size} x {card_line()}", flush=True)
    # a world that hangs prints where each rank waits, and ends
    faulthandler.dump_traceback_later(CARDS_DEADLINE, exit=True)
    try:
        _seq_cases(hvd, cfg, dev, rank, size)
        _tp_case(hvd, cfg, dev, rank)
        _pp_case(hvd, cfg, dev, rank, size)
    finally:
        faulthandler.cancel_dump_traceback_later()


if __name__ == "__main__":
    sys.exit("import this module; see the tests")
