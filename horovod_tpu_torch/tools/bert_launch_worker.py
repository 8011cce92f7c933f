"""BERT-Large MLM on the hooks path, fed by the port's data module: the
worker that ``chip_smoke.py``'s phase 18a starts through the port's
launcher, and the function its in-process reference run calls.

    tpurun-torch -np 1 --flight-recorder-dir DIR \\
        python -m horovod_tpu_torch.tools.bert_launch_worker --out RESULT.json

A seeded token table (``--rows`` rows of ``--seq`` tokens, 15 % of each
row's positions masked) is read through ``ShardedSampler`` (seed 0, this
rank's shard) in batches of ``--batch`` rows, and ``prefetch_to_device``
puts each batch on the worker's device two ahead. Each of ``--steps``
steps is the hooks path of the bench's BERT-Large row: the gathered MLM
loss, ``backward``, and ``DistributedOptimizer(AdamW)``'s step. The result
(JSON at ``--out``): the losses, the seconds each step waited for its
batch, and the flash kernels' launches over the steps (each count set to
0 just before them).

``--tiny`` is a one-layer stand-in and ``--device cpu`` runs on the CPU,
to rehearse without a card; without ``--device`` the worker takes
``cuda:<HOROVOD_LOCAL_RANK>`` (``hvd.init()``).
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

FULL = dict(vocab_size=30522, max_seq=512)
TINY = dict(vocab_size=1000, max_seq=64, num_layers=1, d_model=128,
            num_heads=2, d_ff=256)


def token_table(rows: int, seq: int, vocab: int, seed: int = 0):
    """``rows`` rows of tokens and each row's masked positions (15 % of
    the sequence, sorted, distinct) and their labels, from ``seed``."""
    rng = np.random.RandomState(seed)
    n_pred = max(1, round(0.15 * seq))
    tokens = rng.randint(0, vocab, (rows, seq)).astype(np.int64)
    positions = np.sort(np.stack([rng.choice(seq, n_pred, replace=False)
                                  for _ in range(rows)]), axis=1)
    labels = np.take_along_axis(tokens, positions, axis=1)
    return tokens, positions.astype(np.int64), labels


def batches(table, sampler, batch: int, steps: int):
    """The first ``steps`` batches of ``batch`` rows in the sampler's
    order, as (tokens, positions, labels) numpy arrays."""
    idx = list(sampler)
    if len(idx) < batch * steps:
        raise ValueError(f"the sampler's shard has {len(idx)} rows; "
                         f"{steps} steps of {batch} need {batch * steps}")
    for s in range(steps):
        take = idx[s * batch:(s + 1) * batch]
        yield tuple(a[take] for a in table)


def train(model_cfg: dict, batch: int, steps: int, rows: int) -> dict:
    """The steps on ``hvd.device()`` after ``hvd.init()``; the losses, the
    waits for each batch (seconds) and the flash kernels' launches."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.data import ShardedSampler, prefetch_to_device
    from horovod_tpu_torch.models.transformer import (BertLarge,
                                                      masked_lm_loss_gathered)
    from horovod_tpu_torch.ops import flash_attention as fa

    dev = hvd.device()
    seq = model_cfg["max_seq"]
    model = BertLarge(**model_cfg, device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    table = token_table(rows, seq, model_cfg["vocab_size"])
    sampler = ShardedSampler(rows, seed=0)
    it = prefetch_to_device(batches(table, sampler, batch, steps), size=2,
                            device=dev)
    fa.LAUNCHES.update(dict.fromkeys(fa.LAUNCHES, 0))
    losses, waits = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        tok, pos, lab = next(it)
        waits.append(time.perf_counter() - t0)
        opt.zero_grad()
        loss = masked_lm_loss_gathered(model(tok, output="hidden"),
                                       model.token_embed, pos, lab)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    it.close()
    launches = {k: fa.LAUNCHES[k]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del model, opt
    return dict(losses=losses, waits=waits, launches=launches,
                peak_bytes=peak, device=str(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import horovod_tpu_torch as hvd

    if args.device == "cpu":
        torch.set_num_threads(1)
    hvd.init(device=args.device)
    result = train(TINY if args.tiny else FULL, args.batch, args.steps,
                   args.rows)
    result.update(rank=hvd.rank(), size=hvd.size())
    with open(args.out, "w") as f:
        json.dump(result, f)
    print(f"bert_launch_worker: rank {hvd.rank()} losses "
          + " ".join(f"{x:.6f}" for x in result["losses"]), flush=True)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
