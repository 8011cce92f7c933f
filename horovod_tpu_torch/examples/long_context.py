"""Long-context training with ring or Ulysses sequence parallelism on the
port (port of ``examples/jax_long_context.py``): a causal transformer whose
attention runs over a sequence sharded on the ranks of the ``local`` axis
(every rank unless ``HOROVOD_LOCAL_SIZE`` says otherwise), by ring
attention (key/value shards passed around the ring) or Ulysses (an
all-to-all head exchange), with the batch split over the ``cross`` axis.
The tokens are synthetic (seeded), so nothing is downloaded.

    python -m horovod_tpu_torch.examples.long_context --strategy ring \\
        --seq 4096 [--device cpu]

Each rank passes its shard's global position (``pos_offset``) for the
position embeddings and the causal mask. As in the JAX example, the loss
is each shard's next-token loss (the one pair across a shard boundary is
skipped), and the gradients are averaged over the world: sequence shards
weigh like data shards. The average runs after the backward
(``allreduce_gradients``), not from ``DistributedOptimizer``'s hooks
during it: the attention's own collectives must not be in flight beside
the runtime's (``hvd.assert_collective_lane_clear``).
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import Transformer, causal_lm_loss

VOCAB = 32000


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--strategy", default="ring",
                        choices=["ring", "ulysses"])
    parser.add_argument("--seq", type=int, default=4096,
                        help="global sequence length (sharded over 'local')")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    dev = hvd.device()
    n_sp, sp_rank = hvd.local_size(), hvd.local_rank()
    if args.seq % n_sp:
        raise SystemExit(f"--seq {args.seq} does not split over {n_sp} "
                         "ranks")
    s_local = args.seq // n_sp

    if args.strategy == "ring":
        def attn(q, k, v, causal):
            return hvd.ring_attention(q, k, v, "local", causal)
    else:
        def attn(q, k, v, causal):
            return hvd.ulysses_attention(q, k, v, "local", causal=causal)

    model = Transformer(
        vocab_size=VOCAB, d_model=args.d_model, num_layers=args.layers,
        num_heads=args.heads, d_ff=4 * args.d_model, max_seq=args.seq,
        causal=True, attention_fn=attn, device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(params.values(), lr=1e-4)

    rng = np.random.RandomState(0)
    rows = slice(hvd.cross_rank() * args.batch_size,
                 (hvd.cross_rank() + 1) * args.batch_size)
    cols = slice(sp_rank * s_local, (sp_rank + 1) * s_local)
    for i in range(args.steps):
        tokens = rng.randint(0, VOCAB, (args.batch_size * hvd.cross_size(),
                                        args.seq))
        mine = torch.from_numpy(tokens[rows, cols]).to(dev)
        t0 = time.time()
        opt.zero_grad()
        logits = model(mine, pos_offset=sp_rank * s_local)
        loss = causal_lm_loss(logits, mine)
        loss.backward()
        grads = hvd.allreduce_gradients(
            {k: p.grad for k, p in params.items()}, name="long_context.grads")
        for k, g in grads.items():
            params[k].grad = g
        opt.step()
        loss = hvd.allreduce(loss.detach(), name="long_context.loss")
        if hvd.rank() == 0:
            print(f"step {i}: loss {loss.item():.4f} "
                  f"({time.time() - t0:.2f}s, seq {args.seq} over {n_sp} "
                  f"devices, {args.strategy})", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
