#!/usr/bin/env python
"""BERT-Large on the port with the sparse embedding path (port of
``examples/pytorch_bert_large_sparse.py``).

BASELINE progression config #5, "BERT-Large-style allgather/sparse": the
model family trained through the torch API with the token embedding's
gradient exchanged sparsely (an allgather of values and indices, summed
on coalesce) instead of densified, the way the reference exchanges
tf.IndexedSlices (reference: horovod/tensorflow/__init__.py:64-75;
examples/pytorch_synthetic_benchmark.py is the harness shape):

    python -m horovod_tpu_torch.examples.bert_large_sparse   # full, card
    python -m horovod_tpu_torch.examples.bert_large_sparse --device cpu \\
        --layers 2 --seq 32 --batch 4 --steps 2   # CI-sized, CPU

Prints per-rank tokens/s and checks that all ranks hold identical weights
after training (the lockstep invariant).
"""

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd

VOCAB = 30522


class BertLarge(torch.nn.Module):
    """BERT-Large-shaped encoder MLM (d=1024, 16 heads, ff 4096; layer
    count configurable for CI). The token embedding is sparse=True so its
    gradient takes the allgather/sparse path."""

    def __init__(self, layers=24, d_model=1024, heads=16, seq=512):
        super().__init__()
        self.tok = torch.nn.Embedding(VOCAB, d_model, sparse=True)
        self.pos = torch.nn.Embedding(seq, d_model)
        layer = torch.nn.TransformerEncoderLayer(
            d_model, heads, dim_feedforward=4 * d_model,
            batch_first=True, norm_first=True)
        self.encoder = torch.nn.TransformerEncoder(layer, layers)
        self.head = torch.nn.Linear(d_model, VOCAB)

    def forward(self, ids):
        x = self.tok(ids) + self.pos.weight[None, : ids.shape[1]]
        return self.head(self.encoder(x))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--layers", type=int, default=24)
    parser.add_argument("--seq", type=int, default=512)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="'cpu' to run on the CPU (default: the card)")
    args = parser.parse_args(argv)

    hvd.init(device=args.device)
    device = hvd.device()
    torch.manual_seed(1234 + hvd.rank())  # different init; broadcast fixes
    model = BertLarge(layers=args.layers, seq=args.seq).to(device)

    # sparse-compatible optimizer (momentum densifies); the wrapper
    # exchanges the embedding grad by allgather, everything else by
    # allreduce
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size()),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    rng = np.random.RandomState(100 + hvd.rank())  # different data
    loss_fn = torch.nn.CrossEntropyLoss()
    tokens_done = 0
    t0 = time.perf_counter()
    for step in range(args.steps):
        ids = torch.from_numpy(
            rng.randint(0, VOCAB, (args.batch, args.seq))).to(device)
        logits = model(ids)
        loss = loss_fn(logits.reshape(-1, VOCAB), ids.reshape(-1))
        loss.backward()
        opt.step()
        opt.zero_grad()
        tokens_done += args.batch * args.seq
        if hvd.rank() == 0:
            print(f"step {step}: loss {loss.item():.3f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    # lockstep invariant: every rank holds identical weights
    digest = hvd.allgather(
        torch.cat([p.detach().reshape(-1)[:512]
                   for p in model.parameters()]).reshape(1, -1),
        name="bert/weights")
    for r in range(1, hvd.size()):
        assert torch.equal(digest[0], digest[r]), "ranks diverged"

    print(f"rank {hvd.rank()}: {tokens_done / dt:.1f} tokens/s "
          f"(torch on {device}) — lockstep OK", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
