"""``python -m horovod_tpu_torch.serve`` — a KV-queue replica worker (port
of ``horovod_tpu/serve/__main__.py``).

Each rank builds the demo model (random weights from ``--seed``, the same
on every replica), registers with the rendezvous KV queue, and serves
until a dispatcher publishes the stop key. Point a
:class:`~horovod_tpu_torch.serve.queue.KVQueueFrontend` at the same
rendezvous server to drive it. The model is built on the card unless
``--device cpu`` is given.

Environment: ``HOROVOD_RANK``, ``HOROVOD_RENDEZVOUS_HTTP_ADDR`` and
``HOROVOD_RENDEZVOUS_HTTP_PORT`` (required), and the ``HOROVOD_SERVE_*``
policy knobs.

Model shape flags exist so smoke runs stay tiny; a real deployment
replaces this module with its own worker that loads trained weights and
calls :func:`horovod_tpu_torch.serve.run_kv_replica`.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve", description=__doc__)
    parser.add_argument("--vocab", type=int, default=256)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--layers", type=int, default=2)
    parser.add_argument("--heads", type=int, default=2)
    parser.add_argument("--d-ff", type=int, default=128)
    parser.add_argument("--max-seq", type=int, default=128)
    parser.add_argument("--seed", type=int, default=0,
                        help="weight seed; identical across the fleet")
    parser.add_argument("--device", default=None,
                        help="the model's device (default: the card)")
    args = parser.parse_args(argv)

    import torch

    from horovod_tpu_torch import profiler, tracing
    from horovod_tpu_torch.models.transformer import Transformer
    from horovod_tpu_torch.serve import ServePolicy, run_kv_replica
    from horovod_tpu_torch.serve.api import _serve_guard

    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    addr = os.environ.get("HOROVOD_RENDEZVOUS_HTTP_ADDR", "127.0.0.1")
    port = int(os.environ.get("HOROVOD_RENDEZVOUS_HTTP_PORT", "0"))
    if not port:
        print("horovod_tpu_torch.serve: HOROVOD_RENDEZVOUS_HTTP_PORT not "
              "set", file=sys.stderr)
        return 2

    model = Transformer(
        vocab_size=args.vocab, d_model=args.d_model,
        num_layers=args.layers, num_heads=args.heads, d_ff=args.d_ff,
        max_seq=args.max_seq, causal=True, dtype=torch.float32,
        device=args.device, seed=args.seed)

    # no hvd.init() here (the serving plane rides the KV store alone),
    # so the tracing and profiling planes adopt the rank explicitly: a
    # replica run with HOROVOD_PROFILE_DIR dumps its request spans
    tracing.configure(rank=rank)
    tracing.note_serve_started()
    profiler.configure(rank=rank)

    policy = ServePolicy.from_env()
    guard = _serve_guard(rank) if policy.quarantine else None
    try:
        replica = run_kv_replica(model, policy, rank=rank, addr=addr,
                                 port=port, guard=guard)
    finally:
        profiler.finalize()
    print(f"horovod_tpu_torch.serve: rank {rank} drained "
          f"({replica.completed} completed)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
