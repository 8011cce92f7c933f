"""One rank of the serving cell of the port's chaos matrix
(``serve_kill_replica``; port of ``tools/serve_chaos_worker.py``).

    python -m horovod_tpu_torch.tools.serve_chaos_worker [--model tiny|gpt2-small]

Rank 0 is the frontend and load generator: a
:class:`~horovod_tpu_torch.serve.queue.KVQueueFrontend` on the matrix's
rendezvous store submits ``CHAOS_SERVE_REQUESTS`` requests round-robin over
the fleet and polls until each has completed, sending again the requests
of a replica whose heartbeat lapsed. It alone prints ``CHAOS_RESULT``:

* ``zero_lost``: every submitted request completed despite the kill;
* ``requeued``: the dead replica's requests really went to the others.

With ``CHAOS_SERVE_OUT`` set it also writes each completion (prompt,
tokens, serving rank) there as JSON, for a caller that holds the tokens
against a reference forward.

Ranks 1 and up are replicas: each builds the same model from seed 0 and
runs :func:`~horovod_tpu_torch.serve.replica.run_kv_replica` until rank 0
publishes the stop key. ``HOROVOD_FAULT_INJECT=kill:rank=2:step=5`` fires
on the victim's 5th decode step, mid-generation. No ``hvd.init()``
anywhere: the serving plane rides the KV store alone.

``--model gpt2-small`` (the default) is GPT-2-small (12 x 768, vocab
50257) on ``cuda:0``, every replica on the same card; ``--model tiny`` is
the JAX worker's tiny float32 transformer on the CPU, the default under
``CHAOS_DEVICE=cpu``. A replica on the card prints ``PEAK rank=<r>
bytes=<n>`` (``torch.cuda.max_memory_allocated``) every 2 s and when it
drains.
"""

import argparse
import json
import os
import sys
import threading
import time
import uuid

import numpy as np
import torch

from horovod_tpu_torch.tools.chaos_worker import (final_dump,
                                                  resilience_counters)

N_REQUESTS = int(os.environ.get("CHAOS_SERVE_REQUESTS", "30"))
DRAIN_TIMEOUT = float(os.environ.get("CHAOS_SERVE_TIMEOUT", "150"))
TINY = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, d_ff=64,
            max_seq=64, causal=True)
GPT2_VOCAB = 50257


def build_model(kind: str):
    from horovod_tpu_torch.models.transformer import GPT2Small, Transformer

    if kind == "gpt2-small":
        return GPT2Small(vocab_size=GPT2_VOCAB, device="cuda:0", seed=0)
    return Transformer(dtype=torch.float32, device="cpu", seed=0, **TINY)


def _report_peak(rank: int, stop: threading.Event) -> None:
    while True:
        print(f"PEAK rank={rank} bytes={torch.cuda.max_memory_allocated()}",
              flush=True)
        if stop.wait(2.0):
            return


def run_replica(rank: int, addr: str, port: int, kind: str) -> int:
    from horovod_tpu_torch import tracing
    from horovod_tpu_torch.serve import ServePolicy, run_kv_replica
    from horovod_tpu_torch.serve.api import _serve_guard

    tracing.configure(rank=rank)
    model = build_model(kind)
    stop = threading.Event()
    reporter = None
    if kind == "gpt2-small":
        reporter = threading.Thread(target=_report_peak, args=(rank, stop),
                                    daemon=True)
        reporter.start()
    policy = ServePolicy.from_env()
    guard = _serve_guard(rank) if policy.quarantine else None
    try:
        replica = run_kv_replica(model, policy, rank=rank, addr=addr,
                                 port=port, guard=guard)
    finally:
        stop.set()
        if reporter is not None:
            reporter.join()
    print(f"serve_chaos_worker: rank {rank} drained "
          f"({replica.completed} completed)", flush=True)
    return 0


def run_frontend(world: int, addr: str, port: int, kind: str) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.run.rendezvous import KVStoreClient
    from horovod_tpu_torch.serve.queue import KVQueueFrontend, Request

    vocab = GPT2_VOCAB if kind == "gpt2-small" else TINY["vocab_size"]
    client = KVStoreClient(addr, port, scope="serve", timeout=10.0)
    frontend = KVQueueFrontend(client)
    live = frontend.wait_for_replicas(
        world - 1, timeout=float(os.environ.get("CHAOS_SERVE_UP", "60")))
    print(f"serve_chaos_worker: fleet up: {live}", flush=True)
    rng = np.random.RandomState(0)
    max_new = int(os.environ.get("HOROVOD_SERVE_MAX_NEW_TOKENS", "16"))
    prompts = {}
    t0 = time.monotonic()
    for i in range(N_REQUESTS):
        prompt = rng.randint(1, vocab, int(rng.randint(4, 13))).tolist()
        uid = f"req-{i}-{uuid.uuid4().hex[:8]}"
        prompts[uid] = prompt
        frontend.submit(Request(uid=uid, prompt=prompt,
                                max_new_tokens=max_new))
    completions = []
    deadline = time.monotonic() + DRAIN_TIMEOUT
    while frontend.pending() and time.monotonic() < deadline:
        completions.extend(frontend.poll_responses())
        time.sleep(0.05)
    seconds = time.monotonic() - t0
    frontend.stop_fleet()
    done = len(completions)
    result = {
        "rank": 0, "size": world, "generation": 0,
        "submitted": N_REQUESTS, "completed": done,
        "zero_lost": done == N_REQUESTS and frontend.pending() == 0,
        "requeued": frontend.requeued,
        "dead_ranks": sorted(frontend.dead_ranks),
        "served_by": sorted({c.rank for c in completions}),
        "seconds": round(seconds, 3),
        **resilience_counters(hvd.metrics()),
    }
    out = os.environ.get("CHAOS_SERVE_OUT")
    if out:
        with open(out, "w") as f:
            json.dump([{"uid": c.uid, "prompt": prompts[c.uid],
                        "tokens": list(c.tokens), "rank": c.rank}
                       for c in completions], f)
    final_dump()  # rank 0's dispatch and requeue events
    print("CHAOS_RESULT " + json.dumps(result), flush=True)
    return 0 if result["zero_lost"] else 3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    cpu = os.environ.get("CHAOS_DEVICE") == "cpu"
    parser.add_argument("--model", choices=("tiny", "gpt2-small"),
                        default="tiny" if cpu else "gpt2-small")
    args = parser.parse_args(argv)
    torch.set_num_threads(1)
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    world = int(os.environ.get("HOROVOD_SIZE", "4"))
    addr = os.environ.get("HOROVOD_RENDEZVOUS_HTTP_ADDR", "127.0.0.1")
    port = int(os.environ.get("HOROVOD_RENDEZVOUS_HTTP_PORT", "0"))
    if not port:
        print("serve_chaos_worker: no rendezvous port", file=sys.stderr)
        return 2
    if rank == 0:
        return run_frontend(world, addr, port, args.model)
    return run_replica(rank, addr, port, args.model)


if __name__ == "__main__":
    sys.exit(main())
