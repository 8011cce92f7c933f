"""What the port's measuring scripts share: the card's name and power
limit, and the time of a call on the card."""

from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, device) -> float:
    """Mean time of one call of ``fn`` on the card: CUDA events around one
    replay of a CUDA graph that holds ``iters`` calls, captured after a
    warm-up on a side stream. The graph replays the launches back to back,
    so the host's time per call (a wrapper's checks, its allocations, its
    launch) stays out of the reading, as it does for a library call; with
    launches from the host, a wrapper whose host time exceeds its kernel's
    would be timed by the host. The graph is freed before returning. On
    the CPU, the host clock around ``iters`` calls after warm-up."""
    if device.type != "cuda":
        for _ in range(3):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    main.wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()  # the first replay uploads the graph
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    ms = start.elapsed_time(end) / iters
    graph.reset()
    return ms
