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
    """Mean time of one call: CUDA events around ``iters`` calls after
    warm-up (the host clock after a synchronise on the CPU)."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, repeats: int, device) -> float:
    """Device time of one ``fn()``: what torch.profiler records for the
    kernels of ``repeats`` calls, over ``repeats``. Unlike :func:`time_ms`
    it leaves out the host's time between launches, which is most of a
    small kernel's wall time. On the CPU, :func:`time_ms`."""
    if device.type != "cuda":
        return time_ms(fn, repeats, device)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / 1e3 / repeats
