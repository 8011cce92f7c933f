#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # on a machine with a CUDA device
    python3 chip_smoke.py --cpu-dry   # rehearsal: CPU, plain versions, tiny

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, CUDA and nvcc versions;
   build the kernels from ``horovod_tpu_torch/csrc`` (one nvcc per source,
   started together) and print what ptxas reports (registers, spills).
2. Kernels against their plain PyTorch versions, in bf16 on the card, with
   the plain version run on float32 copies of the same bf16 inputs:
   (a) B8 H16 S512 D64 (BERT-Large), (b) B16 H12 S1024 D64 causal (GPT-2),
   (c) B1 H4 S2048 D128 causal, (d) ring offsets (all keys in the past;
   rows with every key masked). Limits: o 2e-2 abs, lse 2e-3 abs,
   dq/dk/dv 2e-2 relative to their norm. Then each kernel, its plain
   version and ``scaled_dot_product_attention`` (a yardstick the port never
   calls) are timed with CUDA events at (a) and (b), beside their bounds.
3. A tiny BERT on the card against the same weights on the CPU (plain
   path): loss and hidden states agree.
4. The slice: ``hvd.init()`` (NCCL, world 1), BERT-Large at full width
   (24 x 1024, 16 heads, vocab 30522, seq 512, batch 8), random weights
   from seed 0, ``broadcast_parameters``, ``DistributedOptimizer(AdamW(1e-4,
   weight_decay=1e-4))``, the bench's MLM data (gathered head), 2 warm-up
   and 10 timed steps. The loss must be finite and fall, every kernel must
   have launched 24 times per step and the hooks one allreduce per
   parameter per step.

The last lines are a ``{"kernels": [...]}`` JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. ``--cpu-dry`` runs the
same code on the CPU at tiny sizes and prints neither JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import (BertLarge, Transformer,
                                                  masked_lm_loss_gathered,
                                                  sample_masked_positions)
from horovod_tpu_torch.ops import collectives, kernel_build
from horovod_tpu_torch.ops import flash_attention as fa

PEAK_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SOURCES = ["flash_attention"]
KERNELS = {  # wrapper count name -> (source, the TPU kernels it replaces)
    "flash_fwd": ("horovod_tpu_torch/csrc/flash_attention.cu",
                  "horovod_tpu/ops/pallas/flash_attention.py:205 "
                  "_fwd_single_kernel (+ :109 _fwd_kernel)"),
    "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_attention.cu",
                     "horovod_tpu/ops/pallas/flash_attention.py:523 "
                     "_bwd_dq_single_kernel (+ :395 _bwd_dq_kernel)"),
    "flash_bwd_dkv": ("horovod_tpu_torch/csrc/flash_attention.cu",
                      "horovod_tpu/ops/pallas/flash_attention.py:591 "
                      "_bwd_dkv_single_kernel (+ :456 _bwd_dkv_kernel)"),
}
TOL = {"o": 2e-2, "lse": 2e-3, "grad": 2e-2}

FULL = dict(
    cases={"a": (8, 16, 512, 64, False, 0, 0),
           "b": (16, 12, 1024, 64, True, 0, 0),
           "c": (1, 4, 2048, 128, True, 0, 0),
           "d_past": (2, 4, 512, 64, True, 512, 0),
           "d_masked": (2, 4, 512, 64, True, 64, 200)},
    timed=("a", "b"), iters=50,
    tiny=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
              d_ff=512, max_seq=128), tiny_batch=2,
    model=dict(vocab_size=30522, max_seq=512), batch=8, seq=512,
    warmup=2, steps=10)
DRY = dict(
    cases={"a": (1, 2, 64, 64, False, 0, 0), "b": (1, 2, 96, 64, True, 0, 0),
           "d_masked": (1, 2, 64, 64, True, 8, 40)},
    timed=("a",), iters=2,
    tiny=dict(vocab_size=64, d_model=128, num_layers=1, num_heads=2,
              d_ff=256, max_seq=32), tiny_batch=2,
    model=dict(vocab_size=1000, max_seq=64, num_layers=2), batch=2, seq=64,
    warmup=1, steps=2)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"FAIL: {what}", flush=True)
        raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def environment(dry: bool) -> str:
    if dry:
        log("DRY RUN on the CPU: plain versions at tiny sizes; no device "
            "numbers, no result line")
        return "cpu (dry run)"
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    nvcc = subprocess.run([kernel_build.nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log("nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    kernel_build.build(SOURCES)
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for name in SOURCES:
        fn = None
        for line in kernel_build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                # e.g. ..flash_fwd_kernelILi64ELi64EE.. -> flash_fwd_kernel<64,64>
                m = re.search(r"((?:[a-z]+_)+kernel)I((?:Li\d+E)+)E", line)
                fn = (f"{m.group(1)}<{','.join(re.findall(r'\d+', m.group(2)))}>"
                      if m else line.split("'")[1])
            elif fn and ("registers" in line or "spill" in line
                         or "smem" in line):
                log(f"  ptxas {fn}: {line.split(':', 1)[-1].strip()}")
    return card


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions, then timed
# ---------------------------------------------------------------------------


def unmasked_pairs(sq, sk, causal, q_off, k_off) -> int:
    """(i, j) pairs the mask keeps: the work these inputs need."""
    if not causal:
        return sq * sk
    i = np.arange(sq, dtype=np.int64)
    return int(np.clip(q_off + i - k_off + 1, 0, sk).sum())


def bounds(case) -> dict:
    """Least time per kernel on an H100 SXM: the larger of the bytes it
    must move (each input read once, each output written once) over
    3.35 TB/s and its bf16 tensor-core operations over 989 TFLOP/s."""
    b, h, s, d, causal, q_off, k_off = case
    bh, pairs = b * h, unmasked_pairs(s, s, causal, q_off, k_off)
    mat = 2 * bh * s * d  # bytes of one (B, H, S, D) bf16 tensor
    row = 4 * bh * s      # bytes of one (B, H, S) f32 row vector
    work = {"flash_fwd": (4 * bh * pairs * d, 4 * mat + row),  # q k v o, lse
            "flash_bwd_dq": (6 * bh * pairs * d, 5 * mat + 2 * row),
            "flash_bwd_dkv": (8 * bh * pairs * d, 6 * mat + 2 * row)}
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
        out[name] = dict(flops=flops, bytes=nbytes,
                         bound_ms=1e3 * max(t_ops, t_bytes),
                         bound_by="operations" if t_ops > t_bytes else "bytes")
    return out


def make_inputs(case, device, seed):
    b, h, s, d = case[:4]
    g = torch.Generator(device).manual_seed(seed)
    dtype = torch.bfloat16
    return [torch.randn(b, h, s, d, generator=g, device=device).to(dtype)
            for _ in range(4)]


def kwargs(case):
    return dict(causal=case[4], sm_scale=case[3] ** -0.5, q_offset=case[5],
                k_offset=case[6])


def rel(a, b) -> float:
    return ((a.float() - b).norm() / b.norm().clamp(min=1e-12)).item()


def check_case(name, case, device) -> dict:
    q, k, v, do = make_inputs(case, device, seed=len(name))
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_fwd_reference(*f[:3], **kw)
    o_ref = o_ref.float()
    delta_ref = fa.compute_delta(o_ref, f[3])
    dq_ref = fa.flash_bwd_dq_reference(*f, lse_ref, delta_ref, **kw)
    dk_ref, dv_ref = fa.flash_bwd_dkv_reference(*f, lse_ref, delta_ref, **kw)
    live = torch.isfinite(lse_ref)
    grads = {"dq": (dq, dq_ref), "dk": (dk, dk_ref), "dv": (dv, dv_ref)}
    err = {g + "_abs": (a.float() - b).abs().max().item()
           for g, (a, b) in grads.items()}
    err |= {"o": (o.float() - o_ref).abs().max().item(),
           "lse": (lse - lse_ref)[live].abs().max().item() if live.any()
           else 0.0,
           **{g: rel(a, b) for g, (a, b) in grads.items()}}
    masked = int((~live).sum())
    log(f"case {name} B{case[0]} H{case[1]} S{case[2]} D{case[3]} "
        f"causal={case[4]} q_offset={case[5]} k_offset={case[6]}: "
        f"max|o-ref| {err['o']:.3e}  max|lse-ref| {err['lse']:.3e}  "
        f"rel dq {err['dq']:.3e} dk {err['dk']:.3e} dv {err['dv']:.3e}  "
        f"fully masked rows {masked}")
    check(torch.equal(torch.isfinite(lse), live),
          f"case {name}: lse is -inf on other rows than the plain version's")
    check(bool((o[~live] == 0).all()) and bool((lse[~live] == -math.inf).all()),
          f"case {name}: fully masked rows must give o 0 and lse -inf")
    check(all(bool(torch.isfinite(t).all()) for t in (o, dq, dk, dv)),
          f"case {name}: non-finite output or gradient")
    check(err["o"] <= TOL["o"], f"case {name}: o error {err['o']}")
    check(err["lse"] <= TOL["lse"], f"case {name}: lse error {err['lse']}")
    for g in ("dq", "dk", "dv"):
        check(err[g] <= TOL["grad"], f"case {name}: {g} error {err[g]}")
    return err


def time_ms(fn, iters, device) -> float:
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


def time_case(name, case, device, iters) -> dict:
    q, k, v, do = make_inputs(case, device, seed=len(name))
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    bwd = (q, k, v, do, lse, delta)
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.flash_fwd_reference(q, k, v, **kw)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd, **kw),
                         lambda: fa.flash_bwd_dq_reference(*bwd, **kw)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd, **kw),
                          lambda: fa.flash_bwd_dkv_reference(*bwd, **kw)),
    }
    bnd = bounds(case)
    rows = {}
    for kname, (kernel, plain) in calls.items():
        ms, plain_ms = time_ms(kernel, iters, device), time_ms(plain, iters,
                                                                device)
        rows[kname] = dict(ms=ms, plain_ms=plain_ms, **bnd[kname])
    # yardstick only: PyTorch's fused attention, which the port never calls
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = time_ms(lambda: sdpa(q, k, v, is_causal=kw["causal"],
                                   scale=kw["sm_scale"]), iters, device)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        sdpa(qg, kg, vg, is_causal=kw["causal"], scale=kw["sm_scale"]) \
            .backward(do)

    lib_fb = time_ms(fwd_bwd, iters, device)
    rows["flash_fwd"]["library_ms"] = lib_fwd
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[kname]["library_ms"] = None  # no single call computes it alone
    log(f"timing case {name} B{case[0]} H{case[1]} S{case[2]} D{case[3]} "
        f"causal={case[4]} ({iters} launches each):")
    for kname, r in rows.items():
        log(f"  {kname:14s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
            f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB)  "
            f"share of bound {r['bound_ms'] / r['ms']:.3f}")
    back = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    log(f"  yardstick scaled_dot_product_attention: forward {lib_fwd:.4f} ms,"
        f" forward+backward {lib_fb:.4f} ms (port: forward "
        f"{rows['flash_fwd']['ms']:.4f} ms, dq+dk/dv {back:.4f} ms)")
    return rows


# ---------------------------------------------------------------------------
# Phase 3: a tiny model on the card against the CPU
# ---------------------------------------------------------------------------


def tiny_model_check(cfg, device) -> None:
    seq, batch = cfg["tiny"]["max_seq"], cfg["tiny_batch"]
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, cfg["tiny"]["vocab_size"], (batch, seq))
    pos = sample_masked_positions(np.random.default_rng(1), batch, seq, 8)
    labels = np.take_along_axis(tokens, pos, axis=1)
    m_dev = Transformer(**cfg["tiny"], device=device, seed=1)
    m_cpu = Transformer(**cfg["tiny"], device="cpu", seed=1)
    m_cpu.load_state_dict(m_dev.state_dict())
    out = {}
    for m, dev in ((m_dev, device), (m_cpu, torch.device("cpu"))):
        t = [torch.from_numpy(a).to(dev) for a in (tokens, pos, labels)]
        hidden = m(t[0], output="hidden")
        loss = masked_lm_loss_gathered(hidden, m.token_embed, t[1], t[2])
        loss.backward()
        out[dev.type] = (hidden.float().cpu(), loss.item(),
                         m.layers[0].attention.query.weight.grad.cpu())
    (h_dev, l_dev, g_dev), (h_cpu, l_cpu, g_cpu) = out[device.type], out["cpu"]
    errs = (rel(h_dev, h_cpu), abs(l_dev - l_cpu) / abs(l_cpu), rel(g_dev, g_cpu))
    log(f"tiny BERT on {device.type} vs cpu (bf16): hidden rel {errs[0]:.3e},"
        f" loss {l_dev:.5f} vs {l_cpu:.5f}, query-weight grad rel "
        f"{errs[2]:.3e}")
    check(math.isfinite(l_dev) and errs[0] <= 2e-2 and errs[1] <= 1e-2
          and errs[2] <= 5e-2, "tiny BERT on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


def train(cfg, device, card, profile=False) -> dict:
    batch, seq = cfg["batch"], cfg["seq"]
    vocab = cfg["model"]["vocab_size"]
    n_pred = max(1, round(0.15 * seq))  # 76 at seq 512 (BERT's layout)
    # the bench's data (bench.py:453-460)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, vocab, (batch, seq)).astype(np.int32)
    rng.rand(batch, seq)  # the bench's unused full-logits mask draw
    positions = sample_masked_positions(np.random.default_rng(0), batch, seq,
                                        n_pred)
    labels = np.take_along_axis(tokens, positions, axis=1)

    fa.reset_launch_counts()
    collectives.reset_counts()
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = BertLarge(**cfg["model"], device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    n_tensors = len(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    n_layers = len(model.layers)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def step():
        opt.zero_grad()
        hidden = model(toks, output="hidden")
        loss = masked_lm_loss_gathered(hidden, model.token_embed, pos, lab)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, times = [], []
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step()
        losses.append(loss.item())  # waits for the step's last kernel
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = dict(fa.LAUNCHES)
    counts = dict(collectives.COUNTS)
    if profile:
        breakdown(step, dev, statistics.median(times))
    hvd.shutdown()

    log(f"slice: BERT-Large MLM, {n_layers} layers, {n_params / 1e6:.1f}M "
        f"params in {n_tensors} tensors, batch {batch} x seq {seq}, "
        f"{cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    check(all(math.isfinite(x) for x in losses), "non-finite loss")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts == {"allreduce": n_tensors * steps,
                     "broadcast": len(model.state_dict())},
          f"collectives {counts}: want {n_tensors * steps} allreduces and "
          f"{len(model.state_dict())} broadcasts")
    if dev.type == "cuda":
        for name, n in launches.items():
            check(n == n_layers * steps,
                  f"{name} launched {n} times, want {n_layers} x {steps}")
    step_s = statistics.median(times)
    # FLOPs/token as bench.py:497-503 counts them (gathered MLM head)
    d_model = model.token_embed.shape[1]
    n_embed = vocab * d_model
    n_eff = n_params - n_embed + n_embed * n_pred // seq
    flops_per_token = 6 * n_eff + 12 * n_layers * seq * d_model
    tok_s = batch * seq / step_s
    where = f"({card})"
    if dev.type == "cuda":
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  tokens/s {tok_s:.1f} {where}")
        log(f"  MFU {tok_s * flops_per_token / PEAK_FLOPS:.4f} against "
            f"989 TFLOP/s bf16, {flops_per_token / 1e9:.3f} GFLOP/token "
            f"{where}")
        log(f"  max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB {where}")
    return launches


GROUPS = (  # kernel-name fragments -> group, first match wins
    ("flash_", "attention kernels (port)"),
    ("nccl", "NCCL collectives"),
    ("gemm", "dense matmuls (cuBLAS)"), ("nvjet", "dense matmuls (cuBLAS)"),
    ("xmma", "dense matmuls (cuBLAS)"), ("cutlass", "dense matmuls (cuBLAS)"),
    ("multi_tensor_apply", "optimizer (foreach AdamW)"),
    ("layer_norm", "layernorm"), ("LayerNorm", "layernorm"),
    ("cat", "copies and casts"), ("copy", "copies and casts"),
    ("elementwise", "other element-wise"), ("reduce", "reductions"),
)


def breakdown(step, device, step_s: float, n: int = 3) -> None:
    """Trace ``n`` steps with torch.profiler; print device time per step by
    kernel group and the top kernels, and the device's busy share of the
    step (kernel time over the median timed step)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(n):
            step().item()
    host = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU]
    log(f"profile over {n} steps, host: self CPU time of the costliest "
        "operators")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"    {e.self_cpu_time_total / n / 1e3:8.3f} ms/step "
            f"{e.count // n:5d}x  {e.key[:90]}")
    # kernels only: a user annotation (Optimizer.step#...) spans kernels
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    if not rows:
        log("profile: no device time recorded (not measured)")
        return
    groups: dict = {}
    for e in rows:
        g = next((grp for frag, grp in GROUPS if frag in e.key),
                 "other kernels")
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + e.self_device_time_total, c + e.count)
    total = sum(t for t, _ in groups.values())
    log(f"profile, device: kernel time {total / n / 1e3:.2f} "
        f"ms per step, busy share {total / n / 1e6 / step_s:.3f} of the "
        f"{1e3 * step_s:.2f} ms median step")
    for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {g:28s} {t / n / 1e3:9.3f} ms/step  {c // n:6d} launches/step")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / n / 1e3:8.3f} ms/step "
            f"{e.count // n:5d}x  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-dry", action="store_true",
                    help="rehearse on the CPU with the plain versions at "
                         "tiny sizes; prints no result")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed steps, trace 3 more with "
                         "torch.profiler and print where the step's device "
                         "time goes")
    args = ap.parse_args()
    dry = args.cpu_dry
    if not dry and not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              flush=True)
        return 1
    cfg = DRY if dry else FULL
    device = torch.device("cpu" if dry else "cuda")
    if not dry:
        torch.backends.cuda.matmul.allow_tf32 = False  # float32 references
    card = environment(dry)

    # largest absolute error of each kernel's output over every case
    errs = dict.fromkeys(KERNELS, 0.0)
    for name, case in cfg["cases"].items():
        e = check_case(name, case, device)
        errs["flash_fwd"] = max(errs["flash_fwd"], e["o"])
        errs["flash_bwd_dq"] = max(errs["flash_bwd_dq"], e["dq_abs"])
        errs["flash_bwd_dkv"] = max(errs["flash_bwd_dkv"], e["dk_abs"],
                                    e["dv_abs"])
    log(f"kernels agree with their plain versions in every case (limits: o "
        f"{TOL['o']} abs, lse {TOL['lse']} abs, grads {TOL['grad']} relative)")
    timed = {name: time_case(name, cfg["cases"][name], device, cfg["iters"])
             for name in cfg["timed"]}
    tiny_model_check(cfg, device)
    launches = train(cfg, device, card, args.profile)
    if dry:
        log("DRY RUN complete: control flow rehearsed; no result line")
        return 0

    main_case = timed["a"]
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    max_abs_err=errs[name],
                    ms=main_case[name]["ms"],
                    plain_ms=main_case[name]["plain_ms"],
                    bound_ms=main_case[name]["bound_ms"],
                    bound_by=main_case[name]["bound_by"],
                    library_ms=main_case[name]["library_ms"])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
