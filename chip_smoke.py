#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # on a machine with a CUDA device
    python3 chip_smoke.py --cpu-dry   # rehearsal: CPU, plain versions, tiny

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, CUDA and nvcc versions;
   build the kernels from ``horovod_tpu_torch/csrc`` (flash_attention.cu,
   adamw.cu, conv_bn_act.cu, conv_bn_stats.cu and attention_probe.cu: one
   nvcc per source, started together) and print what ptxas reports
   (registers, spills).
2. Flash-attention kernels against their plain PyTorch versions, in bf16 on
   the card, with the plain version run on float32 copies of the same bf16
   inputs: (a) B8 H16 S512 D64 (BERT-Large), (b) B16 H12 S1024 D64 causal
   (GPT-2), (c) B1 H4 S2048 D128 causal, (d) ring offsets (all keys in the
   past; rows with every key masked). Limits: o 2e-2 abs, lse 2e-3 abs,
   dq/dk/dv 2e-2 relative to their norm. Then each kernel, its plain
   version and ``scaled_dot_product_attention`` (a yardstick the port never
   calls) are timed with CUDA events at (a) and (b), beside their bounds.
2b. The AdamW kernels against their plain versions on the card, on copies
   of the same inputs with the same float32 scalars, for 3 steps: the
   multi-tensor kernel over BERT-Large's 388 parameter shapes and over a
   mixed set (a bf16 parameter with f32 moments, 7 elements, 131 x 128);
   the flat ZeRO kernel over BERT-Large's world-1 shard (536,870,912
   elements, the bucket pad included) and over ragged lengths (1, 127,
   16,385) with f32 and bf16 gradients and outputs. Limit: bit-equal (both
   round after every float32 operation; adamw.cu is built with
   -fmad=false). Then each is timed at BERT-Large's shapes beside its bound,
   its plain version, ``torch.optim.AdamW(fused=True)`` (a yardstick the
   port never calls) and the foreach AdamW of the phase-4 path.
2c. At world 1, ``fused_adamw`` and ``sharded_adamw`` on the same
   BERT-Large-shaped weights and gradients give bit-equal parameters.
3. A tiny BERT on the card against the same weights on the CPU (plain
   path): loss and hidden states agree.
4. The slice: ``hvd.init()`` (NCCL, world 1), BERT-Large at full width
   (24 x 1024, 16 heads, vocab 30522, seq 512, batch 8), random weights
   from seed 0, ``broadcast_parameters``, ``DistributedOptimizer(AdamW(1e-4,
   weight_decay=1e-4))``, the bench's MLM data (gathered head), 2 warm-up
   and 10 timed steps. The loss must be finite and fall, every kernel must
   have launched 24 times per step and the hooks one allreduce per
   parameter per step.
5. The optimizer paths, each on the same model, data and steps as phase 4:
   (P1) ``allreduce_gradients`` then ``fused_adamw(1e-4).apply`` (the
   multi-tensor kernel once a step, 388 allreduces a step); (P2) ZeRO-1
   ``sharded_adamw(1e-4).apply`` (one reduce-scatter, one flat-kernel launch
   and one allgather per dtype group a step, no allreduce). Losses finite
   and falling, and within 1e-2 relative of phase 4's at every step.
6. The Inception-V3 slice (``bench.py --model inception``, eager, one
   process): ``hvd.init()``, ``InceptionV3(1000, bf16, seed=0)`` on the card,
   ``broadcast_parameters``, ``DistributedOptimizer(SGD(0.01, momentum
   0.9))``, the bench's images (32 x 299 x 299 x 3) and labels, 2 warm-up
   and 10 timed steps. Losses finite and falling, kernel B10 launched 94
   times a step, 284 allreduces a step; images/s, MFU, step ms and peak
   memory beside the card's name and power limit.

7. The GPT-2-small slice (``bench.py:373-560, 2153``): ``hvd.init()``,
   ``GPT2Small(vocab_size=50257)`` at full width (12 x 768, 12 heads, seq
   1024), random weights from seed 0, ``broadcast_parameters``,
   ``DistributedOptimizer(AdamW(1e-4, weight_decay=1e-4))``, the bench's
   tokens (batch 16, ``RandomState(0)``), the full-logits
   ``causal_lm_loss``, 2 warm-up and 10 timed steps; run twice, with the dq
   and dk/dv kernels (``FLASH_FUSED_BWD`` unset) and with the fused
   backward (``FLASH_FUSED_BWD=1``: 12 launches of it a step, none of dq or
   dk/dv). Losses finite and falling in each, the two within 1e-3 relative
   at every step (a step's fall is ~1e-2 of the loss); one allreduce per parameter tensor a step; tokens/s, MFU,
   step ms and peak memory beside the card's name and power limit.

Between them: 2d. kernel B10 (fused BN + ReLU) bit-equal to its plain
version at every distinct BN input of Inception-V3 at batch 32 (bf16),
three of them in f32, ragged C (3, 7, 1000) and 5 elements; then timed
over one forward's 94 calls (device time from torch.profiler). 2e. kernel
B11 (3x3 conv + BN statistics) through
``horovod_tpu_torch.tools.conv_bn_probe`` at its four ResNet-50 shapes
(batch 128; 14 x 14 x 256 is the tool's own), within the tool's limits of
its plain version, timed beside cuDNN's conv alone and conv plus a stats
pass. 3b. a small Inception-V3 (8 x 128 x 128, f32) on the card
against the CPU (eval mode: logits and loss 1e-3, gradient 1e-2; train
mode: twice what one ulp of input moves the CPU's own result), the ReLU
mask elements that differ counted; each mixed block alone in train mode
at 1e-3. 2f. the fused backward B7 against its plain version and against
the dq and dk/dv kernels at (a), (b), a D128 causal case with q_offset !=
k_offset and Sq != Sk, and (d_masked): dq/dk/dv within 2e-2 relative; then
timed at (a) and (b) beside its bound, its plain version, dq + dk/dv and
PyTorch's one-call flash attention backward (a yardstick the port never
calls). 2g. the probe kernels B12-B14 through
``horovod_tpu_torch.tools.flash_vpu_probe`` at BERT-Large's shape (B8 H16
S512 D64) against their plain versions on the tool's data (scale 0.3, a
nearly uniform softmax) and on unit-scale data (a peaked one): o 2e-2 abs
and 1e-2 relative to its norm, lse 2e-3 abs; uniform attention and half
the sm_scale, as controls, must miss the o limit. Each probe function is
driven once with its count set to 0 just before, then timed beside its
bound and SDPA's forward.

The last lines are a ``{"kernels": [...]}`` JSON line (each kernel's
launches counted on the path that runs it: the flash kernels on phase 4,
the multi-tensor AdamW on P1, the flat AdamW on P2, B10 on phase 6, B11 on
the probe's phase 2e, B7 on phase 7's fused run, B12-B14 on the probe's
phase 2g), the card's name and power limit, and ``{"ok": true,
"device": {...}}``. ``--cpu-dry`` runs the
same code on the CPU at tiny sizes and prints neither JSON line.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import inception as inc
from horovod_tpu_torch.models.inception import InceptionV3
from horovod_tpu_torch.models.transformer import (BertLarge, GPT2Small,
                                                  Transformer, causal_lm_loss,
                                                  masked_lm_loss_gathered,
                                                  sample_masked_positions)
from horovod_tpu_torch.ops import collectives, kernel_build
from horovod_tpu_torch.ops import conv_bn_act as cba
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_adamw as fadam
from horovod_tpu_torch.ops import fused_optimizer as fopt
from horovod_tpu_torch.parallel.zero import LeafMeta, build_spec, dtype_name
from horovod_tpu_torch.tools import conv_bn_probe as probe
from horovod_tpu_torch.tools import flash_vpu_probe as vprobe
from horovod_tpu_torch.training import make_train_step
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils.measure import card_line, kernel_ms, time_ms

PEAK_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_F32 = 67e12  # H100 SXM float32 outside the tensor cores
SOURCES = ["flash_attention", "adamw", "conv_bn_act", "conv_bn_stats",
           "attention_probe"]
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
    "adamw_multi": ("horovod_tpu_torch/csrc/adamw.cu",
                    "horovod_tpu/ops/pallas/fused_adamw.py:64 _adamw_kernel"),
    "flat_adamw": ("horovod_tpu_torch/csrc/adamw.cu",
                   "horovod_tpu/ops/pallas/fused_optimizer.py:53 "
                   "_flat_adamw_kernel"),
    "sba": ("horovod_tpu_torch/csrc/conv_bn_act.cu",
            "horovod_tpu/ops/pallas/conv_bn_act.py:64 _sba_kernel"),
    "conv_bn_stats": ("horovod_tpu_torch/csrc/conv_bn_stats.cu",
                      "tools/pallas_conv_bn.py:54 _conv_kernel"),
    "flash_bwd_fused": ("horovod_tpu_torch/csrc/flash_attention.cu",
                        "horovod_tpu/ops/pallas/flash_attention.py:654 "
                        "_bwd_single_kernel"),
    "pack2": ("horovod_tpu_torch/csrc/attention_probe.cu",
              "tools/flash_vpu_probe.py:94 _pack2_kernel"),
    "simple1_lse": ("horovod_tpu_torch/csrc/attention_probe.cu",
                    "tools/flash_vpu_probe.py:173 _simple1_lse_kernel"),
    "simple1": ("horovod_tpu_torch/csrc/attention_probe.cu",
                "tools/flash_vpu_probe.py:159 _simple1_kernel"),
}
# Inception-V3 as the bench runs it (bench.py:84-90, 258-340): batch 32 at
# 299 x 299, 1000 classes, SGD(0.01 x size, momentum 0.9), 11.137 GFLOP per
# image forward, a train step 3x that
INCEPTION_FLOPS = 3 * 11.137e9
# AdamW as the bench runs it (bench.py:473-476, 1398-1408)
ADAMW = dict(b1=0.9, b2=0.999, learning_rate=1e-4, weight_decay=1e-4)
EPS = 1e-8
TOL = {"o": 2e-2, "o_rel": 1e-2, "lse": 2e-3, "grad": 2e-2}

F32, BF16 = torch.float32, torch.bfloat16

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
    warmup=2, steps=10, opt_iters=20,
    inception=dict(batch=32, size=299, classes=1000, dtype=BF16),
    tiny_inception=(8, 128), block_input=(4, 9),
    sba_iters=10,
    probe_shapes=tuple((probe.BATCH, size, c) for size, c in probe.SWEEP),
    probe_iters=20, profile_steps=3,
    # (batch, heads, Sq, Sk, head_dim, causal, q_offset, k_offset)
    fused_cases={"a": (8, 16, 512, 512, 64, False, 0, 0),
                 "b": (16, 12, 1024, 1024, 64, True, 0, 0),
                 "e_d128": (2, 4, 700, 1000, 128, True, 300, 0),
                 "d_masked": (2, 4, 512, 512, 64, True, 64, 200)},
    fused_timed=("a", "b"),
    vprobe_case=vprobe.SHAPES["bert-large"][:4],
    gpt=dict(vocab_size=50257), gpt_batch=16, gpt_seq=1024)
DRY = dict(
    cases={"a": (1, 2, 64, 64, False, 0, 0), "b": (1, 2, 96, 64, True, 0, 0),
           "d_masked": (1, 2, 64, 64, True, 8, 40)},
    timed=("a",), iters=2,
    tiny=dict(vocab_size=64, d_model=128, num_layers=1, num_heads=2,
              d_ff=256, max_seq=32), tiny_batch=2,
    model=dict(vocab_size=1000, max_seq=64, num_layers=1), batch=2, seq=64,
    warmup=1, steps=2, opt_iters=2,
    inception=dict(batch=2, size=75, classes=10, dtype=F32), sba_iters=1,
    tiny_inception=(2, 75), block_input=(2, 5),
    probe_shapes=((2, 6, 32),), probe_iters=1, profile_steps=1,
    fused_cases={"a": (1, 2, 64, 64, 64, False, 0, 0),
                 "e_d128": (1, 2, 40, 96, 128, True, 30, 0),
                 "d_masked": (1, 2, 64, 64, 64, True, 8, 40)},
    fused_timed=("a",), vprobe_case=(1, 2, 96, 64),
    gpt=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
             d_ff=256, max_seq=64), gpt_batch=2, gpt_seq=64)


def check(ok: bool, what: str) -> None:
    if not ok:
        print(f"FAIL: {what}", flush=True)
        raise SystemExit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: environment and build
# ---------------------------------------------------------------------------


def kernel_name(line: str) -> str:
    """The kernel of a ptxas line, template arguments demangled:
    ..flash_fwd_kernelILi64ELi64EEv.. -> flash_fwd_kernel<64,64>,
    ..flat_adamw_kernelI13__nv_bfloat16fEEv.. -> flat_adamw_kernel<bf16,f32>,
    ..adamw_multi_kernelI13__nv_bfloat16S1_ffEEv.. -> <bf16,bf16,f32,f32>."""
    m = re.search(r"((?:[a-z]+_)+kernel)I(.*?)Ev", line)
    if not m:
        return line.split("'")[1]
    # a repeated bf16 is mangled as a back-reference, S<n>_
    args = [t.group(1) or {"f": "f32"}.get(t.group(0), "bf16") for t in
            re.finditer(r"Li(\d+)E|13__nv_bfloat16|S\d*_|f", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


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
                fn = kernel_name(line)
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


def roofline(flops, nbytes, peak=PEAK_FLOPS) -> dict:
    """Least time of a call on an H100 SXM: the larger of the bytes it
    must move (each input read once, each output written once) over
    3.35 TB/s and its operations over ``peak`` (bf16 tensor cores by
    default)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def bounds(case) -> dict:
    """Each flash kernel's :func:`roofline` at a case."""
    b, h, s, d, causal, q_off, k_off = case
    bh, pairs = b * h, unmasked_pairs(s, s, causal, q_off, k_off)
    mat = 2 * bh * s * d  # bytes of one (B, H, S, D) bf16 tensor
    row = 4 * bh * s      # bytes of one (B, H, S) f32 row vector
    work = {"flash_fwd": (4 * bh * pairs * d, 4 * mat + row),  # q k v o, lse
            "flash_bwd_dq": (6 * bh * pairs * d, 5 * mat + 2 * row),
            "flash_bwd_dkv": (8 * bh * pairs * d, 6 * mat + 2 * row)}
    return {name: roofline(*w) for name, w in work.items()}


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
# Phase 2b: the AdamW kernels against their plain versions, then timed
# ---------------------------------------------------------------------------

def model_shapes(cfg) -> list:
    """The parameter shapes of the phase-4 model, in its order."""
    model = BertLarge(**cfg["model"], device="meta")
    return [tuple(p.shape) for p in model.parameters()]


def world1_shard(shapes) -> int:
    """Elements of the world-1 ZeRO shard of f32 leaves of these shapes:
    the real count padded to its size bucket (parallel/zero.py)."""
    spec = build_spec([LeafMeta(s, F32) for s in shapes], 1, 0,
                      64 * 1024)
    return spec.groups[0].shard_elems


def adam_leaves(shapes, dtypes, device, seed) -> list:
    """[p, m, v, g] per leaf: p and g normal, m small, v small and >= 0."""
    gen = torch.Generator(device).manual_seed(seed)

    def draw(shape, scale=1.0, positive=False):
        fn = torch.rand if positive else torch.randn
        return scale * fn(shape, generator=gen, device=device)

    return [[draw(shape).to(dp), draw(shape, 1e-2).to(dm),
             draw(shape, 1e-4, True).to(dv), draw(shape).to(dg)]
            for shape, (dp, dm, dv, dg) in zip(shapes, dtypes)]


def mismatch(a, b) -> tuple:
    """(largest absolute difference, count of elements whose bits differ)."""
    return ((a.float() - b.float()).abs().max().item() if a.numel() else 0.0,
            int((a != b).sum()))


def check_adamw_multi(name, shapes, dtypes, device, steps=3) -> float:
    """The multi-tensor kernel over these leaves against the plain version
    on copies, ``steps`` steps; they must be bit-equal."""
    leaves = adam_leaves(shapes, dtypes, device, seed=len(name))
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    worst, differ = 0.0, 0
    for t in range(1, steps + 1):
        sc = fadam.adamw_scalars(t, **ADAMW)
        fadam.adamw_multi(*map(list, zip(*leaves)), sc, eps=EPS)
        for leaf in ref:
            leaf[:3] = fadam.adamw_leaf_reference(*leaf, sc, EPS)
        for got, want in zip(leaves, ref):
            for a, b in zip(got[:3], want[:3]):
                err, n = mismatch(a, b)
                worst, differ = max(worst, err), differ + n
    n_el = sum(leaf[0].numel() for leaf in leaves)
    combos = sorted({"/".join(dtype_name(d) for d in dt) for dt in dtypes})
    log(f"adamw_multi {name}: {len(leaves)} leaves, {n_el:,} elements, "
        f"dtypes (p/m/v/g) {combos}, {steps} steps: max|kernel-plain| "
        f"{worst:.3e}, {differ} elements differ")
    check(differ == 0, f"adamw_multi {name}: not bit-equal to the plain "
                       f"version ({differ} elements differ)")
    return worst


def flat_inputs(n, n_real, grad_dtype, device, seed) -> list:
    """master, mu, nu (f32) and grad: random over the first ``n_real``
    elements, zeros over the bucket pad, as ZeRO lays a shard out."""
    out = [torch.zeros(n, device=device) for _ in range(4)]
    master, mu, nu, grad = out
    leaf = adam_leaves([(n_real,)], [(F32, F32, F32, F32)], device, seed)[0]
    for dst, src in zip((master, mu, nu, grad), leaf):
        dst[:n_real] = src
    return [master, mu, nu, grad.to(grad_dtype)]


def check_flat_adamw(name, n, n_real, grad_dtype, out_dtype, device,
                     steps=3) -> float:
    """The flat kernel over one shard against the plain version on copies,
    ``steps`` steps; bit-equal."""
    master, mu, nu, grad = flat_inputs(n, n_real, grad_dtype, device,
                                       seed=len(name) + n % 97)
    ref = [t.clone() for t in (master, mu, nu)]
    worst, differ = 0.0, 0
    for t in range(1, steps + 1):
        sc = fadam.adamw_scalars(t, **ADAMW)
        p, *_ = fopt.flat_adamw_shard(master, mu, nu, grad, sc, eps=EPS,
                                      out_dtype=out_dtype)
        want = fopt.flat_adamw_reference(*ref, grad, sc, EPS, out_dtype)
        ref = list(want[1:])
        for a, b in zip((p, master, mu, nu), want):
            err, n_diff = mismatch(a, b)
            worst, differ = max(worst, err), differ + n_diff
        del want
    log(f"flat_adamw {name}: {n:,} elements ({n_real:,} real), grad "
        f"{dtype_name(grad_dtype)}, out {dtype_name(out_dtype)}, {steps} "
        f"steps: max|kernel-plain| {worst:.3e}, {differ} elements differ")
    check(differ == 0, f"flat_adamw {name}: not bit-equal to the plain "
                       f"version ({differ} elements differ)")
    return worst


def free_memory(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def check_optimizer_kernels(cfg, device) -> dict:
    """Phase 2b's correctness half: every case bit-equal."""
    shapes = model_shapes(cfg)
    n_shard = world1_shard(shapes)
    n_real = sum(math.prod(s) for s in shapes)
    errs = {"adamw_multi": max(
        check_adamw_multi("model", shapes, [(F32,) * 4] * len(shapes),
                          device),
        check_adamw_multi("mixed", [(1000,), (7,), (131, 128), (2, 9)],
                          [(BF16, F32, F32, F32), (F32,) * 4, (F32,) * 4,
                           (BF16, BF16, BF16, BF16)], device))}
    free_memory(device)
    errs["flat_adamw"] = check_flat_adamw("world-1 shard", n_shard, n_real,
                                          F32, F32, device)
    free_memory(device)
    for n in (1, 127, 16385):
        for gd, od in ((F32, F32), (BF16, BF16)):
            errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
                "ragged", n, n, gd, od, device))
    return errs


def adamw_bound(n_elems: int, nbytes: int) -> dict:
    """Least time of an AdamW pass: the larger of its bytes over 3.35 TB/s
    and its 16 float32 operations per element over 67 TFLOP/s."""
    return roofline(16 * n_elems, nbytes, PEAK_F32)


def time_optimizers(cfg, device, iters) -> dict:
    """Each AdamW kernel at BERT-Large's shapes beside its bound, its plain
    version and ``torch.optim.AdamW(fused=True)`` over the same tensors (a
    yardstick the port never calls)."""
    shapes = model_shapes(cfg)
    hyper = dict(lr=ADAMW["learning_rate"], betas=(ADAMW["b1"], ADAMW["b2"]),
                 eps=EPS, weight_decay=ADAMW["weight_decay"])
    sc = fadam.adamw_scalars(1, **ADAMW)
    rows = {}

    leaves = adam_leaves(shapes, [(F32,) * 4] * len(shapes), device, seed=7)
    ps, ms, vs, gs = map(list, zip(*leaves))
    for p, g in zip(ps, gs):
        p.grad = g
    n = sum(p.numel() for p in ps)
    fused = torch.optim.AdamW(ps, fused=True, **hyper)
    foreach = torch.optim.AdamW(ps, foreach=True, **hyper)
    rows["adamw_multi"] = dict(
        ms=time_ms(lambda: fadam.adamw_multi(ps, ms, vs, gs, sc, eps=EPS),
                   iters, device),
        plain_ms=time_ms(lambda: [fadam.adamw_leaf_reference(*leaf, sc, EPS)
                                  for leaf in leaves], iters, device),
        library_ms=time_ms(fused.step, iters, device),
        foreach_ms=time_ms(foreach.step, iters, device),
        elems=n, tensors=len(ps), **adamw_bound(n, 28 * n))
    del leaves, ps, ms, vs, gs, fused, foreach
    free_memory(device)

    n_real = sum(math.prod(s) for s in shapes)
    n = world1_shard(shapes)
    master, mu, nu, grad = flat_inputs(n, n_real, F32, device, seed=8)
    master.grad = grad
    fused = torch.optim.AdamW([master], fused=True, **hyper)
    rows["flat_adamw"] = dict(
        ms=time_ms(lambda: fopt.flat_adamw_shard(master, mu, nu, grad, sc,
                                                 eps=EPS, out_dtype=F32),
                   iters, device),
        plain_ms=time_ms(lambda: fopt.flat_adamw_reference(
            master, mu, nu, grad, sc, EPS, F32), iters, device),
        library_ms=time_ms(fused.step, iters, device),
        elems=n, tensors=1, **adamw_bound(n, 32 * n))
    del master, mu, nu, grad, fused
    free_memory(device)
    log(f"timing the AdamW kernels at BERT-Large's shapes ({iters} calls "
        f"each):")
    for kname, r in rows.items():
        log(f"  {kname:12s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  torch fused AdamW "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['elems']:,} elements in {r['tensors']} "
            f"tensors, {r['bytes'] / 1e9:.3f} GB)  share of bound "
            f"{r['bound_ms'] / r['ms']:.3f}")
    log(f"  context: the phase-4 path's foreach AdamW step over the same "
        f"388 tensors {rows['adamw_multi']['foreach_ms']:.4f} ms")
    return rows


# ---------------------------------------------------------------------------
# Phase 2c: fused_adamw and sharded_adamw agree bit for bit at world 1
# ---------------------------------------------------------------------------


def fused_vs_zero(cfg, device, steps=2) -> None:
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    gen = torch.Generator(dev).manual_seed(9)
    shapes = model_shapes(cfg)
    a = {f"w{i}": torch.randn(s, generator=gen, device=dev)
         for i, s in enumerate(shapes)}
    b = {k: t.clone() for k, t in a.items()}
    grads = {k: torch.randn(t.shape, generator=gen, device=dev)
             for k, t in a.items()}
    fused = fadam.fused_adamw(1e-4)
    zero = hvd.sharded_adamw(1e-4)
    fs, zs = fused.init(a), zero.init(b)
    for step in range(steps):
        _, fs = fused.apply(a, fs, grads)
        _, zs = zero.apply(b, zs, grads)
        differ = sum(int((a[k] != b[k]).sum()) for k in a)
        log(f"fused_adamw vs sharded_adamw, world 1, step {step + 1}: "
            f"{len(a)} leaves, {differ} parameter elements differ")
        check(differ == 0, "fused_adamw and sharded_adamw disagree")
    del a, b, grads, fs, zs
    hvd.shutdown()
    free_memory(device)


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
# Phase 2d: kernel B10 (BN + ReLU) against its plain version, then timed
# ---------------------------------------------------------------------------


def bn_shapes(cfg, device) -> list:
    """The (N, C, H, W) input of each of Inception-V3's 94 fused batch
    norms, in call order, at the phase-6 batch and image size (one forward
    without gradients records them)."""
    inc = cfg["inception"]
    model = InceptionV3(num_classes=inc["classes"], dtype=inc["dtype"],
                        device=device)
    shapes = []
    for m in model.modules():
        if isinstance(m, cba.FusedBatchNormAct):
            m.register_forward_pre_hook(
                lambda mod, args: shapes.append(tuple(args[0].shape)))
    with torch.no_grad():
        model(torch.zeros(inc["batch"], inc["size"], inc["size"], 3,
                          device=device))
    del model
    free_memory(device)
    return shapes


def sba_inputs(shape, dtype, device, seed):
    """x channels-last (a conv output's layout), s and b per channel."""
    g = torch.Generator(device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    c = shape[1]
    return (x, torch.randn(c, generator=g, device=device),
            torch.randn(c, generator=g, device=device))


def check_sba(shapes, device) -> float:
    """B10 bit-equal to its plain version: every distinct BN input of the
    model in bf16, a few in f32, ragged channel counts and a 5-element
    tensor."""
    cases = [(s, BF16) for s in sorted(set(shapes))]
    cases += [(s, F32) for s in sorted(set(shapes))[:3]]
    cases += [((4, c, 5, 5), dt) for c in (3, 7, 1000) for dt in (BF16, F32)]
    cases += [((1, 5), BF16), ((1, 5), F32)]
    worst, differ = 0.0, 0
    for i, (shape, dt) in enumerate(cases):
        x, s, b = sba_inputs(shape, dt, device, seed=i)
        err, n = mismatch(cba.sba(x, s, b), cba.sba_plain(x, s, b))
        worst, differ = max(worst, err), differ + n
        check(n == 0, f"sba {shape} {dtype_name(dt)}: {n} elements differ "
                      f"from the plain version")
    log(f"sba: {len(cases)} cases ({len(set(shapes))} Inception-V3 BN "
        f"shapes in bf16, f32, C in 3/7/1000, 5 elements): max|kernel-plain|"
        f" {worst:.3e}, {differ} elements differ")
    return worst


def time_sba(shapes, device, repeats) -> dict:
    """B10 and its plain version over the 94 BN inputs of one forward
    (each shape as often as the model calls it): device time from the
    profiler, beside the bound (each call reads and writes its bf16
    activation once and reads s and b, 8 C bytes, at 3.35 TB/s) and the
    host-inclusive time of the same calls (CUDA events)."""
    inputs = {s: sba_inputs(s, BF16, device, seed=0) for s in set(shapes)}

    def forward(fn):
        return lambda: [fn(*inputs[s]) for s in shapes]

    row = dict(ms=kernel_ms(forward(cba.sba), repeats, device),
               plain_ms=kernel_ms(forward(cba.sba_plain), repeats, device),
               wall_ms=time_ms(forward(cba.sba), repeats, device),
               bound_ms=sum(1e3 * (4 * math.prod(s) + 8 * s[1]) / PEAK_BYTES
                            for s in shapes),
               bound_by="bytes", library_ms=None)  # no single torch call
    log(f"timing sba over one Inception-V3 forward ({len(shapes)} calls, "
        f"{len(inputs)} shapes, {repeats} repeats): kernel {row['ms']:.4f} ms"
        f" of device time ({row['wall_ms']:.4f} ms with the host's launch "
        f"gaps)  plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f}"
        f" ms (bytes)  share of bound {row['bound_ms'] / row['ms']:.3f}")
    return row


# ---------------------------------------------------------------------------
# Phase 2e: kernel B11 (conv + BN statistics) through the probe
# ---------------------------------------------------------------------------


def run_probe(cfg, device) -> tuple:
    """The probe's measurement at each shape: B11 within the tool's limits
    of its plain version, then timed beside its bound, cuDNN's conv alone
    and conv plus a stats pass. Returns the tool's shape's row, the
    largest error of any output and the launches of the run."""
    probe.LAUNCHES["conv_bn_stats"] = 0
    rows, worst = [], 0.0
    for n, size, c in cfg["probe_shapes"]:
        r = probe.measure(n, size, c, c, device, cfg["probe_iters"])
        e = r["err"]
        worst = max(worst, e["y"], e["sum"], e["sumsq"])
        log(f"conv_bn_stats {r['shape']}: max|kernel-plain| y {e['y']:.3e} "
            f"sum {e['sum']:.3e} sumsq {e['sumsq']:.3e} (limits y 2e-2 "
            f"rel+abs, sum 1e-2 rel + 2.0, sumsq 1e-2 rel)")
        check(e["ok"], f"conv_bn_stats {r['shape']}: outside the limits")
        if device.type == "cuda":
            log(f"  kernel {r['ms']:.4f} ms (MFU {r['mfu']:.4f})  plain "
                f"{r['plain_ms']:.4f} ms  cuDNN conv alone {r['conv_ms']:.4f}"
                f" ms (MFU {r['conv_mfu']:.4f})  conv + stats pass "
                f"{r['conv_stats_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}; {r['flops'] / 1e9:.2f} GFLOP, "
                f"{r['bytes'] / 1e6:.1f} MB)")
        rows.append(r)
    tool = next((r for r in rows if r["shape"].startswith(
        f"{probe.BATCH}x{probe.SIZE}x")), rows[0])
    return dict(tool, library_ms=tool["conv_ms"]), worst, \
        probe.LAUNCHES["conv_bn_stats"]


# ---------------------------------------------------------------------------
# Phase 2f: the fused backward B7 against its plain version and dq + dk/dv
# ---------------------------------------------------------------------------


def fused_inputs(case, device, seed):
    """q and do (B, H, Sq, D), k and v (B, H, Sk, D), bf16."""
    b, h, sq, sk, d = case[:5]
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(b, h, s, d, generator=g, device=device).to(BF16)
            for s in (sq, sk, sk, sq)]


def fused_kwargs(case):
    return dict(causal=case[5], sm_scale=case[4] ** -0.5, q_offset=case[6],
                k_offset=case[7])


def fused_bound(case) -> dict:
    """B7's :func:`roofline`: its five products of 2 Sq Sk D over the
    unmasked pairs, against the bf16 tensors q, do, dq (Sq rows) and k, v,
    dk, dv (Sk rows) and the float32 rows lse, delta (Sq)."""
    b, h, sq, sk, d, causal, q_off, k_off = case
    bh = b * h
    flops = 10 * bh * unmasked_pairs(sq, sk, causal, q_off, k_off) * d
    return roofline(flops, 2 * bh * d * (3 * sq + 4 * sk) + 8 * bh * sq)


def check_fused(name, case, device) -> float:
    """B7 on bf16 inputs against its plain version on float32 copies (with
    the plain forward's lse and delta) and against the dq and dk/dv kernels
    on the same inputs: dq, dk, dv within 2e-2 relative to their norm.
    Returns the largest absolute error against the plain version."""
    q, k, v, do = fused_inputs(case, device, seed=len(name) + 10)
    kw = fused_kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    got = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    two = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    if device.type == "cuda":
        torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = fa.flash_fwd_reference(*f[:3], **kw)
    ref = fa.flash_bwd_fused_reference(
        *f, lse_ref, fa.compute_delta(o_ref.float(), f[3]), **kw)
    names = ("dq", "dk", "dv")
    err_ref = [rel(a, b) for a, b in zip(got, ref)]
    err_two = [rel(a, b.float()) for a, b in zip(got, two)]
    worst = max((a.float() - b).abs().max().item() for a, b in zip(got, ref))
    masked = ~torch.isfinite(lse_ref)
    b, h, sq, sk, d, causal, q_off, k_off = case
    log(f"fused case {name} B{b} H{h} Sq{sq} Sk{sk} D{d} causal={causal} "
        f"q_offset={q_off} k_offset={k_off}: rel to plain "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(names, err_ref))
        + "; rel to dq + dk/dv "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(names, err_two))
        + f"; fully masked rows {int(masked.sum())}")
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"fused case {name}: non-finite gradient")
    check(bool((got[0][masked] == 0).all()),
          f"fused case {name}: fully masked rows must get dq 0")
    for n, e1, e2 in zip(names, err_ref, err_two):
        check(e1 <= TOL["grad"] and e2 <= TOL["grad"],
              f"fused case {name}: {n} error {e1} (plain), {e2} (dq + dk/dv)")
    return worst


def aten_flash_backward(q, k, v, do, kw):
    """PyTorch's one-call flash attention backward on these inputs (its own
    forward's output and lse), as a function of no argument: a yardstick
    the port never calls. None on the CPU, which has no such kernel."""
    if q.device.type != "cuda":
        return None
    out = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, kw["causal"], False, scale=kw["sm_scale"])
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, out[0], out[1], out[2], out[3], out[4], out[5], 0.0,
        kw["causal"], out[6], out[7], scale=kw["sm_scale"])


def time_fused(name, case, device, iters) -> dict:
    """B7 timed with CUDA events beside its bound, its plain version, the
    dq and dk/dv kernels (one call of each, summed) and PyTorch's flash
    attention backward."""
    q, k, v, do = fused_inputs(case, device, seed=len(name) + 10)
    kw = fused_kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    args = (q, k, v, do, lse, delta)
    lib = aten_flash_backward(q, k, v, do, kw)
    row = dict(
        ms=time_ms(lambda: fa.flash_bwd_fused(*args, **kw), iters, device),
        plain_ms=time_ms(lambda: fa.flash_bwd_fused_reference(*args, **kw),
                         iters, device),
        two_ms=time_ms(lambda: (fa.flash_bwd_dq(*args, **kw),
                                fa.flash_bwd_dkv(*args, **kw)), iters, device),
        library_ms=time_ms(lib, iters, device) if lib else None,
        **fused_bound(case))
    lib_s = (f"{row['library_ms']:.4f} ms" if lib
             else "not timed (no such kernel on the CPU)")
    log(f"timing fused case {name} ({iters} launches each): B7 "
        f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  dq + dk/dv "
        f"{row['two_ms']:.4f} ms  aten flash backward {lib_s}  bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"{row['flops'] / 1e9:.2f} GFLOP, {row['bytes'] / 1e6:.1f} MB)  "
        f"share of bound {row['bound_ms'] / row['ms']:.3f}")
    return row


# ---------------------------------------------------------------------------
# Phase 2g: the probe kernels B12-B14 through the flash_vpu_probe module
# ---------------------------------------------------------------------------


#: the probes' data: (name, scale of q, k and v), each drawn with
#: ``RandomState(0)``. At the tool's scale of 0.3 the scores have a std of
#: ~0.09 and the softmax is nearly uniform; at unit scale it is peaked.
VPROBE_DATA = (("tool", 0.3), ("unit", 1.0))


def probe_inputs(b, h, s, d, scale, device) -> list:
    rng = np.random.RandomState(0)
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)
                             * scale).to(device, BF16) for _ in range(3)]


def o_errors(got, want) -> tuple:
    """(largest absolute error, error relative to the norm of ``want``)."""
    return (got.float() - want).abs().max().item(), rel(got, want)


def check_probes(data, q, k, v, sm) -> dict:
    """B12, B13 and B14 on bf16 ``q, k, v`` against their plain versions on
    float32 copies: o within ``TOL["o"]`` abs and ``TOL["o_rel"]`` relative
    to its norm, lse within ``TOL["lse"]`` abs. Two outputs a wrong kernel
    could give, attention that weights every key alike (v averaged over
    the keys) and the plain version at half the sm_scale, must be off by
    more than ``TOL["o_rel"]``, or the check could not tell them from the
    right one. Returns the largest absolute error of each kernel."""
    b, h, s, d = q.shape
    f = [t.float() for t in (q, k, v)]
    o_ref, lse_ref = vprobe.simple1_reference(*f, sm)
    controls = {"uniform attention": f[2].mean(2, keepdim=True)
                .expand_as(o_ref),
                "half sm_scale": vprobe.simple1_reference(*f, sm / 2)[0]}
    for cname, c in controls.items():
        e = rel(c, o_ref)
        log(f"probe data {data}: control {cname} is off by {e:.3e} relative "
            f"(must exceed {TOL['o_rel']})")
        check(e > TOL["o_rel"], f"probe data {data}: the {cname} control "
                                f"passes the o limit ({e:.3e})")
    q2, k2, v2 = vprobe.pack(q, k, v)
    errs = {}
    for name in vprobe.PROBES:
        err_lse = None
        if name == "pack2":
            o2 = vprobe.pack2_fwd(q2, k2, v2, sm)
            want = vprobe.pack2_reference(q2.float(), k2.float(), v2.float(),
                                          sm)
            # packed against the packed plain version, and unpacked against
            # the heads' own attention
            err_o = [max(a, b_) for a, b_ in zip(
                o_errors(o2, want),
                o_errors(o2.reshape(b, h // 2, 2, s, d).reshape(b, h, s, d),
                         o_ref))]
        else:
            o, lse = vprobe.simple1_fwd(q, k, v, sm, name == "simple1_lse")
            err_o = o_errors(o, o_ref)
            if lse is not None:
                err_lse = (lse - lse_ref).abs().max().item()
        errs[name] = max(err_o[0], err_lse or 0.0)
        lse_s = "" if err_lse is None else f"  max|lse-ref| {err_lse:.3e}"
        log(f"probe {name} B{b} H{h} S{s} D{d}, {data} data: max|o-ref| "
            f"{err_o[0]:.3e}, relative {err_o[1]:.3e}{lse_s} (limits o "
            f"{TOL['o']} abs and {TOL['o_rel']} relative, lse {TOL['lse']})")
        check(err_o[0] <= TOL["o"] and err_o[1] <= TOL["o_rel"],
              f"probe {name}, {data} data: o error {err_o}")
        check(err_lse is None or err_lse <= TOL["lse"],
              f"probe {name}, {data} data: lse error {err_lse}")
    return errs


def run_vprobe(cfg, device, iters) -> tuple:
    """B12, B13 and B14 at ``cfg["vprobe_case"]`` checked on each of
    :data:`VPROBE_DATA` (:func:`check_probes`), then, on the tool's data,
    each probe function driven once with the counts set to 0 just before
    (the launches of the kernels line) and each kernel timed beside its
    bound (4 S^2 D useful FLOPs per head against its own inputs and
    outputs) and SDPA's forward. Returns (rows, largest errors,
    launches)."""
    b, h, s, d = cfg["vprobe_case"]
    sm = d ** -0.5
    errs = {}
    for data, scale in VPROBE_DATA:
        for name, e in check_probes(
                data, *probe_inputs(b, h, s, d, scale, device), sm).items():
            errs[name] = max(errs.get(name, 0.0), e)
    q, k, v = probe_inputs(b, h, s, d, VPROBE_DATA[0][1], device)
    q2, k2, v2 = vprobe.pack(q, k, v)
    calls = {"simple1": lambda: vprobe.simple1_fwd(q, k, v, sm, False),
             "simple1_lse": lambda: vprobe.simple1_fwd(q, k, v, sm, True),
             "pack2": lambda: vprobe.pack2_fwd(q2, k2, v2, sm)}

    vprobe.reset_launch_counts()  # the probe's own entry points, once each
    for fn in (vprobe.pack2_attention, vprobe.simple1_attention,
               vprobe.simple1_lse_attention):
        fn(q, k, v, sm)
    launches = dict(vprobe.LAUNCHES)
    log(f"probe functions driven once each: kernel launches {launches}")
    if device.type == "cuda":
        check(launches == dict.fromkeys(vprobe.PROBES, 1),
              f"probe launches {launches}, want one of each")

    useful = 4 * b * h * s * s * d
    mat = 2 * b * h * s * d  # bytes of one (B, H, S, D) bf16 tensor
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=sm), iters, device)
    plain = {"simple1": lambda: vprobe.simple1_reference(q, k, v, sm),
             "simple1_lse": lambda: vprobe.simple1_reference(q, k, v, sm),
             "pack2": lambda: vprobe.pack2_reference(q2, k2, v2, sm)}
    nbytes = {"simple1": 4 * mat, "simple1_lse": 4 * mat + 4 * b * h * s,
              "pack2": 2 * (q2.numel() + k2.numel() + v2.numel()) + mat}
    rows = {}
    for name, call in calls.items():
        rows[name] = dict(ms=time_ms(call, iters, device),
                          plain_ms=time_ms(plain[name], iters, device),
                          library_ms=sdpa_ms,
                          **roofline(useful, nbytes[name]))
    rows["pack2"]["executed_flops"] = 2 * useful
    pack_ms = time_ms(lambda: vprobe.pack2_attention(q, k, v, sm), iters,
                      device)
    log(f"timing the probe kernels B{b} H{h} S{s} D{d} ({iters} launches "
        f"each; SDPA forward {sdpa_ms:.4f} ms):")
    for name, r in rows.items():
        log(f"  {name:12s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f}"
            f" ms  bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['flops'] / 1e9:.2f} GFLOP useful, {r['bytes'] / 1e6:.1f} MB)"
            f"  share of bound {r['bound_ms'] / r['ms']:.3f}")
    log(f"  pack2 executes {rows['pack2']['executed_flops'] / 1e9:.2f} GFLOP "
        f"(twice the useful work); pack2_attention with the torch packing "
        f"{pack_ms:.4f} ms")
    return rows, errs, launches


# ---------------------------------------------------------------------------
# Phase 3b: a small Inception-V3 on the card against the CPU
# ---------------------------------------------------------------------------


#: each mixed block: its input channels in Inception-V3, its arguments
BLOCKS = (("InceptionA", 192, (32,)), ("InceptionB", 288, ()),
          ("InceptionC", 768, (128,)), ("InceptionD", 768, ()),
          ("InceptionE", 1280, ()))


def block_train_check(cfg, device) -> None:
    """Each mixed block alone in train mode, float32, on non-negative
    channels-last inputs of ``cfg["block_input"]`` batch and size, (4, C,
    9, 9) on the card, the card against the CPU with the
    same weights: the output, the gradient of x, the worst parameter
    gradient leaf and the worst running-statistics leaf, each within 1e-3
    of its norm. A block is a few layers deep: train mode does not
    amplify rounding there as it does through the whole model."""
    batch, size = cfg["block_input"]
    for name, cin, args in BLOCKS:
        gen = torch.Generator().manual_seed(cin)
        cpu = getattr(inc, name)(cin, *args, dtype=F32, device="cpu")
        with torch.no_grad():
            for m in cpu.modules():
                if isinstance(m, inc.Conv):
                    inc._variance_scaling_(m.kernel, 1.0,
                                                 m.kernel[0].numel(), gen)
        x = torch.randn(batch, cin, size, size, generator=gen).abs() \
            .contiguous(memory_format=torch.channels_last)
        out, masks = {}, {}
        for m, dev in ((copy.deepcopy(cpu).to(device), device),
                       (cpu, torch.device("cpu"))):
            masks[dev.type] = {}
            hooks = _relu_masks(m, masks[dev.type])
            xt = x.to(dev).detach().requires_grad_()
            y = m.train()(xt)
            for h in hooks:
                h.remove()
            y.backward(torch.randn(y.shape, generator=torch.Generator()
                                   .manual_seed(1)).to(dev))
            out[dev.type] = (y.detach().cpu(), xt.grad.cpu(),
                             {k: p.grad.cpu() for k, p in
                              m.named_parameters()},
                             {k: b.cpu() for k, b in m.named_buffers()})
        (ya, ga, pa, ba), (yb, gb, pb, bb) = out[device.type], out["cpu"]
        errs = (rel(ya, yb), rel(ga, gb), max(rel(pa[k], pb[k]) for k in pb),
                max(rel(ba[k], bb[k]) for k in bb))
        flips, n_mask = _masks_differ(masks[device.type], masks["cpu"])
        log(f"{name} train mode on {device.type} vs cpu (f32, {batch} x "
            f"{cin} x {size} x {size}): output rel {errs[0]:.3e}, x grad "
            f"{errs[1]:.3e}, worst parameter grad {errs[2]:.3e}, worst "
            f"running stat {errs[3]:.3e}; "
            f"ReLU mask elements that differ: {flips} of {n_mask}")
        check(max(errs) <= 1e-3,
              f"{name} in train mode on the card disagrees with the CPU")
        free_memory(device)


def _tree_rel(a: dict, b: dict) -> float:
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return math.sqrt(num / max(sum(float((b[k] ** 2).sum()) for k in b),
                               1e-30))


def _relu_masks(model, masks: dict) -> list:
    """Hooks that keep each fused BN's ReLU mask (output > 0) in ``masks``
    by module name; returns their handles."""
    return [m.register_forward_hook(
        lambda mod, i, o, n=n: masks.__setitem__(n, (o > 0).cpu()))
        for n, m in model.named_modules()
        if isinstance(m, cba.FusedBatchNormAct)]


def _masks_differ(a: dict, b: dict) -> tuple:
    """(mask elements that differ, mask elements in all)."""
    return (sum(int((a[k] != b[k]).sum()) for k in b),
            sum(b[k].numel() for k in b))


def tiny_inception_check(cfg, device) -> None:
    """A small Inception-V3 (``cfg["tiny_inception"]`` batch and size,
    float32, 10 classes) on the card against the same weights on the CPU,
    with the ReLU mask elements that differ between the two counted: a
    ReLU whose input lies within rounding of 0 takes the other branch on
    one side, and in a small late layer one such element moves the
    gradient below it by about 1/sqrt(half the layer's size). Eval mode
    (the initial running statistics normalise): logits and loss within
    1e-3, the whole gradient within 1e-2. Train mode at flax's
    initialisation is chaotic in float32 through the 94 layers (one ulp of
    input moves the CPU's own gradients by percents at any batch): logits,
    loss and the whole gradient within twice what one ulp of input moves
    the CPU's own (or 1e-3, where that is looser). Then each mixed block
    in train mode at a fixed limit."""
    batch, size = cfg["tiny_inception"]
    rng = np.random.RandomState(1)
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = torch.from_numpy(rng.randint(0, 10, (batch,)))
    m_dev = InceptionV3(num_classes=10, dtype=F32, device=device, seed=1)
    m_cpu = InceptionV3(num_classes=10, dtype=F32, device="cpu", seed=1)
    start = {k: v.clone() for k, v in m_cpu.state_dict().items()}
    runs = [("card", m_dev, device, images),
            ("cpu", m_cpu, torch.device("cpu"), images)]
    for train in (False, True):
        if train:  # what one ulp of input moves the CPU's own result
            runs.append(("nudged", m_cpu, torch.device("cpu"),
                         np.nextafter(images, np.float32(np.inf))))
        out, masks = {}, {}
        for key, m, dev, x in runs:
            m.load_state_dict(start)
            m.train(train)
            m.zero_grad()
            masks[key] = {}
            hooks = _relu_masks(m, masks[key])
            logits = m(torch.from_numpy(x).to(dev))
            for h in hooks:
                h.remove()
            loss = torch.nn.functional.cross_entropy(logits, labels.to(dev))
            loss.backward()
            out[key] = (logits.detach().cpu(), loss.item(),
                        {k: p.grad.cpu() for k, p in m.named_parameters()})
        (a, la, ga), (b, lb, gb) = out["card"], out["cpu"]
        errs = (rel(a, b), abs(la - lb) / abs(lb), _tree_rel(ga, gb))
        limits, mode, ulp_note = (1e-3, 1e-3, 1e-2), "eval", ""
        if train:
            c, lc, gc = out["nudged"]
            ulp = (rel(c, b), abs(lc - lb) / abs(lb), _tree_rel(gc, gb))
            limits = tuple(max(1e-3, 2 * u) for u in ulp)
            mode = "train"
            ulp_note = (f" (one ulp of input on the cpu: {ulp[0]:.3e} "
                        f"{ulp[1]:.3e} {ulp[2]:.3e})")
        flips, n_mask = _masks_differ(masks["card"], masks["cpu"])
        log(f"tiny Inception-V3 {batch} x {size}^2 on {device.type} vs cpu "
            f"(f32, {mode}): logits rel {errs[0]:.3e}, loss {la:.5f} vs "
            f"{lb:.5f} (rel {errs[1]:.3e}), gradient rel {errs[2]:.3e}; "
            f"limits {limits[0]:.3e} {limits[1]:.3e} {limits[2]:.3e}"
            f"{ulp_note}; ReLU mask elements that differ: {flips} of "
            f"{n_mask}")
        check(math.isfinite(la) and all(bool(torch.isfinite(g).all())
                                        for g in ga.values()),
              "small Inception-V3: non-finite loss or gradient on the card")
        check(all(e <= t for e, t in zip(errs, limits)),
              f"small Inception-V3 on the card disagrees with the CPU "
              f"({mode} mode)")
    del m_dev, m_cpu
    free_memory(device)
    block_train_check(cfg, device)


# ---------------------------------------------------------------------------
# Phase 4: the slice
# ---------------------------------------------------------------------------


PATHS = {  # phase 4 and the optimizer paths of phase 5
    "hooks": "DistributedOptimizer(torch.optim.AdamW), per-parameter hooks",
    "fused": "P1: allreduce_gradients + fused_adamw (multi-tensor kernel)",
    "zero": "P2: ZeRO-1 sharded_adamw (reduce-scatter, flat kernel, "
            "allgather)",
}


def mlm_data(cfg):
    """The bench's MLM batch (bench.py:453-460)."""
    batch, seq = cfg["batch"], cfg["seq"]
    n_pred = max(1, round(0.15 * seq))  # 76 at seq 512 (BERT's layout)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg["model"]["vocab_size"],
                         (batch, seq)).astype(np.int32)
    rng.rand(batch, seq)  # the bench's unused full-logits mask draw
    positions = sample_masked_positions(np.random.default_rng(0), batch, seq,
                                        n_pred)
    labels = np.take_along_axis(tokens, positions, axis=1)
    return tokens, positions, labels, n_pred


def make_step(path, model, params, dev):
    """The training step of one path and what it keeps as optimizer state
    (a callable giving the state's bytes on the card)."""
    names = list(params)
    if path == "hooks":
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4),
            named_parameters=model.named_parameters())

        def update():
            opt.step()

        def state_bytes():
            return sum(t.numel() * t.element_size()
                       for st in opt.state.values() for t in st.values()
                       if isinstance(t, torch.Tensor) and t.device == dev)

        return opt.zero_grad, update, state_bytes
    if path == "fused":
        tx = fadam.fused_adamw(1e-4)
    else:
        tx = hvd.sharded_adamw(1e-4)
    box = [tx.init(params)]

    def update():
        grads = {k: params[k].grad for k in names}
        if path == "fused":  # as bench.py:543-546 does it
            grads = hvd.allreduce_gradients(grads, average=True)
        _, box[0] = tx.apply(params, box[0], grads)

    def state_bytes():
        st = box[0]
        moments = (list(st.mu.values()) + list(st.nu.values())
                   if path == "fused" else [*st.master, *st.mu, *st.nu])
        return sum(t.numel() * t.element_size() for t in moments)

    return (lambda: model.zero_grad(set_to_none=True)), update, state_bytes


def train(cfg, device, card, path="hooks", profile=False) -> dict:
    """Drive one path of the slice: 2 warm-up and 10 timed steps of
    BERT-Large MLM from seed-0 weights. Returns the losses and the kernel
    launches of the run (every count is set to 0 just before it)."""
    batch, seq = cfg["batch"], cfg["seq"]
    vocab = cfg["model"]["vocab_size"]
    tokens, positions, labels, n_pred = mlm_data(cfg)

    for counts in (fa.LAUNCHES, fadam.LAUNCHES, fopt.LAUNCHES,
                   collectives.COUNTS):
        counts.update(dict.fromkeys(counts, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = BertLarge(**cfg["model"], device=dev, seed=0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    params = dict(model.named_parameters())
    zero_grad, update, state_bytes = make_step(path, model, params, dev)
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    n_tensors = len(params)
    n_params = sum(p.numel() for p in params.values())
    n_layers = len(model.layers)
    n_groups = len({p.dtype for p in params.values()})
    n_broadcast = len(model.state_dict())
    d_model = model.token_embed.shape[1]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def step():
        zero_grad()
        hidden = model(toks, output="hidden")
        loss = masked_lm_loss_gathered(hidden, model.token_embed, pos, lab)
        loss.backward()
        update()
        return loss.detach()

    losses, times = [], []
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        loss = step()
        losses.append(loss.item())  # waits for the step's last kernel
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = {**fa.LAUNCHES, **fadam.LAUNCHES, **fopt.LAUNCHES}
    counts = dict(collectives.COUNTS)
    opt_bytes = state_bytes()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if profile:
        breakdown(step, dev, statistics.median(times), cfg["profile_steps"])
    del model, params, update, state_bytes, zero_grad, step
    hvd.shutdown()
    free_memory(device)

    log(f"slice ({path}: {PATHS[path]}): BERT-Large MLM, {n_layers} layers, "
        f"{n_params / 1e6:.1f}M params in {n_tensors} tensors, batch {batch} "
        f"x seq {seq}, {cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    check(all(math.isfinite(x) for x in losses), f"{path}: non-finite loss")
    check(losses[-1] < losses[0], f"{path}: loss did not fall: {losses}")
    per_step = {  # collectives and optimizer launches each path must issue
        "hooks": (dict(allreduce=n_tensors), {}),
        "fused": (dict(allreduce=n_tensors), {"adamw_multi": 1}),
        "zero": (dict(reducescatter=n_groups, allgather=n_groups),
                 {"flat_adamw": n_groups}),
    }[path]
    want = {k: steps * per_step[0].get(k, 0) for k in counts}
    want["broadcast"] = n_broadcast
    check(counts == want, f"{path}: collectives {counts}, want {want}")
    if dev.type == "cuda":
        want_launches = {k: steps * per_step[1].get(k, 0) for k in launches}
        want_launches.update(dict.fromkeys(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), n_layers * steps))
        check(launches == want_launches,
              f"{path}: kernel launches {launches}, want {want_launches}")
    step_s = statistics.median(times)
    # FLOPs/token as bench.py:497-503 counts them (gathered MLM head)
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
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB, optimizer "
            f"state on the card {opt_bytes / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


def compare_in_turns(cfg, device, card, runs: dict, turns: int) -> None:
    """Phases 4-5 again, ``turns - 1`` more times, the order of the paths
    reversed each turn; then each path's step median in every turn."""
    steps = {path: [run["step_ms"]] for path, run in runs.items()}
    order = list(PATHS)
    for _ in range(turns - 1):
        order.reverse()
        for path in order:
            steps[path].append(train(cfg, device, card, path)["step_ms"])
    if device.type != "cuda":
        log(f"{turns} turns of the three paths rehearsed (no device times)")
        return
    for path, ms in steps.items():
        log(f"step median of {path} in {turns} turns: "
            + " ".join(f"{x:.2f}" for x in ms)
            + f" ms; median {statistics.median(ms):.2f} ms ({card})")


def compare_losses(runs: dict) -> None:
    """Every path's loss within 1e-2 relative of the phase-4 path's at
    every step: same weights, data and AdamW; bf16 compute and the
    embedding backward's atomics separate them."""
    base = runs["hooks"]["losses"]
    for path, run in runs.items():
        worst = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], base))
        log(f"losses of {path} vs hooks: largest relative difference "
            f"{worst:.3e} (limit 1e-2)")
        check(worst <= 1e-2, f"{path} losses differ from the hooks path's "
                             f"by {worst:.3e}")


# ---------------------------------------------------------------------------
# Phase 6: the Inception-V3 slice
# ---------------------------------------------------------------------------


def train_inception(cfg, device, card, profile=False) -> dict:
    """The bench's Inception row, eager, one process: ``hvd.init()``,
    ``InceptionV3(1000, bf16, seed=0)`` on ``hvd.device()``,
    ``broadcast_parameters(state_dict())``, ``DistributedOptimizer(SGD(0.01
    x size, momentum 0.9))``, the bench's images and labels (the same batch
    every step), 2 warm-up and 10 timed steps."""
    inc = cfg["inception"]
    batch, size = inc["batch"], inc["size"]
    rng = np.random.RandomState(0)  # bench.py:306-312
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, inc["classes"], (batch,)).astype(np.int32)

    cba.reset_launch_counts()
    collectives.COUNTS.update(dict.fromkeys(collectives.COUNTS, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = InceptionV3(num_classes=inc["classes"], dtype=inc["dtype"],
                        seed=0)
    check(next(model.parameters()).device == dev,
          "InceptionV3() without a device must take hvd.device()")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
    n_tensors = len(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    n_bn = sum(isinstance(m, cba.FusedBatchNormAct) for m in model.modules())
    n_broadcast = len(model.state_dict())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(x, y).item())  # waits for the step's last kernel
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = dict(cba.LAUNCHES)
    counts = dict(collectives.COUNTS)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    step_s = statistics.median(times)
    if profile:
        breakdown(lambda: step(x, y), dev, step_s, cfg["profile_steps"])
    del model, opt, step
    hvd.shutdown()
    free_memory(device)

    log(f"slice (Inception-V3): {n_bn} fused BN layers, {n_params:,} params "
        f"in {n_tensors} tensors, batch {batch} x {size}^2, "
        f"{cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{v:.4f}" for v in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    check(all(math.isfinite(v) for v in losses), "Inception: non-finite loss")
    check(losses[-1] < losses[0], f"Inception: loss did not fall: {losses}")
    want = {k: 0 for k in counts}
    want.update(allreduce=n_tensors * steps, broadcast=n_broadcast)
    check(counts == want, f"Inception: collectives {counts}, want {want}")
    if dev.type == "cuda":
        check(launches == {"sba": n_bn * steps},
              f"Inception: kernel launches {launches}, want "
              f"{n_bn * steps} sba")
        img_s = batch / step_s
        where = f"({card})"
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  images/s {img_s:.1f} {where}")
        log(f"  MFU {img_s * INCEPTION_FLOPS / PEAK_FLOPS:.4f} against 989 "
            f"TFLOP/s bf16, {INCEPTION_FLOPS / 1e9:.3f} GFLOP/image {where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


# ---------------------------------------------------------------------------
# Phase 7: the GPT-2-small slice, with each backward
# ---------------------------------------------------------------------------


def train_gpt(cfg, device, card, fused: bool, profile=False) -> dict:
    """The bench's GPT-2 row (``transformer_main("gpt2")``), eager, one
    process: ``hvd.init()``, ``GPT2Small`` from seed 0 on ``hvd.device()``,
    ``broadcast_parameters``, ``DistributedOptimizer(AdamW(1e-4,
    weight_decay=1e-4))``, the bench's tokens, the full-logits
    ``causal_lm_loss``, 2 warm-up and 10 timed steps. ``fused`` sets
    ``FLASH_FUSED_BWD=1`` for the run (unset otherwise)."""
    batch, seq = cfg["gpt_batch"], cfg["gpt_seq"]
    vocab = cfg["gpt"]["vocab_size"]
    tokens = np.random.RandomState(0).randint(  # bench.py:454-455
        0, vocab, (batch, seq)).astype(np.int32)
    if fused:
        os.environ[env.FLASH_FUSED_BWD] = "1"
    else:
        os.environ.pop(env.FLASH_FUSED_BWD, None)
    try:
        fa.reset_launch_counts()
        collectives.COUNTS.update(dict.fromkeys(collectives.COUNTS, 0))
        hvd.init(device=None if device.type == "cuda" else "cpu")
        dev = hvd.device()
        model = GPT2Small(**cfg["gpt"], device=dev, seed=0)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        params = dict(model.named_parameters())
        zero_grad, update, _ = make_step("hooks", model, params, dev)
        toks = torch.from_numpy(tokens).to(dev)
        n_tensors, n_broadcast = len(params), len(model.state_dict())
        n_params = sum(p.numel() for p in params.values())
        n_layers, d_model = len(model.layers), model.token_embed.shape[1]
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

        def step():
            zero_grad()
            loss = causal_lm_loss(model(toks), toks)
            loss.backward()
            update()
            return loss.detach()

        losses, times = [], []
        steps = cfg["warmup"] + cfg["steps"]
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(step().item())  # waits for the step's last kernel
            if i >= cfg["warmup"]:
                times.append(time.perf_counter() - t0)
        launches = dict(fa.LAUNCHES)
        counts = dict(collectives.COUNTS)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        step_s = statistics.median(times)
        if profile:
            breakdown(step, dev, step_s, cfg["profile_steps"])
        del model, params, update, zero_grad, step
        hvd.shutdown()
        free_memory(device)
    finally:
        os.environ.pop(env.FLASH_FUSED_BWD, None)

    bwd = "fused backward B7" if fused else "dq + dk/dv"
    log(f"slice (GPT-2, {bwd}): {n_layers} layers x {d_model}, "
        f"{n_params / 1e6:.1f}M params in {n_tensors} tensors, vocab {vocab},"
        f" batch {batch} x seq {seq}, {cfg['warmup']} warm-up + "
        f"{cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    check(all(math.isfinite(x) for x in losses), f"GPT-2 ({bwd}): non-finite "
                                                 f"loss")
    check(losses[-1] < losses[0], f"GPT-2 ({bwd}): loss did not fall: "
                                  f"{losses}")
    want = {k: 0 for k in counts}
    want.update(allreduce=n_tensors * steps, broadcast=n_broadcast)
    check(counts == want, f"GPT-2 ({bwd}): collectives {counts}, want {want}")
    if dev.type == "cuda":
        per_step = dict(flash_fwd=n_layers, flash_bwd_dq=0, flash_bwd_dkv=0,
                        flash_bwd_fused=0)
        per_step.update(dict(flash_bwd_fused=n_layers) if fused else
                        dict(flash_bwd_dq=n_layers, flash_bwd_dkv=n_layers))
        want_launches = {k: steps * n for k, n in per_step.items()}
        check(launches == want_launches,
              f"GPT-2 ({bwd}): kernel launches {launches}, want "
              f"{want_launches}")
        # FLOPs/token as bench.py:498-503 counts them: 6N + the causal half
        # of the attention term
        flops_per_token = 6 * n_params + 12 * n_layers * seq * d_model // 2
        tok_s = batch * seq / step_s
        where = f"({card})"
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  tokens/s {tok_s:.1f} {where}")
        log(f"  MFU {tok_s * flops_per_token / PEAK_FLOPS:.4f} against 989 "
            f"TFLOP/s bf16, {flops_per_token / 1e9:.3f} GFLOP/token {where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


def compare_gpt_runs(two: dict, fused: dict) -> None:
    """The two backwards on the same weights, data and AdamW: losses within
    1e-3 relative at every step, a tenth of one step's fall (bf16 compute;
    the fused kernel sums dq in another order than the dq kernel)."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(fused["losses"],
                                                    two["losses"]))
    log(f"GPT-2 losses, fused backward vs dq + dk/dv: largest relative "
        f"difference {worst:.3e} (limit 1e-3)")
    check(worst <= 1e-3, f"GPT-2 losses of the two backwards differ by "
                         f"{worst:.3e}")


GROUPS = (  # kernel-name fragments -> group, first match wins
    ("flash_", "attention kernels (port)"),
    ("sba_kernel", "BN + ReLU kernel B10 (port)"),
    ("fprop", "convolutions fprop (cuDNN)"),
    ("dgrad", "convolutions dgrad (cuDNN)"),
    ("wgrad", "convolutions wgrad (cuDNN)"),
    ("conv", "convolutions, other (cuDNN)"),
    ("adamw_kernel", "optimizer (port's AdamW kernels)"),
    ("nccl", "NCCL collectives"),
    ("gemm", "dense matmuls (cuBLAS)"), ("nvjet", "dense matmuls (cuBLAS)"),
    ("xmma", "dense matmuls (cuBLAS)"), ("cutlass", "dense matmuls (cuBLAS)"),
    ("multi_tensor_apply", "optimizer (foreach AdamW)"),
    ("layer_norm", "layernorm"), ("LayerNorm", "layernorm"),
    ("cat", "copies and casts"), ("copy", "copies and casts"),
    ("elementwise", "other element-wise"), ("reduce", "reductions"),
)


def breakdown(step, device, step_s: float, n: int) -> None:
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
    ap.add_argument("--turns", type=int, default=1,
                    help="run the three paths of phases 4-5 this many "
                         "times, in turns (a b c, c b a, a b c, ...), and "
                         "print each path's step medians: the host's "
                         "drift is shared by the paths")
    args = ap.parse_args()
    dry = args.cpu_dry
    if not dry and not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is false)",
              flush=True)
        return 1
    cfg = DRY if dry else FULL
    # phase 7 sets the fused backward's switch for its second run only
    os.environ.pop(env.FLASH_FUSED_BWD, None)
    device = torch.device("cpu" if dry else "cuda")
    if dry:
        # the tiny sizes gain nothing from more threads, and on a busy host
        # a full thread pool spins against the other processes' pools
        torch.set_num_threads(1)
    else:  # float32 references: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
    errs.update(check_optimizer_kernels(cfg, device))
    log("AdamW kernels bit-equal to their plain versions in every case")
    rows = {**timed["a"], **time_optimizers(cfg, device, cfg["opt_iters"])}
    fused_vs_zero(cfg, device)
    shapes = bn_shapes(cfg, device)
    errs["sba"] = check_sba(shapes, device)
    rows["sba"] = time_sba(shapes, device, cfg["sba_iters"])
    rows["conv_bn_stats"], errs["conv_bn_stats"], probe_launches = \
        run_probe(cfg, device)
    errs["flash_bwd_fused"] = max(check_fused(name, case, device)
                                  for name, case in cfg["fused_cases"].items())
    log(f"fused backward agrees with its plain version and with dq + dk/dv "
        f"in every case (limit: grads {TOL['grad']} relative)")
    fused_rows = {name: time_fused(name, cfg["fused_cases"][name], device,
                                   cfg["iters"])
                  for name in cfg["fused_timed"]}
    rows["flash_bwd_fused"] = fused_rows[cfg["fused_timed"][-1]]  # GPT-2's
    vrows, verrs, vprobe_launches = run_vprobe(cfg, device, cfg["iters"])
    rows.update(vrows)
    errs.update(verrs)
    tiny_model_check(cfg, device)
    tiny_inception_check(cfg, device)
    runs = {path: train(cfg, device, card, path, args.profile)
            for path in PATHS}
    compare_losses(runs)
    if args.turns > 1:
        compare_in_turns(cfg, device, card, runs, args.turns)
    inception = train_inception(cfg, device, card, args.profile)
    gpt = {fused: train_gpt(cfg, device, card, fused, args.profile)
           for fused in (False, True)}
    compare_gpt_runs(gpt[False], gpt[True])
    if dry:
        log("DRY RUN complete: control flow rehearsed; no result line")
        return 0

    # each kernel's launches are counted on the path that runs it
    launches = {**runs["hooks"]["launches"],
                "adamw_multi": runs["fused"]["launches"]["adamw_multi"],
                "flat_adamw": runs["zero"]["launches"]["flat_adamw"],
                "sba": inception["launches"]["sba"],
                "conv_bn_stats": probe_launches,
                "flash_bwd_fused": gpt[True]["launches"]["flash_bwd_fused"],
                **vprobe_launches}
    kernels = [dict(name=name, route="cuda", source=KERNELS[name][0],
                    replaces=KERNELS[name][1], launches=launches[name],
                    max_abs_err=errs[name], ms=rows[name]["ms"],
                    plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"],
                    library_ms=rows[name]["library_ms"])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
