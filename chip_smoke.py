#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py             # on a machine with a CUDA device
    python3 chip_smoke.py --cpu-dry   # rehearsal: CPU, plain versions, tiny

Phases (any failure exits non-zero):

1. Environment: the card's name and power limit, CUDA and nvcc versions;
   build the kernels from ``horovod_tpu_torch/csrc`` (flash_attention.cu,
   adamw.cu, conv_bn_act.cu, conv_bn_stats.cu and attention_probe.cu: one
   nvcc per source, started together) and print what ptxas reports
   (registers, spills). The witness that the kernels are the Hopper
   design: ``cuobjdump -sass`` of the flash_attention, attention_probe and
   conv_bn_stats libraries must show HGMMA (wgmma), UTMALDG (TMA loads)
   and SYNCS (mbarriers) instructions in every instance, D64 and D128, of
   flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
   flash_bwd_fused_kernel and probe_fwd_kernel, and in both N-tile
   instances (64, 128) of conv3x3_stats_kernel; that of the adamw library
   UBLKCP (1-D bulk copies) and SYNCS in every instance of
   flat_adamw_kernel (f32 and bf16 gradients); and ptxas must report no
   wgmma serialised.
2. Flash-attention kernels against their plain PyTorch versions, in bf16 on
   the card, with the plain version run on float32 copies of the same bf16
   inputs: (a) B8 H16 S512 D64 (BERT-Large), (b) B16 H12 S1024 D64 causal
   (GPT-2), (c) B1 H4 S2048 D128 causal, (d) ring offsets (all keys in the
   past; rows with every key masked, whose dq must be exactly 0), (e) D128
   causal with Sq 700 != Sk 1000 and q_offset 300. Limits: o 2e-2 abs, lse
   2e-3 abs, dq/dk/dv 2e-2 relative to their norm. Then each kernel, its
   plain version and a yardstick the port never calls
   (``scaled_dot_product_attention``'s forward; aten's flash attention
   backward, one call for dq, dk and dv, beside dq + dk/dv) are timed at
   (a), (b) and (c), beside their bounds. Every time in
   the script is ``utils.measure.time_ms``: CUDA events around a replay of
   a CUDA graph of back-to-back calls, so no host time between launches
   enters a kernel's reading, the yardsticks' or the plain versions'.
2b. The AdamW kernels against their plain versions on the card, on copies
   of the same inputs with the same float32 scalars, for 3 steps: the
   multi-tensor kernel over BERT-Large's 388 parameter shapes and over a
   mixed set (a bf16 parameter with f32 moments, 7 elements, 131 x 128);
   the flat ZeRO kernel over BERT-Large's world-1 shard (536,870,912
   elements, the bucket pad included), over ragged lengths (1, 3, 127,
   16,385), the edges of its ring's tiles (a tile minus 4, a tile, a tile
   plus 4, five tiles plus 3) and a shard 16 bytes off a tile's boundary,
   each with every pair of f32 and bf16 gradient and output, and over each
   group shard length of P4's and P5's bucket layout (the most common in
   every pair). Limit: bit-equal
   (both round after every float32 operation; adamw.cu is built with
   -fmad=false); for f32 output the parameters returned must be master's
   storage, for bf16 a tensor of their own. Then each is timed at
   BERT-Large's shapes beside its bound (the flat kernel's at 28 bytes an
   element: its f32 parameters are its master),
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
   have launched 24 times per step and the hooks requested one allreduce
   per parameter per step. Every collective goes through the enqueue
   runtime (``runtime/``); what it issued each step is printed from
   ``runtime.COUNTS`` (allreduce calls, responses, response-cache hits,
   fusion slabs, process groups, cycle host ms), here and in phases 5-7.
   The runtime must issue fewer than a quarter of the 388 allreduces a step
   after the first (fused bins), answer all 388 from its response cache
   from the second step on, and create no slab or group after warm-up.
4b. The hooks path again at ``HOROVOD_FUSION_THRESHOLD=0`` (one allreduce a
   tensor: 388 a step), in turns with phase 4 (fused, 0, 0, fused). At
   world 1 each reduction is the identity, so every run's losses must
   equal phase 4's, bit for bit unless a library kernel is
   nondeterministic, within 1e-5 relative; both step times are printed
   beside the card's name and power limit.
4c. The hooks path on each cycle engine, in turns: ``HOROVOD_NATIVE_CYCLE``
   1, 0, 0, 1 (the C++ response cache and bin-packer of ``cpp/cycle.cc``,
   then the Python ones), 2 warm-up and 3 timed steps each, then once
   each at ``HOROVOD_FUSION_THRESHOLD=0``. Every run's losses bit-equal
   to the first's; cache hits, slabs and groups a step equal in every run,
   and at threshold 0 allreduce calls and responses too (fused bins follow
   when autograd's hooks fire, so their count varies from step to step);
   the native runs' cache a ``NativeResponseCache`` and their bins from the
   native bin-packer, the Python runs' neither; ``hvd.metrics()`` moved by
   what ``COUNTS`` shows (cycles equal, cache-hit lookups twice the hits);
   each run's step ms and cycle host ms a step beside the card's name and
   power limit. Then two steps with ``HOROVOD_TIMELINE``,
   ``HOROVOD_TIMELINE_MARK_CYCLES=1`` and ``HOROVOD_METRICS_PORT=0``: the
   trace parses and holds ``CYCLE_<n>`` markers, ``"C"`` counter events,
   ``NCCL_ALLREDUCE`` activities and its drop count; ``GET /metrics``
   serves the cycle, cache and fusion families.
5. The optimizer paths, each on the same model, data and steps as phase 4:
   (P1) ``allreduce_gradients`` then ``fused_adamw(1e-4).apply`` (the
   multi-tensor kernel once a step, 388 allreduces a step); (P2) ZeRO-1
   ``sharded_adamw(1e-4).apply`` (one reduce-scatter, one flat-kernel launch
   and one allgather per dtype group a step, no allreduce); (P3)
   ``DistributedOptimizer(AdamW, shard_optimizer_states=True)``, torch's
   AdamW over the flat shard (no kernel of the port); (P4) ZeRO-2: a
   ``GradReleasePlan(reduce_scatter=True)`` of 4 MiB buckets releasing
   during the backward and ``sharded_adamw(1e-4, partition=
   plan.zero_partition(params))`` through ``make_train_step`` (one
   reduce-scatter, one flat-kernel launch and one allgather a bucket
   group a step); (P5) ZeRO-3: the same plan and layout, the parameters
   sharded at rest (``shard_params``) and copied into the model group by
   group from ``iter_param_buckets`` before each forward, ``apply``
   returning ``ShardedParams``. Losses finite and falling, and within 1e-2
   relative of phase 4's at every step; P4's and P5's within 1e-5 of
   P2's. On the ZeRO paths (P2-P5) every collective after the first step
   comes from the response cache, and no slab or group appears after
   warm-up. Each prints B8's launches a step, the bytes held for
   optimizer state and gradient and parameter shards, peak memory, and
   P5 the stage-3 gather's hidden share.
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
8. The ResNet-50 slice (``bench.py:85, 258-300``): ``hvd.init()``,
   ``ResNet50(1000, bf16, seed=0)`` (NHWC, f32 parameters and batch
   statistics, the space-to-depth stem), ``broadcast_parameters``,
   ``DistributedOptimizer(SGD(0.01, momentum 0.9))`` through the hooks and
   the runtime, the bench's images (128 x 224 x 224 x 3) and labels, 2
   warm-up and 10 timed steps. Losses finite and falling; 161 gradients a
   step, all from the response cache from the second step, fewer than 161
   fused calls a step, no slab or group after warm-up; no kernel of the
   port (the 33 norm + ReLU pairs run plain: faster than B10 in one timing
   of the step, ``tools/resnet_bn_choice.py``); images/s, MFU at 3 x 8.234
   GFLOP an image, step ms and peak memory beside the card's name and
   power limit.
9. The rest of the collectives at world 1 through the runtime (NCCL on the
   card): allgather, alltoall, a differentiable allreduce and its
   backward, an int64 allreduce past 2**40, a sparse allreduce and
   ``broadcast_object``, each exact.
10. The training API (no kernel of its own). 10a: phase 8's ResNet-50,
   data and optimizer through ``create_train_state`` and
   ``make_train_round(steps=3)``, one warm-up and 3 timed rounds, each
   inside ``hvd.profiler.step`` with ``HOROVOD_PROFILE=1`` and
   ``set_flops_per_step(128 x 3 x 3 x 8.234e9, 989e12)``: every step's
   loss finite, falling and within 1e-5 (first step) and 1e-2 (every
   step; cuDNN's bf16 backward need not be deterministic) relative of
   phase 8's; one record a round; each record's four phases summing to
   its wall; dispatches and MFU above 0; each round's step_breakdown,
   comm_hidden_fraction, MFU and peak_hbm_bytes printed. 10b: the same
   rounds at ``HOROVOD_PROFILE`` 0, 1, 1, 0, ms a step each. 10c:
   BERT-Large on phase 4's hooks path (2 warm-up, 3 timed steps) with
   ``HOROVOD_PROFILE_DIR`` and ``HOROVOD_PROFILE_JAX``: one record a step
   from the optimizer's own boundary, the optimizer phase above 0, the
   phases summing to the wall; ``shutdown()``'s dump parses and
   ``merge_profile_dir`` gives a trace with the step markers and the
   ``torch.profiler`` device lane's kernels. 10d: the rounds at
   ``HOROVOD_INTEGRITY`` 1, 0, 0, 1 with no healthy step skipped, the
   guard's norm timed alone, then one ``DistributedOptimizer`` step with
   one NaN written into one gradient by a gradient hook: skipped, the
   parameters and SGD momentum bit-equal, the skipped-steps counter moved
   by 1. 10e: the three examples (``horovod_tpu_torch/examples``), each
   a process at world 1 on the card: ``synthetic_benchmark`` with and
   without ``--fp16-allreduce``, ``mnist`` for 1 epoch,
   ``bert_large_sparse`` at full width (tokens/s and "lockstep OK").

Between them: 2d. kernel B10 (fused BN + ReLU) bit-equal to its plain
version at every distinct BN input of Inception-V3 at batch 32 (bf16),
three of them in f32, ragged C (3, 7, 1000) and 5 elements; then timed
over one forward's 94 calls. 2e. kernel
B11 (3x3 conv + BN statistics) through
``horovod_tpu_torch.tools.conv_bn_probe`` at its four ResNet-50 shapes
(batch 128; 14 x 14 x 256 is the tool's own), within the tool's limits of
its plain version and a second call bit-equal to the first, timed beside
its bound, cuDNN's conv alone and conv plus a stats pass. 3b. a small Inception-V3 (8 x 128 x 128, f32) on the card
against the CPU (eval mode: logits and loss 1e-3, gradient 1e-2; train
mode: twice what one ulp of input moves the CPU's own result), the ReLU
mask elements that differ counted; each mixed block alone in train mode
at 1e-3. 2f. the fused backward B7 against its plain version and against
the dq and dk/dv kernels at (a), (b), a D128 causal case with q_offset !=
k_offset and Sq != Sk, and (d_masked): dq/dk/dv within 2e-2 relative, dq
exactly 0 on fully masked rows, a second call bit-equal to the first; then
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
the multi-tensor AdamW on P1, the flat AdamW on P2, P4 and P5, B10 on phase 6, B11 on
the probe's phase 2e, B7 on phase 7's fused run, B12-B14 on the probe's
phase 2g), the card's name and power limit, and ``{"ok": true,
"device": {...}}``. ``--cpu-dry`` runs the
same code on the CPU at tiny sizes and prints neither JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core import state as state_mod
from horovod_tpu_torch.metrics import flatten_snapshot
from horovod_tpu_torch.metrics import registry as metrics_registry
from horovod_tpu_torch.models import inception as inc
from horovod_tpu_torch.models.inception import InceptionV3
from horovod_tpu_torch.models.resnet import BatchNormReLU, ResNet50
from horovod_tpu_torch.models.transformer import (BertLarge, GPT2Small,
                                                  Transformer, causal_lm_loss,
                                                  masked_lm_loss_gathered,
                                                  sample_masked_positions)
from horovod_tpu_torch.ops import collectives, kernel_build
from horovod_tpu_torch.ops import conv_bn_act as cba
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import fused_adamw as fadam
from horovod_tpu_torch.ops import fused_optimizer as fopt
from horovod_tpu_torch.parallel import zero as zero_mod
from horovod_tpu_torch.parallel.zero import LeafMeta, build_spec, dtype_name
from horovod_tpu_torch.runtime import fusion as fusion_mod
from horovod_tpu_torch.runtime import runtime as hrt
from horovod_tpu_torch.tools import conv_bn_probe as probe
from horovod_tpu_torch.tools import flash_vpu_probe as vprobe
from horovod_tpu_torch.training import make_train_step
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils.measure import card_line, time_ms

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
# ResNet-50 as the bench runs it (bench.py:85, 258-300): 8.234 GFLOP per
# image forward at 224 x 224, a train step 3x that
RESNET_FLOPS = 3 * 8.234e9
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
           "d_masked": (2, 4, 512, 64, True, 64, 200),
           # (B, H, Sq, Sk, D, causal, q_offset, k_offset): neither extent
           # a multiple of 128
           "e_d128": (2, 4, 700, 1000, 128, True, 300, 0)},
    timed=("a", "b", "c"), iters=50,
    tiny=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
              d_ff=512, max_seq=128), tiny_batch=2,
    model=dict(vocab_size=30522, max_seq=512), batch=8, seq=512,
    warmup=2, steps=10, opt_iters=20, engine_steps=(2, 3),
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
    gpt=dict(vocab_size=50257), gpt_batch=16, gpt_seq=1024,
    resnet=dict(batch=128, size=224, classes=1000, dtype=BF16),
    round_steps=3, api_rounds=3)
DRY = dict(
    cases={"a": (1, 2, 64, 64, False, 0, 0), "b": (1, 2, 96, 64, True, 0, 0),
           "d_masked": (1, 2, 64, 64, True, 8, 40),
           "e_d128": (1, 2, 40, 96, 128, True, 30, 0)},
    timed=("a",), iters=2,
    tiny=dict(vocab_size=64, d_model=128, num_layers=1, num_heads=2,
              d_ff=256, max_seq=32), tiny_batch=2,
    model=dict(vocab_size=1000, max_seq=64, num_layers=1), batch=2, seq=64,
    warmup=1, steps=2, opt_iters=2, engine_steps=(1, 1),
    inception=dict(batch=2, size=75, classes=10, dtype=F32), sba_iters=1,
    tiny_inception=(2, 75), block_input=(2, 5),
    probe_shapes=((2, 6, 32),), probe_iters=1, profile_steps=1,
    fused_cases={"a": (1, 2, 64, 64, 64, False, 0, 0),
                 "e_d128": (1, 2, 40, 96, 128, True, 30, 0),
                 "d_masked": (1, 2, 64, 64, 64, True, 8, 40)},
    fused_timed=("a",), vprobe_case=(1, 2, 96, 64),
    gpt=dict(vocab_size=512, d_model=128, num_layers=2, num_heads=2,
             d_ff=256, max_seq=64), gpt_batch=2, gpt_seq=64,
    resnet=dict(batch=2, size=32, classes=10, dtype=F32),
    round_steps=1, api_rounds=2)


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
    """The kernel of a ptxas or cuobjdump line, template arguments
    demangled (the names nest in an anonymous namespace):
    .._ZN<namespace>16flash_fwd_kernelILi64EEEv.. -> flash_fwd_kernel<64>,
    ..16probe_fwd_kernelILi128ELi64ELb0EEEv.. ->
    probe_fwd_kernel<128,64,false>,
    ..17flat_adamw_kernelI13__nv_bfloat16fEEv.. ->
    flat_adamw_kernel<bf16,f32>,
    ..adamw_multi_kernelI13__nv_bfloat16S1_ffEEv.. -> <bf16,bf16,f32,f32>."""
    m = re.search(r"_Z(N?)(\w+)", line)
    if not m:
        return line.strip()
    mangled, name = m.group(2), ""
    while mangled[:1].isdigit():  # <length><name>, the last one the kernel
        digits = re.match(r"\d+", mangled).group(0)
        end = len(digits) + int(digits)
        name, mangled = mangled[len(digits):end], mangled[end:]
        if not m.group(1):
            break
    t = re.match(r"I(.*?)Ev", mangled)
    if not t:
        return name
    # a repeated bf16 is mangled as a back-reference, S<n>_
    names = {"f": "f32", "Lb0E": "false", "Lb1E": "true"}
    args = [a.group(1) or names.get(a.group(0), "bf16") for a in re.finditer(
        r"Li(\d+)E|Lb[01]E|13__nv_bfloat16|S\d*_|f", t.group(1))]
    return f"{name}<{','.join(args)}>"


HEAD_DIMS = ("64", "128")
#: the SASS instructions that show a wgmma kernel: HGMMA (wgmma), UTMALDG
#: (TMA loads; the conv kernel's are its weights'), SYNCS (mbarriers)
WGMMA_OPS = ("HGMMA", "UTMALDG", "SYNCS")
#: the kernels built on Hopper's asynchronous copies, by library: each with
#: the first template arguments its instances must cover and the SASS
#: instructions every instance must hold. A D64 and a D128 instance of
#: every attention kernel; the conv kernel's instances are its N tiles of
#: 64 and 128 output channels; the flat AdamW kernel's its gradient dtypes,
#: whose ring of 1-D bulk copies (cp.async.bulk, UBLKCP) completes on
#: mbarriers (SYNCS)
HOPPER_KERNELS = {
    "flash_attention": dict.fromkeys(
        ["flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
         "flash_bwd_fused_kernel"], (HEAD_DIMS, WGMMA_OPS)),
    "attention_probe": {"probe_fwd_kernel": (HEAD_DIMS, WGMMA_OPS)},
    "conv_bn_stats": {"conv3x3_stats_kernel": (("64", "128"), WGMMA_OPS)},
    "adamw": {"flat_adamw_kernel": (("f32", "bf16"), ("UBLKCP", "SYNCS"))}}
SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "SYNCS")


def sass_counts(name: str) -> dict:
    """{kernel: {op: count}} over the SASS of the built library ``name``
    (``cuobjdump -sass``), for the ops of :data:`SASS_OPS`."""
    tool = os.path.join(os.path.dirname(kernel_build.nvcc()), "cuobjdump")
    lib = str(kernel_build.library_path(name))
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    op = re.compile(r"\s(" + "|".join(SASS_OPS) + r")[.\s]")
    for line in sass.splitlines():
        if "Function :" in line:
            fn = kernel_name(line)
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn and (m := op.search(line)):
            counts[fn][m.group(1)] += 1
    return counts


def hopper_witness() -> None:
    """The Hopper kernels reached the card as designed: every instance of
    each kernel of :data:`HOPPER_KERNELS`, the instances it names at
    least, holds the SASS instructions it names, and ptxas serialised no
    wgmma (its ``Potential Performance Loss`` warning)."""
    for lib, kernels in HOPPER_KERNELS.items():
        serial = [line.strip() for line in
                  kernel_build.build_log(lib).splitlines()
                  if "wgmma" in line and "serialized" in line]
        for line in serial:
            log(f"  ptxas {lib}: {line}")
        check(not serial, f"ptxas serialised wgmma in {lib}")
        counts = sass_counts(lib)
        for kernel, (wanted, ops) in kernels.items():
            found = {fn: c for fn, c in counts.items()
                     if fn.startswith(kernel + "<")}
            firsts = {fn[len(kernel) + 1:].split(",")[0].rstrip(">")
                      for fn in found}
            check(set(wanted) <= firsts,
                  f"{kernel} in the SASS of {lib} lacks an instance of "
                  f"{wanted}: {sorted(found)}")
            for fn, c in sorted(found.items()):
                log(f"  SASS {fn}: " + ", ".join(f"{c[op]} {op}"
                                                 for op in ops))
                check(all(c[op] for op in ops), f"{fn} lacks one of {ops}: "
                                                f"{c}")


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
    hopper_witness()
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


def extents(case) -> tuple:
    """(B, H, Sq, Sk, D, causal, q_offset, k_offset) of a flash case, given
    as that or as (B, H, S, D, causal, q_offset, k_offset) with Sq = Sk."""
    if len(case) == 8:
        return tuple(case)
    b, h, s, *rest = case
    return (b, h, s, s, *rest)


def bounds(case) -> dict:
    """Each flash kernel's :func:`roofline` at a case."""
    b, h, sq, sk, d, causal, q_off, k_off = extents(case)
    bh, pairs = b * h, unmasked_pairs(sq, sk, causal, q_off, k_off)
    q_mat, k_mat = 2 * bh * sq * d, 2 * bh * sk * d  # bf16 (B, H, S, D)
    row = 4 * bh * sq     # bytes of one (B, H, Sq) f32 row vector
    work = {"flash_fwd": (4 * bh * pairs * d,  # q k v o, lse
                          2 * q_mat + 2 * k_mat + row),
            "flash_bwd_dq": (6 * bh * pairs * d,  # q k v do lse delta, dq
                             3 * q_mat + 2 * k_mat + 2 * row),
            "flash_bwd_dkv": (8 * bh * pairs * d,  # q k v do lse delta, dk dv
                              2 * q_mat + 4 * k_mat + 2 * row)}
    return {name: roofline(*w) for name, w in work.items()}


def make_inputs(case, device, seed):
    """q, k, v, do in bf16: (B, H, Sq, D), (B, H, Sk, D) twice, (B, H, Sq,
    D)."""
    b, h, sq, sk, d = extents(case)[:5]
    g = torch.Generator(device).manual_seed(seed)
    dtype = torch.bfloat16
    return [torch.randn(b, h, n, d, generator=g, device=device).to(dtype)
            for n in (sq, sk, sk, sq)]


def kwargs(case):
    b, h, sq, sk, d, causal, q_off, k_off = extents(case)
    return dict(causal=causal, sm_scale=d ** -0.5, q_offset=q_off,
                k_offset=k_off)


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
    b, h, sq, sk, d, causal, q_off, k_off = extents(case)
    log(f"case {name} B{b} H{h} Sq{sq} Sk{sk} D{d} "
        f"causal={causal} q_offset={q_off} k_offset={k_off}: "
        f"max|o-ref| {err['o']:.3e}  max|lse-ref| {err['lse']:.3e}  "
        f"rel dq {err['dq']:.3e} dk {err['dk']:.3e} dv {err['dv']:.3e}  "
        f"fully masked rows {masked}")
    check(torch.equal(torch.isfinite(lse), live),
          f"case {name}: lse is -inf on other rows than the plain version's")
    check(bool((o[~live] == 0).all()) and bool((lse[~live] == -math.inf).all()),
          f"case {name}: fully masked rows must give o 0 and lse -inf")
    check(bool((dq[~live] == 0).all()),
          f"case {name}: fully masked rows must give dq exactly 0")
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
        rows[kname] = dict(ms=time_ms(kernel, iters, device),
                           plain_ms=time_ms(plain, iters, device),
                           **bnd[kname])
    # yardstick only: PyTorch's fused attention, which the port never calls
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def sdpa_fwd():
        return sdpa(q, k, v, is_causal=kw["causal"], scale=kw["sm_scale"])

    lib_fwd = time_ms(sdpa_fwd, iters, device)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def fwd_bwd():
        sdpa(qg, kg, vg, is_causal=kw["causal"], scale=kw["sm_scale"]) \
            .backward(do)

    lib_fb = time_ms(fwd_bwd, iters, device)
    rows["flash_fwd"]["library_ms"] = lib_fwd
    # aten's flash attention backward computes dq, dk and dv in one call:
    # the pair's yardstick, so each of the two rows carries it
    aten = aten_flash_backward(q, k, v, do, kw)
    lib_bwd = time_ms(aten, iters, device) if aten else None
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        rows[kname]["library_ms"] = lib_bwd
    b, h, sq, sk, d, causal = extents(case)[:6]
    log(f"timing case {name} B{b} H{h} Sq{sq} Sk{sk} D{d} causal={causal} "
        f"({iters} calls each in a CUDA graph):")
    for kname, r in rows.items():
        log(f"  {kname:14s} kernel {r['ms']:.4f} ms  plain "
            f"{r['plain_ms']:.4f} ms  bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB)  "
            f"share of bound {r['bound_ms'] / r['ms']:.3f}")
    back = rows["flash_bwd_dq"]["ms"] + rows["flash_bwd_dkv"]["ms"]
    log(f"  yardstick scaled_dot_product_attention: forward {lib_fwd:.4f} ms, "
        f"forward+backward {lib_fb:.4f} ms (port: forward "
        f"{rows['flash_fwd']['ms']:.4f} ms, "
        f"{rows['flash_fwd']['ms'] / lib_fwd:.2f}x SDPA's)")
    if lib_bwd is None:
        log(f"  dq+dk/dv {back:.4f} ms; aten flash backward not timed (no "
            f"such kernel on the CPU)")
    else:
        log(f"  yardstick aten flash backward (dq, dk and dv in one call): "
            f"{lib_bwd:.4f} ms; port dq+dk/dv {back:.4f} ms, "
            f"{back / lib_bwd:.2f}x aten's")
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


def flat_inputs(n, n_real, grad_dtype, device, seed, offset=0) -> list:
    """master, mu, nu (f32) and grad: random over the first ``n_real``
    elements, zeros over the bucket pad, as ZeRO lays a shard out. With
    ``offset``, each is a view ``offset`` * 16 bytes into a larger buffer
    (a shard that starts off any tile's boundary)."""
    out = []
    for dt in (F32, F32, F32, grad_dtype):
        skip = offset * 16 // torch.tensor([], dtype=dt).element_size()
        out.append(torch.zeros(skip + n, dtype=dt, device=device)[skip:])
    leaf = adam_leaves([(n_real,)], [(F32, F32, F32, F32)], device, seed)[0]
    for dst, src in zip(out, leaf):
        dst[:n_real] = src
    return out


def check_flat_adamw(name, n, n_real, grad_dtype, out_dtype, device,
                     steps=3, offset=0) -> float:
    """The flat kernel over one shard against the plain version on copies,
    ``steps`` steps; bit-equal. For float32 out the parameters it returns
    are master's storage; for bfloat16 a tensor of their own."""
    master, mu, nu, grad = flat_inputs(n, n_real, grad_dtype, device,
                                       seed=len(name) + n % 97,
                                       offset=offset)
    ref = [t.clone() for t in (master, mu, nu)]
    worst, differ = 0.0, 0
    for t in range(1, steps + 1):
        sc = fadam.adamw_scalars(t, **ADAMW)
        p, *_ = fopt.flat_adamw_shard(master, mu, nu, grad, sc, eps=EPS,
                                      out_dtype=out_dtype)
        check((p.data_ptr() == master.data_ptr()) == (out_dtype == F32),
              f"flat_adamw {name}: p {'is not' if out_dtype == F32 else 'is'}"
              f" master's storage (out {dtype_name(out_dtype)})")
        want = fopt.flat_adamw_reference(*ref, grad, sc, EPS, out_dtype)
        ref = list(want[1:])
        for a, b in zip((p, master, mu, nu), want):
            err, n_diff = mismatch(a, b)
            worst, differ = max(worst, err), differ + n_diff
        del want
    where = f", {offset * 16} bytes into its buffer" if offset else ""
    log(f"flat_adamw {name}: {n:,} elements ({n_real:,} real{where}), grad "
        f"{dtype_name(grad_dtype)}, out {dtype_name(out_dtype)}, {steps} "
        f"steps: max|kernel-plain| {worst:.3e}, {differ} elements differ; "
        f"p {'is' if out_dtype == F32 else 'is not'} master's storage")
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
    pairs = ((F32, F32), (BF16, BF16), (F32, BF16), (BF16, F32))
    errs["flat_adamw"] = 0.0
    for gd, od in pairs:  # every (grad, out) dtype pair at full size
        errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
            "world-1 shard", n_shard, n_real, gd, od, device))
        free_memory(device)
    # the ring's edges: whole tiles through the ring, the rest by plain
    # loads; a shard under one tile, under 4 elements, and off a tile's
    # boundary by 16 bytes
    tile = fopt.tile_elems() if device.type == "cuda" else 64
    edges = [("ragged", n, 0) for n in (1, 3, 127, 16385)]
    edges += [("tile edge", n, 0) for n in (tile - 4, tile, tile + 4,
                                             5 * tile + 3)]
    edges += [("offset", 3 * tile + 8, 1)]
    for what, n, offset in edges:
        for gd, od in pairs:
            errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
                what, n, n, gd, od, device, offset=offset))
    # the group shards P4 and P5 give it: one a distinct length of the
    # reduce-scatter plan's bucket layout at world 1, the most common one
    # in every dtype pair
    groups = bucket_spec(shapes).groups
    sizes = {g.shard_elems: g.n for g in groups}
    common = statistics.mode(g.shard_elems for g in groups)
    for n, real in sorted(sizes.items()):
        for gd, od in (pairs if n == common else pairs[:1]):
            errs["flat_adamw"] = max(errs["flat_adamw"], check_flat_adamw(
                "bucket group", n, real, gd, od, device))
        free_memory(device)
    return errs


def bucket_spec(shapes):
    """The world-1 layout of P4 and P5: one f32 group a bucket of the
    reduce-scatter plan (4 MiB buckets)."""
    metas = [LeafMeta(s, F32) for s in shapes]
    plan = hvd.GradReleasePlan(reduce_scatter=True)
    return build_spec(metas, 1, 0, 64 * 1024,
                      partition=plan.zero_partition(metas))


#: bytes a float32 group's element moves through B8: master, mu, nu and
#: grad read, master, mu and nu written (its parameters are its master)
FLAT_F32_BYTES = 28


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
    # on the card the timer replays the step in a CUDA graph
    hyper["capturable"] = device.type == "cuda"
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
        elems=n, tensors=1, **adamw_bound(n, FLAT_F32_BYTES * n))
    del master, mu, nu, grad, fused
    free_memory(device)
    rows["flat_adamw_bucket"], groups_ms = time_bucket_adamw(
        shapes, hyper, sc, device, iters)
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
    log(f"  flat_adamw over all {groups_ms['groups']} bucket groups of a "
        f"P4/P5 step ({groups_ms['elems']:,} elements): "
        f"{groups_ms['graph_ms']:.4f} ms as one CUDA graph, "
        f"{groups_ms['eager_ms']:.4f} ms launched eagerly (host clock, "
        f"synchronized), bound {groups_ms['bound_ms']:.4f} ms")
    return rows


def time_bucket_adamw(shapes, hyper, sc, device, iters) -> tuple:
    """B8 as P4 and P5 run it at world 1: one launch a group of the
    reduce-scatter plan's 4 MiB buckets. Times one launch at the most
    common group shard beside its bound, plain version and torch's fused
    AdamW, then one step's launches over every group: replayed as a CUDA
    graph, and eagerly with their host cost."""
    spec = bucket_spec(shapes)
    sizes = [g.shard_elems for g in spec.groups]
    n = statistics.mode(sizes)
    real = next(g.n for g in spec.groups if g.shard_elems == n)
    master, mu, nu, grad = flat_inputs(n, real, F32, device, seed=10)
    master.grad = grad
    fused = torch.optim.AdamW([master], fused=True, **hyper)
    row = dict(
        ms=time_ms(lambda: fopt.flat_adamw_shard(master, mu, nu, grad, sc,
                                                 eps=EPS, out_dtype=F32),
                   iters, device),
        plain_ms=time_ms(lambda: fopt.flat_adamw_reference(
            master, mu, nu, grad, sc, EPS, F32), iters, device),
        library_ms=time_ms(fused.step, iters, device),
        elems=n, tensors=1, **adamw_bound(n, FLAT_F32_BYTES * n))
    del master, mu, nu, grad, fused
    bufs = [flat_inputs(g.shard_elems, g.n, F32, device, seed=gi)
            for gi, g in enumerate(spec.groups)]

    def every_group():
        for b in bufs:
            fopt.flat_adamw_shard(*b, sc, eps=EPS, out_dtype=F32)

    total = sum(sizes)
    groups_ms = dict(groups=len(sizes), elems=total,
                     graph_ms=time_ms(every_group, max(1, iters // 4),
                                      device),
                     **adamw_bound(total, FLAT_F32_BYTES * total))
    every_group()
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        every_group()
    if device.type == "cuda":
        torch.cuda.synchronize()
    groups_ms["eager_ms"] = 1e3 * (time.perf_counter() - t0) / 3
    del bufs
    free_memory(device)
    return row, groups_ms


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
    (each shape as often as the model calls it), beside the bound (each
    call reads and writes its bf16 activation once and reads s and b, 8 C
    bytes, at 3.35 TB/s)."""
    inputs = {s: sba_inputs(s, BF16, device, seed=0) for s in set(shapes)}

    def forward(fn):
        return lambda: [fn(*inputs[s]) for s in shapes]

    row = dict(ms=time_ms(forward(cba.sba), repeats, device),
               plain_ms=time_ms(forward(cba.sba_plain), repeats, device),
               bound_ms=sum(1e3 * (4 * math.prod(s) + 8 * s[1]) / PEAK_BYTES
                            for s in shapes),
               bound_by="bytes", library_ms=None)  # no single torch call
    log(f"timing sba over one Inception-V3 forward ({len(shapes)} calls, "
        f"{len(inputs)} shapes, {repeats} repeats): kernel {row['ms']:.4f} ms"
        f"  plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f}"
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
            f"rel+abs, sum 1e-2 rel + 2.0, sumsq 1e-2 rel); a second call "
            f"bit-equal: {e['repeat_equal']}")
        check(e["ok"], f"conv_bn_stats {r['shape']}: outside the limits")
        check(e["repeat_equal"], f"conv_bn_stats {r['shape']}: a second "
                                 f"call gave other bits")
        if device.type == "cuda":
            log(f"  kernel {r['ms']:.4f} ms (MFU {r['mfu']:.4f}, share of "
                f"bound {r['bound_ms'] / r['ms']:.3f})  plain "
                f"{r['plain_ms']:.4f} ms  cuDNN conv alone {r['conv_ms']:.4f}"
                f" ms (MFU {r['conv_mfu']:.4f}; kernel "
                f"{r['ms'] / r['conv_ms']:.2f}x)  conv + stats pass "
                f"{r['conv_stats_ms']:.4f} ms (kernel "
                f"{r['ms'] / r['conv_stats_ms']:.2f}x)  bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
                f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB)")
        rows.append(r)
    tool = next((r for r in rows if r["shape"].startswith(
        f"{probe.BATCH}x{probe.SIZE}x")), rows[0])
    return dict(tool, library_ms=tool["conv_ms"]), worst, \
        probe.LAUNCHES["conv_bn_stats"]


# ---------------------------------------------------------------------------
# Phase 2f: the fused backward B7 against its plain version and dq + dk/dv
# ---------------------------------------------------------------------------


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
    on the same inputs: dq, dk, dv within 2e-2 relative to their norm, dq
    exactly 0 on fully masked rows, and a second call bit-equal to the
    first. Returns the largest absolute error against the plain version."""
    q, k, v, do = make_inputs(case, device, seed=len(name) + 10)
    kw = kwargs(case)
    o, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa.compute_delta(o, do)
    got = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    again = fa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    two = (fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    if device.type == "cuda":
        torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
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
        + f"; fully masked rows {int(masked.sum())}; a second call "
        f"bit-equal: {same}")
    check(same, f"fused case {name}: a second call gave other bits")
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
    """B7 timed beside its bound, its plain version, the
    dq and dk/dv kernels (one call of each, summed) and PyTorch's flash
    attention backward."""
    q, k, v, do = make_inputs(case, device, seed=len(name) + 10)
    kw = kwargs(case)
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
    lib_s = (f"{row['library_ms']:.4f} ms (B7 "
             f"{row['ms'] / row['library_ms']:.2f}x)" if lib
             else "not timed (no such kernel on the CPU)")
    log(f"timing fused case {name} ({iters} calls each in a CUDA graph): B7 "
        f"{row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  dq + dk/dv "
        f"{row['two_ms']:.4f} ms (B7 {row['ms'] / row['two_ms']:.2f}x)  aten "
        f"flash backward {lib_s}  bound "
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
    sdpa_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
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
    rows["pack2"]["executed_flops"] = 3 * useful // 2
    pack_ms = time_ms(lambda: vprobe.pack2_attention(q, k, v, sm), iters,
                      device)
    log(f"timing the probe kernels B{b} H{h} S{s} D{d} ({iters} calls "
        f"each in a CUDA graph; SDPA forward {sdpa_ms:.4f} ms):")
    for name, r in rows.items():
        log(f"  {name:12s} kernel {r['ms']:.4f} ms ({r['ms'] / sdpa_ms:.2f}x "
            f"SDPA's)  plain "
            f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['flops'] / 1e9:.2f} GFLOP useful, "
            f"{r['bytes'] / 1e6:.1f} MB)  share of bound "
            f"{r['bound_ms'] / r['ms']:.3f}")
    log(f"  pack2 executes {rows['pack2']['executed_flops'] / 1e9:.2f} GFLOP "
        f"(1.5x the useful work: the zero half of q2 k2^T); pack2_attention "
        f"with the torch packing {pack_ms:.4f} ms")
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


RUNTIME_KEYS = ("allreduce", "reducescatter", "allgather", "broadcast",
                "responses", "cache_hits", "slabs", "groups", "busy_cycles",
                "cycle_ms")


def runtime_steps(snaps: list) -> dict:
    """Per-step deltas of ``runtime.COUNTS`` from snapshots taken before
    the first step and after each one."""
    return {k: [b[k] - a[k] for a, b in zip(snaps, snaps[1:])]
            for k in RUNTIME_KEYS}


def log_runtime(label: str, per_step: dict) -> None:
    """What the runtime issued a step: collectives per kind, responses
    (a fused bin is one), response-cache hits, fusion slabs and process
    groups created, and the cycles' host ms."""
    log(f"  runtime per step ({label}):")
    for k in RUNTIME_KEYS:
        vals = per_step[k]
        text = (" ".join(f"{v:.1f}" for v in vals) if k == "cycle_ms"
                else " ".join(str(int(v)) for v in vals))
        log(f"    {k:13s} {text}")


def check_hooks_runtime(cfg, per_step: dict, n_tensors: int,
                        threshold: int, card: bool,
                        card_limit: float = None) -> None:
    """The hooks' runtime checks (phases 4 and 8): every step after the
    first answered every gradient from the response cache, and no fusion
    slab or process group appeared after the warm-up steps; at threshold 0
    one allreduce a tensor every step; fused (the default threshold), on
    the card, fewer allreduces a step after the first than ``card_limit``
    (a quarter of the tensors by default) (on the CPU rehearsal the host's
    speed sets how many cycles a backward spans, so there only at most one
    a tensor)."""
    ar, warm = per_step["allreduce"], cfg["warmup"]
    if threshold == 0:
        check(all(n == n_tensors for n in ar),
              f"threshold 0: {ar} allreduces a step, want {n_tensors}")
    else:
        if card_limit is None:
            card_limit = n_tensors / 4
        limit = card_limit if card else n_tensors + 1
        check(all(n < limit for n in ar[1:]),
              f"fused: {ar} allreduces a step, want < {limit}")
    hits = per_step["cache_hits"]
    check(all(h == n_tensors for h in hits[1:]),
          f"cache hits a step {hits}, want {n_tensors} after the first")
    for k in ("slabs", "groups"):
        check(not any(per_step[k][warm:]),
              f"new {k} after warm-up: {per_step[k]}")


PATHS = {  # phase 4 and the optimizer paths of phase 5
    "hooks": "DistributedOptimizer(torch.optim.AdamW), per-parameter hooks",
    "fused": "P1: allreduce_gradients + fused_adamw (multi-tensor kernel)",
    "zero": "P2: ZeRO-1 sharded_adamw (reduce-scatter, flat kernel, "
            "allgather)",
    "sharded": "P3: DistributedOptimizer(AdamW, shard_optimizer_states=True)"
               " (sharded_update: torch AdamW over the flat shard)",
    "zero2": "P4: ZeRO-2 GradReleasePlan(reduce_scatter=True) + "
             "sharded_adamw(partition=plan.zero_partition) through "
             "make_train_step (flat kernel a bucket group)",
    "zero3": "P5: ZeRO-3 shard_params, iter_param_buckets refill before the "
             "forward, the reduce-scatter plan, apply returning "
             "ShardedParams",
}
# the ZeRO paths whose every collective is named: from the second step the
# runtime answers all of them from its response cache
ZERO_PATHS = ("zero", "sharded", "zero2", "zero3")


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


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Hidden(torch.nn.Module):
    """BERT's trunk as ``make_train_step`` calls a model, ``model(tokens)``:
    the hidden states the bench's gathered MLM head reads."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens):
        return self.model(tokens, output="hidden")


def adamw_optimizer(model, sharded: bool = False):
    """``DistributedOptimizer(AdamW)`` as the bench builds it
    (bench.py:473-476): the hooks, or ``shard_optimizer_states``."""
    return hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters(),
        shard_optimizer_states=sharded)


def make_step(path, model, params, dev, batch):
    """One path's training step (``step() -> loss``) and what it holds (a
    callable giving bytes of optimizer state, gradient shards and
    parameter shards on the card, and for P5 the stage-3 gather's hidden
    share)."""
    toks, pos, lab = batch
    names = list(params)

    def loss_of(hidden):
        return masked_lm_loss_gathered(hidden, model.token_embed, pos, lab)

    def plain_step(zero_grad, update):
        def step():
            zero_grad()
            loss = loss_of(model(toks, output="hidden"))
            loss.backward()
            update()
            return loss.detach()
        return step

    if path in ("hooks", "sharded"):
        opt = adamw_optimizer(model, path == "sharded")

        def held():
            if path == "hooks":
                return dict(state=nbytes(
                    t for st in opt.state.values() for t in st.values()
                    if isinstance(t, torch.Tensor) and t.device == dev))
            inner = opt.state.inner
            shards = inner.param_groups[0]["params"]
            return dict(state=nbytes(t for st in inner.state.values()
                                     for t in st.values()
                                     if isinstance(t, torch.Tensor)
                                     and t.ndim),
                        grad_shards=nbytes(shards), param_shards=nbytes(shards))

        return plain_step(opt.zero_grad, opt.step), held
    if path in ("fused", "zero"):
        tx = fadam.fused_adamw(1e-4) if path == "fused" \
            else hvd.sharded_adamw(1e-4)
        box = [tx.init(params)]

        def update():
            grads = {k: params[k].grad for k in names}
            if path == "fused":  # as bench.py:543-546 does it
                grads = hvd.allreduce_gradients(grads, average=True)
            _, box[0] = tx.apply(params, box[0], grads)

        def held():
            st = box[0]
            if path == "fused":
                return dict(state=nbytes(list(st.mu.values())
                                         + list(st.nu.values())))
            return dict(state=nbytes([*st.master, *st.mu, *st.nu]),
                        grad_shards=nbytes(st.master))

        return plain_step(lambda: model.zero_grad(set_to_none=True),
                          update), held
    plan = hvd.GradReleasePlan(reduce_scatter=True)
    part = plan.zero_partition(params)
    tx = hvd.sharded_adamw(1e-4, partition=part)
    if path == "zero2":
        train_step = make_train_step(_Hidden(model), tx,
                                     loss_fn=lambda hidden, _: loss_of(hidden),
                                     grad_release=plan)

        def held():  # f32 groups: master, mu and nu as long as a shard
            groups = plan._ensure_zspec().groups
            g_bytes = sum(g.shard_elems * 4 for g in groups)
            return dict(state=3 * g_bytes, grad_shards=g_bytes,
                        groups=len(groups))

        return (lambda: train_step(toks, None)), held
    # zero3: the parameters at rest are the shards; the model's tensors are
    # refilled group by group before each forward
    box = {"sp": hvd.shard_params(params, partition=part)}
    box["state"] = tx.init(box["sp"])
    leaves = list(params.values())

    def step():
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for _, bucket in hvd.iter_param_buckets(box["sp"]):
                for i, t in bucket.items():
                    leaves[i].copy_(t)
        plan.tag(params)
        loss = loss_of(model(toks, output="hidden"))
        loss.backward()
        sg = plan.gather()
        box["sp"], box["state"] = tx.apply(box["sp"], box["state"], sg)
        return loss.detach()

    def held():
        st = box["state"]
        return dict(state=nbytes([*st.master, *st.mu, *st.nu]),
                    grad_shards=nbytes(st.master),
                    param_shards=nbytes(box["sp"].shards),
                    groups=len(st.spec.groups),
                    hidden=zero_mod.gather_hidden_fraction())

    return step, held


def train(cfg, device, card, path="hooks", profile=False,
          threshold=None) -> dict:
    """Drive one path of the slice: 2 warm-up and 10 timed steps of
    BERT-Large MLM from seed-0 weights. Returns the losses, the kernel
    launches of the run (every count is set to 0 just before it) and what
    the runtime issued a step. ``threshold`` sets
    ``HOROVOD_FUSION_THRESHOLD`` for the run (0: one allreduce a tensor)."""
    if threshold is None:
        return _train(cfg, device, card, path, profile)
    os.environ[env.HOROVOD_FUSION_THRESHOLD] = str(threshold)
    try:
        return _train(cfg, device, card, path, profile, threshold)
    finally:
        os.environ.pop(env.HOROVOD_FUSION_THRESHOLD, None)


def _train(cfg, device, card, path, profile, threshold=None,
           before_shutdown=None) -> dict:
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
    toks, pos, lab = (torch.from_numpy(a).to(dev)
                      for a in (tokens, positions, labels))
    n_broadcast = len(model.state_dict())
    step, held = make_step(path, model, params, dev, (toks, pos, lab))
    n_tensors = len(params)
    n_params = sum(p.numel() for p in params.values())
    n_layers = len(model.layers)
    n_groups = len({p.dtype for p in params.values()})
    d_model = model.token_embed.shape[1]
    zero_mod.GATHER_SECONDS.update(stall=0.0, hidden=0.0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    losses, times, snaps = [], [], [dict(hrt.COUNTS)]
    b8 = []
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        before = fopt.LAUNCHES["flat_adamw"]
        loss = step()
        losses.append(loss.item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
        b8.append(fopt.LAUNCHES["flat_adamw"] - before)
        if i >= cfg["warmup"]:
            times.append(time.perf_counter() - t0)
    launches = {**fa.LAUNCHES, **fadam.LAUNCHES, **fopt.LAUNCHES}
    counts = dict(collectives.COUNTS)
    kept = held()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if profile:
        breakdown(step, dev, statistics.median(times), cfg["profile_steps"])
    if before_shutdown is not None:
        before_shutdown()
    del model, params, held, step
    hvd.shutdown()
    free_memory(device)

    label = path if threshold is None else f"{path}, fusion threshold " \
                                              f"{threshold}"
    log(f"slice ({label}: {PATHS[path]}): BERT-Large MLM, {n_layers} layers, "
        f"{n_params / 1e6:.1f}M params in {n_tensors} tensors, batch {batch} "
        f"x seq {seq}, {cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{x:.4f}" for x in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    log(f"  flat AdamW (B8) launches a step: {' '.join(map(str, b8))}")
    issued = runtime_steps(snaps)
    log_runtime(label, issued)
    if path == "hooks":
        check_hooks_runtime(cfg, issued, n_tensors,
                            env.DEFAULT_FUSION_THRESHOLD_BYTES
                            if threshold is None else threshold,
                            dev.type == "cuda")
    if path in ZERO_PATHS:
        check_zero_runtime(cfg, path, issued)
    check(all(math.isfinite(x) for x in losses), f"{path}: non-finite loss")
    check(losses[-1] < losses[0], f"{path}: loss did not fall: {losses}")
    g = kept.get("groups", n_groups)  # P4, P5: one group a bucket
    per_step = {  # collectives and optimizer launches each path must issue
        "hooks": (dict(allreduce=n_tensors), {}),
        "fused": (dict(allreduce=n_tensors), {"adamw_multi": 1}),
        "zero": (dict(reducescatter=n_groups, allgather=n_groups),
                 {"flat_adamw": n_groups}),
        "sharded": (dict(reducescatter=n_groups, allgather=n_groups), {}),
        "zero2": (dict(reducescatter=g, allgather=g), {"flat_adamw": g}),
        "zero3": (dict(reducescatter=g, allgather=g), {"flat_adamw": g}),
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
    shard_text = ", ".join(f"{k.replace('_', ' ')} {kept[k] / 2**30:.3f} GiB"
                           for k in ("state", "grad_shards", "param_shards")
                           if k in kept)
    if "hidden" in kept:
        log(f"  stage-3 gather: hidden share {kept['hidden']:.3f} "
            f"(host seconds: stall {zero_mod.GATHER_SECONDS['stall']:.4f}, "
            f"hidden {zero_mod.GATHER_SECONDS['hidden']:.4f}); "
            f"{g} groups")
    if dev.type == "cuda":
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  tokens/s {tok_s:.1f} {where}")
        log(f"  MFU {tok_s * flops_per_token / PEAK_FLOPS:.4f} against "
            f"989 TFLOP/s bf16, {flops_per_token / 1e9:.3f} GFLOP/token "
            f"{where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB; held on the "
            f"card: {shard_text} {where}")
    else:
        log(f"  held: {shard_text}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s,
                runtime=issued)


@contextlib.contextmanager
def knobs(**values):
    """Environment knobs set for one run, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def engine_run(cfg, device, card, engine: str, threshold=None,
               inspect=None) -> dict:
    """One hooks run of phase 4c with ``HOROVOD_NATIVE_CYCLE`` set for
    ``engine`` ("native" or "python"): the calls of the native bin-packer
    counted, the runtime's cache read before shutdown (and ``inspect()``
    called there), and the metrics registry's moves over the run held
    against those of ``COUNTS``: ``horovod_cycles_total`` by
    ``COUNTS["cycles"]``, ``horovod_response_cache_hits_total`` by twice
    ``COUNTS["cache_hits"]`` (a request answered from the cache is looked
    up at its announcement and when the agreed list is applied, as in the
    JAX package). Both are read once the run's runtime has stopped."""
    native = engine == "native"
    real, calls, seen = fusion_mod._bins_native, [0], {}

    def counted(*args):
        calls[0] += 1
        return real(*args)

    def before_shutdown():
        ctrl = state_mod.global_state().runtime.controller
        seen.update(cache=type(ctrl.cache).__name__,
                    native=ctrl.native_engine)
        if inspect is not None:
            inspect()

    extra = {} if threshold is None else {
        env.HOROVOD_FUSION_THRESHOLD: threshold}
    before, counts = flatten_snapshot(hvd.metrics()), dict(hrt.COUNTS)
    fusion_mod._bins_native = counted
    try:
        with knobs(**{env.HOROVOD_NATIVE_CYCLE: int(native)}, **extra):
            run = _train(cfg, device, card, "hooks", False, threshold,
                         before_shutdown=before_shutdown)
    finally:
        fusion_mod._bins_native = real
    after = flatten_snapshot(hvd.metrics())
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("horovod_cycles_total",
                       "horovod_response_cache_hits_total")}
    counted_moves = {k: hrt.COUNTS[k] - counts[k]
                     for k in ("cycles", "cache_hits")}
    log(f"  engine {engine}: cache {seen['cache']}, native bin-packer "
        f"calls {calls[0]}; metrics moved {moved}, COUNTS moved "
        f"{counted_moves}")
    check(seen == dict(cache="NativeResponseCache" if native
                       else "ResponseCache", native=native),
          f"{engine} run's runtime used {seen}")
    check((calls[0] > 0) == native,
          f"{engine} run called the native bin-packer {calls[0]} times")
    check(moved["horovod_cycles_total"] == counted_moves["cycles"] > 0,
          f"cycles moved {moved}, COUNTS {counted_moves}")
    check(moved["horovod_response_cache_hits_total"]
          == 2 * counted_moves["cache_hits"] > 0,
          f"cache hits moved {moved}, COUNTS {counted_moves}")
    run.update(engine=engine, cycle_ms=statistics.median(
        run["runtime"]["cycle_ms"][cfg["warmup"]:]))
    return run


def compare_engines(cfg, device, card) -> None:
    """Phase 4c: the hooks path on the native cycle engine and on the
    Python one, in turns (native, Python, Python, native), then once each
    at threshold 0; then two steps with the trace and the metrics
    endpoint on."""
    warmup, steps = cfg["engine_steps"]
    cfg = dict(cfg, warmup=warmup, steps=steps)
    runs = [engine_run(cfg, device, card, e)
            for e in ("native", "python", "python", "native")]
    t0 = [engine_run(cfg, device, card, e, threshold=0)
          for e in ("native", "python")]
    for group, keys in ((runs, ("cache_hits", "slabs", "groups")),
                        (t0, ("allreduce", "responses", "cache_hits",
                              "slabs", "groups"))):
        for r in group:
            check(r["losses"] == runs[0]["losses"],
                  f"{r['engine']} losses {r['losses']} not bit-equal to "
                  f"{runs[0]['losses']}")
            check(r["runtime"]["allreduce"] == r["runtime"]["responses"],
                  f"{r['engine']}: allreduce calls and responses differ")
            for k in keys:
                check(r["runtime"][k] == group[0]["runtime"][k],
                      f"{k} a step differ across engines: "
                      f"{[g['runtime'][k] for g in group]}")
    log("phase 4c: losses bit-equal on both engines; cache hits, slabs and "
        "groups a step equal in every run; at threshold 0 also allreduce "
        "calls and responses (fused bins follow the hooks' timing)")
    where = "(no device times)" if device.type != "cuda" else f"({card})"
    for label, group in (("fused", runs), ("threshold 0", t0)):
        for r in group:
            log(f"  engines, {label}, {r['engine']}: step "
                f"{r['step_ms']:.2f} ms median, cycle host "
                f"{r['cycle_ms']:.2f} ms a step (median), allreduce calls "
                f"a step {r['runtime']['allreduce']} {where}")
    trace_and_endpoint(cfg, device, card)


def trace_and_endpoint(cfg, device, card) -> None:
    """Phase 4c's last run: two hooks steps with ``HOROVOD_TIMELINE``,
    ``HOROVOD_TIMELINE_MARK_CYCLES=1`` and ``HOROVOD_METRICS_PORT=0``. The
    trace must parse, hold cycle markers, counter events and the
    backend's allreduce activities, and report its drop count; ``GET
    /metrics`` must serve the cycle and cache families."""
    cfg = dict(cfg, warmup=1, steps=1)
    backend = "NCCL" if device.type == "cuda" else "GLOO"
    served = {}

    def fetch():
        port = metrics_registry().http_port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as resp:
            served.update(status=resp.status, text=resp.read().decode())

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with knobs(**{env.HOROVOD_TIMELINE: path,
                      env.HOROVOD_TIMELINE_MARK_CYCLES: 1,
                      env.HOROVOD_METRICS_PORT: 0}):
            engine_run(cfg, device, card, "native", inspect=fetch)
        with open(path) as f:
            events = json.load(f)
    names = [e.get("name", "") for e in events]
    marks = sum(n.startswith("CYCLE_") for n in names)
    counters = sum(e.get("ph") == "C" for e in events)
    reduces = names.count(f"{backend}_ALLREDUCE")
    drops = [e["args"]["count"] for e in events
             if e.get("name") == "dropped_events"]
    log(f"  trace: {len(events)} events, {marks} cycle markers, {counters} "
        f"counter events, {reduces} {backend}_ALLREDUCE, dropped "
        f"{drops}")
    check(marks > 0 and counters > 0 and reduces > 0 and len(drops) == 1,
          "the trace lacks cycle markers, counter events, allreduces or "
          "its drop count")
    text = served.get("text", "")
    families = ("horovod_cycles_total", "horovod_response_cache_hits_total",
                "horovod_fusion_bytes_total")
    log(f"  GET /metrics: status {served.get('status')}, {len(text)} bytes, "
        f"families {[f for f in families if f'# TYPE {f} ' in text]}")
    check(served.get("status") == 200
          and all(f"# TYPE {f} " in text for f in families),
          "the metrics endpoint did not serve the runtime's families")


def check_zero_runtime(cfg, path: str, per_step: dict) -> None:
    """The ZeRO paths' runtime checks: every collective after the first
    step came from the response cache (the names are the same every step),
    and no fusion slab or process group appeared after the warm-up."""
    issued = [a + b for a, b in zip(per_step["reducescatter"],
                                    per_step["allgather"])]
    hits = per_step["cache_hits"]
    check(all(h == n for h, n in zip(hits[1:], issued[1:])),
          f"{path}: cache hits a step {hits}, want {issued} after the first")
    for k in ("slabs", "groups"):
        check(not any(per_step[k][cfg["warmup"]:]),
              f"{path}: new {k} after warm-up: {per_step[k]}")


def compare_fusion(cfg, device, card, fused: dict) -> None:
    """Phase 4b: the hooks path at ``HOROVOD_FUSION_THRESHOLD=0`` (one
    allreduce a tensor) in turns with phase 4's fused run (fused, 0, 0,
    fused). At world 1 every reduction is the identity, so the losses must
    equal the fused run's to the last bit, unless a library kernel is
    nondeterministic (the embedding backward's atomics): then within 1e-5
    relative."""
    runs = {"fused": [fused], "threshold 0": []}
    for label in ("threshold 0", "threshold 0", "fused"):
        runs[label].append(train(cfg, device, card, "hooks",
                                 threshold=0 if label != "fused" else None))
    base = fused["losses"]
    for label, rs in runs.items():
        for r in rs:
            worst = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                            base))
            log(f"hooks losses, {label} vs phase 4: largest relative "
                f"difference {worst:.3e} "
                f"({'bit-equal' if r['losses'] == base else 'not bit-equal'};"
                f" limit 1e-5)")
            check(worst <= 1e-5, f"hooks at {label} moved the losses by "
                                 f"{worst:.3e}")
    if device.type != "cuda":
        log("phase 4b rehearsed (no device times)")
        return
    for label, rs in runs.items():
        ms = [r["step_ms"] for r in rs]
        calls = statistics.median(n for r in rs
                                  for n in r["runtime"]["allreduce"][1:])
        log(f"hooks step median at {label}, turns fused, 0, 0, fused: "
            + " ".join(f"{x:.2f}" for x in ms) + f" ms; {calls:.0f} "
            f"allreduces a step (median after the first) ({card})")


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


def _worst(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def compare_losses(runs: dict) -> None:
    """Every path's loss within 1e-2 relative of the phase-4 path's at
    every step: same weights, data and AdamW; bf16 compute and the
    embedding backward's atomics separate them. P4's and P5's within 1e-5
    of P2's: the same flat AdamW on the same elements (a bucket-aligned
    layout, sharded at rest in P5), so only the atomics remain."""
    base = runs["hooks"]["losses"]
    for path, run in runs.items():
        worst = _worst(run["losses"], base)
        log(f"losses of {path} vs hooks: largest relative difference "
            f"{worst:.3e} (limit 1e-2)")
        check(worst <= 1e-2, f"{path} losses differ from the hooks path's "
                             f"by {worst:.3e}")
    for path in ("zero2", "zero3"):
        worst = _worst(runs[path]["losses"], runs["zero"]["losses"])
        same = runs[path]["losses"] == runs["zero"]["losses"]
        log(f"losses of {path} vs zero (P2): largest relative difference "
            f"{worst:.3e} ({'bit-equal' if same else 'not bit-equal'}; "
            f"limit 1e-5)")
        check(worst <= 1e-5, f"{path} losses differ from P2's by "
                             f"{worst:.3e}")


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
    losses, times, snaps = [], [], [dict(hrt.COUNTS)]
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(x, y).item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
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
    log_runtime("Inception-V3", runtime_steps(snaps))
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
        opt = adamw_optimizer(model)
        zero_grad, update = opt.zero_grad, opt.step
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

        losses, times, snaps = [], [], [dict(hrt.COUNTS)]
        steps = cfg["warmup"] + cfg["steps"]
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(step().item())  # waits for the step's last kernel
            snaps.append(dict(hrt.COUNTS))
            if i >= cfg["warmup"]:
                times.append(time.perf_counter() - t0)
        launches = dict(fa.LAUNCHES)
        counts = dict(collectives.COUNTS)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        step_s = statistics.median(times)
        if profile:
            breakdown(step, dev, step_s, cfg["profile_steps"])
        del model, params, opt, update, zero_grad, step
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
    log_runtime(f"GPT-2, {bwd}", runtime_steps(snaps))
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


# ---------------------------------------------------------------------------
# Phase 8: the ResNet-50 slice
# ---------------------------------------------------------------------------


def train_resnet(cfg, device, card, profile=False) -> dict:
    """The bench's ResNet-50 row (``bench.py:85, 258-300``), eager, one
    process: ``hvd.init()``, ``ResNet50(1000, bf16, seed=0)`` on
    ``hvd.device()`` (NHWC images, f32 parameters and statistics),
    ``broadcast_parameters(state_dict())``, ``DistributedOptimizer(SGD(0.01
    x size, momentum 0.9))`` through the hooks and the runtime, the bench's
    images and labels (the same batch every step), 2 warm-up and 10 timed
    steps. Losses finite and falling; 161 gradients a step, every one from
    the response cache from the second step, fewer fused calls a step than
    gradients, no slab or group after warm-up. The 33 norm + ReLU pairs
    run plain, not on B10 (``tools/resnet_bn_choice.py`` timed both)."""
    rn = cfg["resnet"]
    batch, size = rn["batch"], rn["size"]
    rng = np.random.RandomState(0)  # bench.py:306-312
    images = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
    labels = rng.randint(0, rn["classes"], (batch,)).astype(np.int32)

    cba.reset_launch_counts()
    collectives.COUNTS.update(dict.fromkeys(collectives.COUNTS, 0))
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = ResNet50(num_classes=rn["classes"], dtype=rn["dtype"], seed=0)
    check(next(model.parameters()).device == dev,
          "ResNet50() without a device must take hvd.device()")
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    step = make_train_step(model, opt)
    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
    n_tensors = len(list(model.parameters()))
    n_params = sum(p.numel() for p in model.parameters())
    n_pairs = sum(isinstance(m, BatchNormReLU) for m in model.modules())
    n_broadcast = len(model.state_dict())
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, snaps = [], [], [dict(hrt.COUNTS)]
    steps = cfg["warmup"] + cfg["steps"]
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(x, y).item())  # waits for the step's last kernel
        snaps.append(dict(hrt.COUNTS))
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

    log(f"slice (ResNet-50): {n_params:,} params in {n_tensors} tensors, "
        f"{n_pairs} norm + ReLU pairs (plain), batch {batch} x {size}^2 NHWC, "
        f"{cfg['warmup']} warm-up + {cfg['steps']} timed steps")
    log("  losses: " + " ".join(f"{v:.4f}" for v in losses))
    log(f"  kernel launches: {launches}; collectives: {counts}")
    issued = runtime_steps(snaps)
    log_runtime("ResNet-50", issued)
    check(n_tensors == 161 and (n_params == 25_557_032
                                or rn["classes"] != 1000),
          f"ResNet-50 has {n_tensors} tensors, {n_params} params")
    check_hooks_runtime(cfg, issued, n_tensors,
                        env.DEFAULT_FUSION_THRESHOLD_BYTES,
                        dev.type == "cuda", card_limit=n_tensors)
    check(all(math.isfinite(v) for v in losses), "ResNet-50: non-finite loss")
    check(losses[-1] < losses[0], f"ResNet-50: loss did not fall: {losses}")
    want = {k: 0 for k in counts}
    want.update(allreduce=n_tensors * steps, broadcast=n_broadcast)
    check(counts == want, f"ResNet-50: collectives {counts}, want {want}")
    check(launches == {"sba": 0}, f"ResNet-50: kernel launches {launches}, "
                                  f"want none (the pairs run plain)")
    if dev.type == "cuda":
        img_s = batch / step_s
        where = f"({card})"
        log(f"  step {1e3 * step_s:.2f} ms median (mean "
            f"{1e3 * statistics.mean(times):.2f} ms) {where}")
        log(f"  images/s {img_s:.1f} {where}")
        log(f"  MFU {img_s * RESNET_FLOPS / PEAK_FLOPS:.4f} against 989 "
            f"TFLOP/s bf16, {RESNET_FLOPS / 1e9:.3f} GFLOP/image {where}")
        log(f"  max_memory_allocated {peak / 2**30:.2f} GiB {where}")
    return dict(losses=losses, launches=launches, step_ms=1e3 * step_s)


# ---------------------------------------------------------------------------
# Phase 9: the rest of the collectives through the runtime
# ---------------------------------------------------------------------------


def check_collectives(device) -> None:
    """At world 1 (NCCL on the card): an allgather, an alltoall, a
    differentiable allreduce with its backward, an int64 allreduce past
    2**40, a sparse allreduce and ``broadcast_object``, each held exactly
    against the value it must have; every one is issued by the runtime
    (``runtime.COUNTS``). A ragged allgather needs two ranks: the four-card
    test ``tests/test_torch_kernels.py::test_runtime_across_the_cards``
    runs it on NCCL."""
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    try:
        before = dict(hrt.COUNTS)
        x = torch.arange(12, device=dev).reshape(4, 3)
        check(torch.equal(hvd.allgather(x, name="smoke.ag"), x),
              "allgather at world 1")
        check(torch.equal(hvd.alltoall(x.float(), name="smoke.a2a"),
                          x.float()), "alltoall at world 1")
        w = torch.full((5,), 2.0, device=dev, requires_grad=True)
        out = hvd.allreduce(w * 3, op=hvd.Sum, name="smoke.ar")
        (out * torch.arange(5.0, device=dev)).sum().backward()
        check(torch.equal(out.detach(), torch.full((5,), 6.0, device=dev))
              and torch.equal(w.grad, 3 * torch.arange(5.0, device=dev)),
              "differentiable allreduce at world 1")
        big = torch.tensor([2 ** 40 + 1, -(2 ** 40) - 3], device=dev)
        check(torch.equal(hvd.allreduce(big, op=hvd.Sum, name="smoke.big"),
                          big), f"int64 past 2**40: {big.tolist()}")
        sp = torch.sparse_coo_tensor(torch.tensor([[0, 2, 2]]),
                                     torch.tensor([1.0, 2.0, 3.0]), (4,),
                                     check_invariants=True)
        got = hvd.sparse_allreduce_async(sp.to(dev), name="smoke.sparse")
        check(torch.equal(got.wait().to_dense().cpu(),
                          torch.tensor([1.0, 0.0, 5.0, 0.0])),
              "sparse allreduce at world 1")
        check(hvd.broadcast_object({"epoch": 3}) == {"epoch": 3},
              "broadcast_object")
        issued = {k: hrt.COUNTS[k] - before[k]
                  for k in ("allreduce", "allgather", "alltoall")}
        # the allreduce's backward is one more; the sparse one two gathers
        check(issued == dict(allreduce=3, allgather=3, alltoall=1),
              f"collectives issued at world 1: {issued}")
        log(f"collectives through the runtime at world 1 on {dev} "
            f"({'NCCL' if dev.type == 'cuda' else 'gloo'}): allgather, "
            f"alltoall, differentiable allreduce and its backward, int64 "
            f"past 2**40, sparse allreduce, broadcast_object exact; issued "
            f"{issued}")
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Phase 10: the training API
# ---------------------------------------------------------------------------


def resnet_setup(cfg, device, losses=None) -> dict:
    """Phase 8's ResNet-50, data and optimizer for the training API:
    ``hvd.init()``, ``ResNet50(seed=0)``, ``DistributedOptimizer(SGD(0.01 x
    size, momentum 0.9))``, ``create_train_state``. ``losses`` collects
    every step's loss (the loss function's own output, unread)."""
    rn = cfg["resnet"]
    rng = np.random.RandomState(0)  # bench.py:306-312, as phase 8
    images = rng.uniform(-1, 1, (rn["batch"], rn["size"], rn["size"], 3)) \
        .astype(np.float32)
    labels = rng.randint(0, rn["classes"], (rn["batch"],)).astype(np.int32)
    hvd.init(device=None if device.type == "cuda" else "cpu")
    dev = hvd.device()
    model = ResNet50(num_classes=rn["classes"], dtype=rn["dtype"], seed=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01 * hvd.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    state = hvd.training.create_train_state(model, opt)
    check(all(t.device == dev for t in state.params.values()),
          "create_train_state: parameters off the device")

    def loss_fn(logits, y):
        loss = hvd.training.default_loss_fn(logits, y)
        if losses is not None:
            losses.append(loss.detach())
        return loss

    x, y = (torch.from_numpy(a).to(dev) for a in (images, labels))
    return dict(model=model, opt=opt, loss_fn=loss_fn, x=x, y=y, dev=dev)


def timed_rounds(cfg, setup: dict, rounds: int, explicit: bool = False,
                 flops: bool = False) -> dict:
    """A ``make_train_round(steps=cfg["round_steps"])`` of ``setup``'s
    model, made under the knobs as they stand (the profiler and the guard
    wrap it or not), one warm-up round, then ``rounds`` timed ones (each
    inside ``hvd.profiler.step`` when ``explicit``), the device drained
    after each. Returns the rounds' ms a step, the timed rounds' records,
    the history's growth after each, and whether the round was wrapped."""
    k, dev = cfg["round_steps"], setup["dev"]
    round_fn = hvd.training.make_train_round(
        setup["model"], setup["opt"], loss_fn=setup["loss_fn"], steps=k)
    if flops:  # per-card FLOPs of one round (3 x forward a step)
        hvd.profiler.set_flops_per_step(
            cfg["resnet"]["batch"] * k * RESNET_FLOPS, PEAK_FLOPS)
    x, y = setup["x"], setup["y"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    round_fn(x, y)
    sync()
    hvd.profiler.dump()  # closes the warm-up's record, if profiling
    n0 = len(hvd.profiler.history())
    ms, records, counts = [], [], []
    for i in range(rounds):
        t0 = time.perf_counter()
        if explicit:
            with hvd.profiler.step(f"round {i}") as rec:
                round_fn(x, y)
            records.append(rec.breakdown if rec is not None else None)
            counts.append(len(hvd.profiler.history()) - n0)
        else:
            round_fn(x, y)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0) / k)
    hvd.profiler.dump()
    if flops:
        hvd.profiler.set_flops_per_step(None)
    return dict(ms=ms, records=records, counts=counts,
                wrapped=hasattr(round_fn, "__wrapped__"))


def training_api(cfg, device, card, phase8_losses: list) -> None:
    """Phase 10: the training API around the step, on the bench's
    ResNet-50 and BERT-Large."""
    where = f"({card})" if device.type == "cuda" else "(no device times)"
    k = cfg["round_steps"]
    rounds = cfg["api_rounds"]

    # 10a: the profiled rounds, one record a round
    step_losses = []
    with knobs(**{env.HOROVOD_PROFILE: 1}):
        setup = resnet_setup(cfg, device, losses=step_losses)
        run = timed_rounds(cfg, setup, rounds, explicit=True, flops=True)
    records, counts = run["records"], run["counts"]
    setup.clear()
    hvd.shutdown()
    free_memory(device)
    got = [v.item() for v in step_losses]
    check(all(math.isfinite(v) for v in got) and got[-1] < got[0],
          f"10a: losses not finite or not falling: {got}")
    n = min(len(got), len(phase8_losses))
    rel = [abs(a - b) / abs(b) for a, b in zip(got[:n], phase8_losses[:n])]
    log(f"10a training API (ResNet-50, create_train_state + "
        f"make_train_round(steps={k})): {len(got)} steps; largest "
        f"relative difference from phase 8's losses: first step "
        f"{rel[0]:.3e} (limit 1e-5), any step {max(rel):.3e} (limit 1e-2)")
    log("  losses: " + " ".join(f"{v:.4f}" for v in got))
    check(rel[0] <= 1e-5 and max(rel) <= 1e-2,
          f"10a: round losses off phase 8's: {rel}")
    check(counts == list(range(1, rounds + 1)),
          f"10a: history grew by {counts}, want one record a round")
    for i, b in enumerate(records):
        total = sum(b["phases"].values())
        check(abs(total - b["wall_seconds"]) <= 1e-9 * b["wall_seconds"],
              f"10a: round {i} phases sum {total} != {b['wall_seconds']}")
        check(b["comm"]["dispatches"] > 0 and (b["mfu"] or 0) > 0,
              f"10a: round {i} dispatches {b['comm']['dispatches']}, "
              f"mfu {b['mfu']}")
        log(f"  round {i}: wall {1e3 * b['wall_seconds']:.2f} ms; "
            f"step_breakdown ms " + json.dumps(
                {p: round(1e3 * v, 3) for p, v in b["phases"].items()})
            + f"; comm_hidden_fraction {b['comm']['hidden_fraction']:.4f}"
            f" ({b['comm']['dispatches']} dispatches, "
            f"{b['comm']['bytes']} bytes); mfu {b['mfu']:.4f}; "
            f"peak_hbm_bytes {b['peak_hbm_bytes']} {where}")

    # 10b and 10d run on one model, the knobs switched between turns (the
    # profiler re-reads them at configure(); the guard at each step)
    from horovod_tpu_torch.integrity import guards

    setup = resnet_setup(cfg, device)
    turns = {"profile": {}, "integrity": {}}
    guards.reset()
    skipped0 = guards._SKIPPED.value
    for knob, key in ((env.HOROVOD_PROFILE, "profile"),
                      (env.HOROVOD_INTEGRITY, "integrity")):
        for on in (0, 1, 1, 0) if key == "profile" else (1, 0, 0, 1):
            with knobs(**{knob: on}):
                hvd.profiler.configure()
                run = timed_rounds(cfg, setup, rounds)
            turns[key].setdefault(on, []).append(statistics.median(
                run["ms"]))
            check(run["wrapped"] == bool(on),
                  f"{knob}={on}: round wrapped {run['wrapped']}")
    hvd.profiler.configure()
    cost, guarded = turns["profile"], turns["integrity"]
    log(f"10b profiler cost, ResNet-50 round of {k} steps, ms a step "
        f"(median of {rounds} rounds), turns off, on, on, off: "
        + " ".join(f"{cost[o][i]:.2f}" for o, i in ((0, 0), (1, 0), (1, 1),
                                                     (0, 1)))
        + f" {where}")
    check(guards._SKIPPED.value == skipped0,
          f"10d: the healthy runs skipped "
          f"{guards._SKIPPED.value - skipped0} steps")

    # 10d: the guard's own cost (the norm of the last step's gradients
    # and its read, on an idle device; ms a call, median of 10), then a
    # step with one NaN in one gradient
    model, opt, x, y = (setup[n] for n in ("model", "opt", "x", "y"))
    grads = [p.grad for p in model.parameters()]
    norm_ms = []
    for _ in range(10):
        t0 = time.perf_counter()
        guards.global_norm(grads)
        norm_ms.append(1e3 * (time.perf_counter() - t0))
    with knobs(**{env.HOROVOD_INTEGRITY: 1}):
        before = [p.detach().clone() for p in model.parameters()]
        momentum = [opt.state[p]["momentum_buffer"].clone()
                    for p in model.parameters()]
        target = next(model.parameters())

        def one_nan(g):
            g = g.clone()
            g[(0,) * g.dim()] = float("nan")
            return g

        hook = target.register_hook(one_nan)
        opt.zero_grad()
        model.train()
        hvd.training.default_loss_fn(model(x), y).backward()
        opt.step()
        hook.remove()
        same = all(torch.equal(a, b) for a, b in zip(before,
                                                     model.parameters()))
        same_m = all(torch.equal(m, opt.state[p]["momentum_buffer"])
                     for m, p in zip(momentum, model.parameters()))
        moved = guards._SKIPPED.value - skipped0
    setup.clear()
    hvd.shutdown()
    free_memory(device)
    guards.reset()
    log(f"10d integrity guard, ResNet-50 round of {k} steps, ms a step "
        f"(median of {rounds} rounds), turns on, off, off, on: "
        + " ".join(f"{guarded[o][i]:.2f}" for o, i in ((1, 0), (0, 0),
                                                        (0, 1), (1, 1)))
        + f"; the norm of the 161 gradients and its read alone "
        f"{statistics.median(norm_ms):.3f} ms {where}; no healthy step "
        f"skipped")
    log(f"10d NaN step skipped: parameters bit-equal {same}, momentum "
        f"bit-equal {same_m}, horovod_integrity_skipped_steps_total moved "
        f"{moved}")
    check(same and same_m and moved == 1,
          "10d: the NaN step was not skipped cleanly")

    # 10c: BERT-Large on the hooks path, the optimizer's own boundaries
    profiler_10c(cfg, device, card)

    # 10e: the three examples on the card, each a process of its own
    run_examples(device)


def profiler_10c(cfg, device, card) -> None:
    """10c: BERT-Large on phase 4's hooks path with ``HOROVOD_PROFILE_DIR``
    and ``HOROVOD_PROFILE_JAX``, no explicit step: the optimizer's own
    boundary makes one record a step; ``shutdown()`` writes the dump and
    the device trace, and ``merge_profile_dir`` joins them."""
    warmup, steps = cfg["engine_steps"]
    cfg = dict(cfg, warmup=warmup, steps=steps)
    first = hvd.profiler.profiler()._step_index
    with tempfile.TemporaryDirectory() as tmp:
        with knobs(**{env.HOROVOD_PROFILE: 1, env.HOROVOD_PROFILE_DIR: tmp,
                      env.HOROVOD_PROFILE_JAX: 1}):
            _train(cfg, device, card, "hooks", False)
        recs = [r for r in hvd.profiler.history() if r["step"] > first]
        dumps = hvd.profiler.load_dumps(tmp)
        t0 = time.perf_counter()
        out, n_events = hvd.profiler.merge_profile_dir(tmp)
        merge_s = time.perf_counter() - t0
        with open(out) as f:
            events = json.load(f)["traceEvents"]
        trace_mb = os.path.getsize(os.path.join(
            tmp, "jax-rank-0", hvd.profiler.DEVICE_TRACE)) / 2**20
    check(len(recs) == warmup + steps and all(r["auto"] for r in recs),
          f"10c: {len(recs)} records for {warmup + steps} steps")
    for r in recs:
        check(r["phases"]["optimizer"] > 0
              and abs(sum(r["phases"].values()) - r["wall_seconds"])
              <= 1e-9 * r["wall_seconds"],
              f"10c: record {r['step']} phases {r['phases']}")
    lanes = [(e["args"]["labels"], e["pid"]) for e in events
             if e.get("name") == "process_labels"]
    labels = {label for label, _ in lanes}
    markers = [e for e in events if e.get("ph") == "X"
               and str(e.get("name", "")).startswith("step ")]
    device_pids = {pid for label, pid in lanes if label == "rank 0 device"}
    kernels = [e for e in events if e.get("pid") in device_pids
               and e.get("cat") == "kernel"]
    check(len(dumps) == 1 and len(dumps[0]["steps"]) >= warmup + steps,
          f"10c: dumps {[len(d.get('steps', ())) for d in dumps]}")
    check("rank 0 steps" in labels and "rank 0 device" in labels
          and len(markers) >= warmup + steps,
          f"10c: merged trace lanes {sorted(labels)}, {len(markers)} "
          f"step markers")
    if device.type == "cuda":
        check(len(kernels) > 0, "10c: the device trace holds no kernel")
    where = f"({card})" if device.type == "cuda" else "(no device times)"
    for r in recs:
        log(f"  10c record {r['step']}: wall {1e3 * r['wall_seconds']:.2f} "
            f"ms; phases ms " + json.dumps(
                {p: round(1e3 * v, 3) for p, v in r["phases"].items()})
            + f"; comm_hidden_fraction {r['comm']['hidden_fraction']:.4f}"
            f" {where}")
    log(f"10c profiler on BERT-Large hooks: {len(recs)} records for "
        f"{warmup + steps} steps (optimizer > 0, phases = wall); merged "
        f"trace {n_events} events, {len(markers)} step markers, "
        f"{len(kernels)} device kernels, device trace {trace_mb:.1f} MiB, "
        f"merge {merge_s:.2f} s")


EXAMPLES = {  # (module, arguments on the card, arguments for the rehearsal)
    "synthetic_benchmark": ([], ["--batch-size", "4", "--image-size",
                                 "32"]),
    "synthetic_benchmark --fp16-allreduce": (
        ["--fp16-allreduce"], ["--batch-size", "4", "--image-size", "32",
                               "--fp16-allreduce"]),
    "mnist": (["--epochs", "1"], ["--epochs", "1"]),
    "bert_large_sparse": ([], ["--layers", "1", "--seq", "16", "--batch",
                               "2", "--steps", "2"]),
}


def run_examples(device) -> None:
    """10e: each example as its own process at world 1: on the card at
    their defaults (BERT-Large at full width), one after another; in the
    rehearsal on the CPU at tiny sizes, all at once. A non-zero exit fails
    the phase."""
    free_memory(device)
    here = os.path.dirname(os.path.abspath(__file__))
    env_ = {k: v for k, v in os.environ.items()
            if not k.startswith("HOROVOD_")}  # world 1, no knob

    def start(label):
        card_args, dry_args = EXAMPLES[label]
        args = card_args if device.type == "cuda" else \
            ["--device", "cpu", *dry_args]
        return subprocess.Popen(
            [sys.executable, "-m",
             "horovod_tpu_torch.examples." + label.split()[0], *args],
            cwd=here, env=env_, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def finish(label, proc, t0):
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        lines = out.strip().splitlines()
        log(f"10e example {label}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s; last line: "
            f"{lines[-1] if lines else ''}")
        check(proc.returncode == 0,
              f"example {label} failed:\n{out[-2000:]}\n{err[-3000:]}")
        if label == "bert_large_sparse":
            check("lockstep OK" in out and "tokens/s" in out,
                  "bert_large_sparse printed no tokens/s and lockstep OK")

    if device.type == "cuda":
        for label in EXAMPLES:
            t0 = time.perf_counter()
            finish(label, start(label), t0)
    else:
        t0 = time.perf_counter()
        procs = {label: start(label) for label in EXAMPLES}
        for label, proc in procs.items():
            finish(label, proc, t0)


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
    compare_fusion(cfg, device, card, runs["hooks"])
    compare_engines(cfg, device, card)
    if args.turns > 1:
        compare_in_turns(cfg, device, card, runs, args.turns)
    inception = train_inception(cfg, device, card, args.profile)
    gpt = {fused: train_gpt(cfg, device, card, fused, args.profile)
           for fused in (False, True)}
    compare_gpt_runs(gpt[False], gpt[True])
    resnet = train_resnet(cfg, device, card, args.profile)
    check_collectives(device)
    training_api(cfg, device, card, resnet["losses"])
    if dry:
        log("DRY RUN complete: control flow rehearsed; no result line")
        return 0

    # each kernel's launches are counted on the path that runs it
    launches = {**runs["hooks"]["launches"],
                "adamw_multi": runs["fused"]["launches"]["adamw_multi"],
                "flat_adamw": sum(runs[p]["launches"]["flat_adamw"]
                                  for p in ("zero", "zero2", "zero3")),
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
