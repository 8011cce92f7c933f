#!/usr/bin/env python3
"""The share of the fused backward's (B7) consumer time spent waiting for a
dq turn, read from a copy of the kernel sources with clock64 counters.

    python3 -m horovod_tpu_torch.tools.fused_wait_probe

copies ``horovod_tpu_torch/csrc`` to ``build/fused_wait_probe/csrc`` and
adds two device counters to the copy (:data:`PATCHES`): the cycles the
consumers spend in ``dq_fetch``'s wait for a turn (every lane adds its
own, so the code keeps no divergent path under the wgmmas in flight; the
sum is divided by the 128 lanes of a warpgroup) and each consumer
warpgroup's cycles from its first item to the end of its last. It builds
the copy under ``build/fused_wait_probe/lib`` (the package's own kernels
carry no counter), runs ``flash_bwd_fused`` 20 times at each of
:data:`SHAPES` (GPT-2's and BERT-Large's shapes, and GPT-2's at D128) on
``torch.randn`` inputs from seed 0, and prints one JSON line per shape with
the waiting share and the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import sys
from pathlib import Path

import torch

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import kernel_build
from horovod_tpu_torch.utils.measure import card_line

#: name -> (batch, heads, seq, head_dim, causal)
SHAPES = {"a": (8, 16, 512, 64, False), "b": (16, 12, 1024, 64, True),
          "b_d128": (16, 6, 1024, 128, True)}
_SPIN = """  for (long long spins = 0;
       __shfl_sync(0xffffffffu, ld_acquire(turn), 0) != slot; ++spins) {
    if (spins > (1LL << 26)) __trap();
    __nanosleep(32);
  }
"""
_START = """  const float c = sm_scale * kLog2e;
  int g0 = 0;  // the item's first ring tile in the block's count
  for (int w = blockIdx.x, it = 0; w < n_items; w += gridDim.x, ++it) {
    const BwdItem x = dkv_item(w, BH, Sq, Sk, causal, q_offset, k_offset);
    const int slot = w / BH;"""
_END = """    if (owed) dq_release(owed, slot + 1, cw);
    g0 += x.n_tiles;
"""
#: (file, text that occurs once, its replacement) applied to the copy
PATCHES = (
    ("attention_bwd_sm90.cuh", "namespace {\n",
     "namespace {\n__device__ unsigned long long g_wait_cycles = 0;\n"
     "__device__ unsigned long long g_span_cycles = 0;\n"),
    ("attention_bwd_sm90.cuh", _SPIN,
     "  const long long t_wait = clock64();\n" + _SPIN +
     "  atomicAdd(&g_wait_cycles, (unsigned long long)(clock64() - t_wait));\n"),
    ("attention_bwd_sm90.cuh", _START,
     _START.replace("  int g0 = 0;", "  const long long t_span = clock64();\n"
                    "  int g0 = 0;", 1)),
    ("attention_bwd_sm90.cuh", _END,
     _END + "    if (tid == 0 && w + (int)gridDim.x >= n_items)\n"
     "      atomicAdd(&g_span_cycles, (unsigned long long)(clock64() - "
     "t_span));\n"),
    ("flash_attention.cu", '}  // extern "C"\n',
     "int hvd_wait_cycles(unsigned long long* out) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, g_wait_cycles, 8);\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyFromSymbol(out + 1, g_span_cycles, 8);\n"
     "  const unsigned long long zero[2] = {0, 0};\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyToSymbol(g_wait_cycles, zero, 8);\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaMemcpyToSymbol(g_span_cycles, zero + 1, 8);\n"
     "  return err;\n}\n\n" + '}  // extern "C"\n'),
)


def patched_sources(dst: Path) -> Path:
    """Copy the package's csrc to ``dst`` and apply :data:`PATCHES`; each
    patched text must occur once, or the copy would not measure the kernel
    the package runs."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(kernel_build.CSRC, dst)
    for name, old, new in PATCHES:
        path = dst / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the probe's anchor occurs "
                               f"{text.count(old)} times, not once")
        path.write_text(text.replace(old, new))
    return dst


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_wait_probe needs a CUDA device", file=sys.stderr)
        return 1
    root = kernel_build.BUILD_DIR.parent / "fused_wait_probe"
    kernel_build.CSRC = patched_sources(root / "csrc")
    kernel_build.BUILD_DIR = root / "lib"
    lib = fa._lib()  # the patched copy's library
    lib.hvd_wait_cycles.argtypes = [ctypes.c_void_p]
    lib.hvd_wait_cycles.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    cycles = (ctypes.c_ulonglong * 2)()
    card = card_line()
    for name, (b, h, s, d, causal) in SHAPES.items():
        q, k, v, do = (torch.randn(b, h, s, d, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        kw = dict(causal=causal, sm_scale=d ** -0.5, q_offset=0, k_offset=0)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        args = (q, k, v, do, lse, fa.compute_delta(o, do))
        fa.flash_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
        kernel_build.check_error(lib, lib.hvd_wait_cycles(cycles), "counters")
        for _ in range(20):
            fa.flash_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
        kernel_build.check_error(lib, lib.hvd_wait_cycles(cycles), "counters")
        wait, span = cycles[0] / 128, cycles[1]
        print(json.dumps({"shape": name, "b": b, "h": h, "s": s, "d": d,
                          "causal": causal, "calls": 20,
                          "wait_cycles": wait, "consumer_cycles": span,
                          "wait_share": wait / span, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
