#!/usr/bin/env python3
"""A 3x3 convolution with the batch-norm statistics as its epilogue: the
probe of whether the BN statistics pass can ride on the conv kernel.

Port of ``tools/pallas_conv_bn.py``. :func:`conv3x3_bn_stats` takes the
tool's layout: ``x_padded`` (N, H+2, W+2, Cin) bf16 (one pixel of zeros on
each side, so the conv is SAME on the image) and ``w`` (3, 3, Cin, Cout)
bf16; it returns ``y`` (N, H, W, Cout) bf16 and the per-channel ``sum`` and
``sumsq`` (Cout,) float32 of the unrounded float32 conv, as the TPU kernel
takes them. For CUDA tensors that is kernel B11 (``csrc/conv_bn_stats.cu``:
the implicit-GEMM conv on wgmma, weights by TMA and the im2col gather by
cp.async, with the sums in its epilogue into a per-tile scratch, then a
kernel that sums the scratch in a fixed order); for CPU tensors its plain
version :func:`conv3x3_bn_stats_plain` (a float32 conv of the bf16 values,
``y`` rounded to bf16, the sums over the float32 result: the tool's own
check). :data:`LAUNCHES` counts both kernels' launches.

    python3 -m horovod_tpu_torch.tools.conv_bn_probe           # one shape
    python3 -m horovod_tpu_torch.tools.conv_bn_probe --sweep   # four

needs a CUDA device and prints one JSON line per shape: the fused kernel's
time beside cuDNN's conv alone and cuDNN's conv plus a separate statistics
pass (yardsticks the port never calls), each as MFU against the H100's
989 TFLOP/s, with the card's name and power limit. No model calls this
probe, as no model of the JAX package calls the tool.
``tools/conv_before_after.py --other <checkout>`` times this kernel of two
checkouts in turns.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import kernel_build
from horovod_tpu_torch.utils.measure import card_line, time_ms

PEAK_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
#: the tool's shape (ResNet-50 stage 3) and its sweep (each stage's 3x3)
BATCH, SIZE, CHANNELS = 128, 14, 256
SWEEP = ((56, 64), (28, 128), (14, 256), (7, 512))
#: the tool's limits (tools/pallas_conv_bn.py:238-250): y rtol and atol,
#: sum rtol and atol, sumsq rtol
TOL = dict(y=(2e-2, 2e-2), sum=(1e-2, 2.0), sumsq=(1e-2, 0.0))

#: kernel launches since the last reset: the conv and the column sums
LAUNCHES = {"conv_bn_stats": 0}


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.hvd_conv_bn_stats_tiles.argtypes = [I, I, I]
    lib.hvd_conv_bn_stats_tiles.restype = I
    lib.hvd_conv3x3_stats.argtypes = [P] * 5 + [I] * 5 + [P]
    lib.hvd_conv3x3_stats.restype = I
    lib.hvd_column_sums.argtypes = [P] * 4 + [I, I, P]
    lib.hvd_column_sums.restype = I
    lib.hvd_cuda_error_string.argtypes = [I]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return kernel_build.load("conv_bn_stats", _declare)


def _shapes(x_padded: torch.Tensor, w: torch.Tensor):
    if x_padded.ndim != 4 or w.ndim != 4 or w.shape[:2] != (3, 3) \
            or w.shape[2] != x_padded.shape[3]:
        raise ValueError(f"conv3x3_bn_stats takes x_padded (N, H+2, W+2, "
                         f"Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x_padded.shape)} and {tuple(w.shape)}")
    n, hp, wp, cin = x_padded.shape
    if hp < 3 or wp < 3:
        raise ValueError("x_padded must be at least 3 x 3")
    return n, hp - 2, wp - 2, cin, w.shape[3]


def conv3x3_bn_stats_plain(x_padded: torch.Tensor, w: torch.Tensor):
    """Plain version: a float32 conv of the bf16 values; ``y`` rounded to
    bf16; ``sum`` and ``sumsq`` over the float32 result."""
    yf = F.conv2d(x_padded.float().permute(0, 3, 1, 2),
                  w.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return (yf.to(torch.bfloat16), yf.sum((0, 1, 2)),
            (yf * yf).sum((0, 1, 2)))


def conv3x3_bn_stats(x_padded: torch.Tensor, w: torch.Tensor):
    """``(y, sum, sumsq)`` of the 3x3 conv of ``x_padded`` by ``w``: kernel
    B11 for CUDA tensors (bf16, contiguous, Cin % 32 == 0, Cout % 64 ==
    0), the plain version for CPU tensors."""
    n, h, wd, cin, cout = _shapes(x_padded, w)
    if kernel_build.on_cpu("conv3x3_bn_stats", (x_padded, w)):
        return conv3x3_bn_stats_plain(x_padded, w)
    for name, t in (("x_padded", x_padded), ("w", w)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"conv3x3_bn_stats kernel takes a contiguous, "
                             f"16-byte aligned bfloat16 {name}")
    if cin % 32 or cout % 64:
        raise ValueError(f"conv3x3_bn_stats kernel takes Cin % 32 == 0 and "
                         f"Cout % 64 == 0, got {cin} -> {cout}")
    if x_padded.numel() >= 2**31 or n * h * wd >= 2**31:
        raise ValueError("conv3x3_bn_stats kernel indexes pixels in int32")
    lib = _lib()
    dev = x_padded.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tiles = lib.hvd_conv_bn_stats_tiles(n, h, wd)
    y = torch.empty(n, h, wd, cout, dtype=torch.bfloat16, device=dev)
    part = torch.empty(2, tiles, cout, dtype=torch.float32, device=dev)
    sums = torch.empty(2, cout, dtype=torch.float32, device=dev)
    err = lib.hvd_conv3x3_stats(x_padded.data_ptr(), w.data_ptr(),
                                y.data_ptr(), part[0].data_ptr(),
                                part[1].data_ptr(), n, h, wd, cin, cout,
                                stream)
    kernel_build.check_error(lib, err, "conv3x3 + BN statistics")
    LAUNCHES["conv_bn_stats"] += 1
    err = lib.hvd_column_sums(part[0].data_ptr(), part[1].data_ptr(),
                              sums[0].data_ptr(), sums[1].data_ptr(), tiles,
                              cout, stream)
    kernel_build.check_error(lib, err, "BN statistics column sums")
    LAUNCHES["conv_bn_stats"] += 1
    return y, sums[0], sums[1]


def conv_only(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Yardstick: cuDNN's SAME 3x3 conv of the unpadded image ``x`` (an
    NCHW view of NHWC memory, bf16) by ``w`` (OIHW, channels-last); the
    port never calls it for B11."""
    return F.conv2d(x, w, padding=1)


def conv_then_stats(x: torch.Tensor, w: torch.Tensor):
    """Yardstick: the conv, then a separate statistics pass over its bf16
    output, as the unfused BN reads it."""
    y = conv_only(x, w)
    yf = y.float()
    return y, yf.sum((0, 2, 3)), (yf * yf).sum((0, 2, 3))


def inputs(n: int, size: int, cin: int, cout: int, device, seed: int = 0):
    """The tool's data: uniform(-1, 1) images and uniform(-0.1, 0.1)
    weights from ``RandomState(seed)``, bf16; returns the image (NHWC),
    its padded copy and the weights."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (n, size, size, cin))
                         .astype(np.float32)).to(device, torch.bfloat16)
    w = torch.from_numpy(rng.uniform(-0.1, 0.1, (3, 3, cin, cout))
                         .astype(np.float32)).to(device, torch.bfloat16)
    return x, F.pad(x, (0, 0, 1, 1, 1, 1)).contiguous(), w


def work(n: int, size: int, cin: int, cout: int) -> dict:
    """Operations and bytes of one call, and the least time they take on
    an H100 SXM: read x_padded and w once, write y and the two sums."""
    flops = 2 * n * size * size * 9 * cin * cout
    nbytes = 2 * (n * (size + 2) ** 2 * cin + 9 * cin * cout
                  + n * size * size * cout) + 8 * cout
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(flops=flops, bytes=nbytes, bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops > t_bytes else "bytes")


def errors(got, want) -> dict:
    """Each output's largest absolute error, and whether all three are
    within :data:`TOL` (|got - want| <= atol + rtol |want|)."""
    out, ok = {}, True
    for name, a, b in zip(("y", "sum", "sumsq"), got, want):
        a, b = a.float(), b.float()
        rtol, atol = TOL[name]
        out[name] = (a - b).abs().max().item()
        ok = ok and bool(((a - b).abs() <= atol + rtol * b.abs()).all())
    out["ok"] = ok
    return out


def measure(n: int, size: int, cin: int, cout: int, device,
            iters: int = 20) -> dict:
    """Check B11 against its plain version at one shape (and a second call
    against the first, bit for bit), then time it, its plain version,
    cuDNN's conv alone and conv plus a stats pass."""
    x, xp, w = inputs(n, size, cin, cout, device)
    got = conv3x3_bn_stats(xp, w)
    again = conv3x3_bn_stats(xp, w)
    want = conv3x3_bn_stats_plain(xp, w)
    row = dict(shape=f"{n}x{size}x{size}x{cin}->{cout} 3x3",
               err=errors(got, want), **work(n, size, cin, cout))
    row["err"]["repeat_equal"] = all(torch.equal(a, b)
                                     for a, b in zip(got, again))
    del got, again, want
    row["ms"] = time_ms(lambda: conv3x3_bn_stats(xp, w), iters, device)
    row["plain_ms"] = time_ms(lambda: conv3x3_bn_stats_plain(xp, w), iters,
                              device)
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    row["conv_ms"] = time_ms(lambda: conv_only(xc, wc), iters, device)
    row["conv_stats_ms"] = time_ms(lambda: conv_then_stats(xc, wc), iters,
                                   device)
    for key in ("ms", "conv_ms", "conv_stats_ms"):
        row[key.replace("ms", "mfu")] = row["flops"] / (row[key] * 1e-3) \
            / PEAK_FLOPS
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="the four ResNet-50 stage shapes at batch 128 "
                         "instead of the tool's one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_bn_probe needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False  # the plain version is float32
    card = card_line()
    shapes = SWEEP if args.sweep else ((SIZE, CHANNELS),)
    ok = True
    for size, c in shapes:
        row = measure(BATCH, size, c, c, torch.device("cuda"))
        row["card"] = card
        ok = ok and row["err"]["ok"] and row["err"]["repeat_equal"]
        print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
