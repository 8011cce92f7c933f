#!/usr/bin/env python3
"""Single-k-block attention probes: what a direct softmax over the whole key
extent, and two heads packed into one 128-deep contraction, cost against
the flash kernels.

Port of ``tools/flash_vpu_probe.py``. Its public functions keep the tool's
signatures and return ``o`` of ``(batch, heads, seq, head_dim)``:
:func:`pack2_attention` (kernel B12: the heads packed in pairs by torch
outside the kernel, as the tool packs with XLA ops; ``head_dim`` 64 and an
even head count), :func:`simple1_attention` (B14) and
:func:`simple1_lse_attention` (B13, whose lse the tool drops). The lower
wrappers :func:`pack2_fwd` and :func:`simple1_fwd` take the kernels' own
layouts and give the lse. For CUDA tensors they launch the kernels of
``csrc/attention_probe.cu``; for CPU tensors their plain versions
(``*_reference``). :data:`LAUNCHES` counts each kernel's launches. The
probes are non-causal, as the tool's are. ``block_q`` is accepted and does
not change the result: the kernels' 64-row tiles are fixed, so the tool's
``blocks:BQxBK`` override (TPU block tuning) is not ported either.

    python3 -m horovod_tpu_torch.tools.flash_vpu_probe --shape bert-large \\
        --only simple1_lse

needs a CUDA device and prints one JSON line: the shape, the variant, the
time of one call in ms (CUDA events), its MFU against the H100's 989
TFLOP/s with FLOPs counted as the tool counts them (the causal half, x3
for a gradient), the card's name and power limit, and ``fused_bwd_env``
(``FLASH_FUSED_BWD``, which sends ``flash_grad``'s backward to the fused
kernel). Variants: ``flash`` and ``flash_grad`` (the port's flash
attention), ``plain`` and ``plain_grad`` (its plain versions, the tool's
``xla``), ``sdpa`` and ``sdpa_grad`` (PyTorch's
``scaled_dot_product_attention``, the tool's ``stock``: a yardstick the
port never calls), ``pack2``, ``simple1`` and ``simple1_lse``. No model
calls these probes, as no model of the JAX package calls the tool.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import kernel_build
from horovod_tpu_torch.utils import env
from horovod_tpu_torch.utils.measure import card_line, time_ms

PEAK_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet
SHAPES = {
    # (batch, heads, seq, head_dim, causal): the bench's attention shapes
    "bert-large": (8, 16, 512, 64, False),
    "gpt2": (16, 12, 1024, 64, True),
    # the long-context row, on the flash kernels' many-block path
    "longseq16k": (1, 8, 16384, 128, True),
}
PROBES = ("pack2", "simple1", "simple1_lse")
VARIANTS = ("flash", "flash_grad", "plain", "plain_grad", "sdpa",
            "sdpa_grad") + PROBES

#: kernel launches since the last reset, per kernel
LAUNCHES = dict.fromkeys(PROBES, 0)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hvd_probe_simple1.argtypes = [P] * 4 + [I, I, I, F32, P]
    lib.hvd_probe_simple1_lse.argtypes = [P] * 5 + [I, I, I, F32, P]
    lib.hvd_probe_pack2.argtypes = [P] * 4 + [I, I, F32, P]
    for fn in (lib.hvd_probe_simple1, lib.hvd_probe_simple1_lse,
               lib.hvd_probe_pack2):
        fn.restype = I
    lib.hvd_cuda_error_string.argtypes = [I]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return kernel_build.load("attention_probe", _declare)


def attn_flops(b, h, s, d, causal) -> int:
    """The tool's count: QK^T and PV, 2 MACs each; causal counts half."""
    f = 2 * 2 * b * h * s * s * d
    return f // 2 if causal else f


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracle), in float32
# ---------------------------------------------------------------------------


def simple1_reference(q, k, v, sm_scale):
    """``(o, lse)``: softmax(sm_scale q k^T) v over every key."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    lse = torch.logsumexp(s, dim=-1)
    o = torch.exp(s - lse[..., None]) @ v.float()
    return o.to(q.dtype), lse


def pack2_reference(q2, k2, v2, sm_scale):
    """o2 of the packed layout: softmax(sm_scale q2 k2^T) v2, lanes 0:64
    for rows below S and 64:128 from S on."""
    o, _ = simple1_reference(q2, k2, v2, sm_scale)
    s = k2.shape[2]
    return torch.cat([o[:, :, :s, :64], o[:, :, s:, 64:]], dim=2)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------


def _check(what, q, k, v, d_allowed):
    if q.ndim != 4 or k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{what}: incompatible q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[3] not in d_allowed:
        raise ValueError(f"{what} takes head_dim in {d_allowed}, got "
                         f"{q.shape[3]}")


def _check_kernel(what, *tensors):
    for t in tensors:
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel takes contiguous, 16-byte "
                             f"aligned bfloat16 tensors")
    if tensors[0].shape[0] * tensors[0].shape[1] > 65535:
        raise ValueError(f"{what}: batch*heads exceeds the grid limit 65535")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def simple1_fwd(q, k, v, sm_scale, with_lse: bool):
    """``(o, lse)`` of the single-k-block forward over (B, H, S, D), D 64
    or 128; ``lse`` (B, H, S) float32 when ``with_lse`` (kernel B13), else
    None (B14)."""
    _check("simple1", q, k, v, fa.HEAD_DIMS)
    if q.shape != k.shape:
        raise ValueError("simple1 takes q, k and v of one shape")
    if kernel_build.on_cpu("simple1", (q, k, v)):
        o, lse = simple1_reference(q, k, v, sm_scale)
        return o, (lse if with_lse else None)
    _check_kernel("simple1", q, k, v)
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    lib = _lib()
    if with_lse:
        lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
        err = lib.hvd_probe_simple1_lse(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), o.data_ptr(),
                                        lse.data_ptr(), b * h, s, d,
                                        float(sm_scale), _stream(q))
        name = "simple1_lse"
    else:
        lse = None
        err = lib.hvd_probe_simple1(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    o.data_ptr(), b * h, s, d,
                                    float(sm_scale), _stream(q))
        name = "simple1"
    kernel_build.check_error(lib, err, name)
    LAUNCHES[name] += 1
    return o, lse


def pack2_fwd(q2, k2, v2, sm_scale):
    """o2 (b, h/2, 2S, 64) of the packed inputs q2 (b, h/2, 2S, 128), k2 and
    v2 (b, h/2, S, 128): kernel B12 for CUDA tensors."""
    _check("pack2", q2, k2, v2, (128,))
    if q2.shape[2] != 2 * k2.shape[2]:
        raise ValueError(f"pack2 takes q2 of twice k2's rows, got "
                         f"{q2.shape[2]} and {k2.shape[2]}")
    if kernel_build.on_cpu("pack2", (q2, k2, v2)):
        return pack2_reference(q2, k2, v2, sm_scale)
    _check_kernel("pack2", q2, k2, v2)
    b, hp, s2, _ = q2.shape
    o2 = torch.empty(b, hp, s2, 64, dtype=q2.dtype, device=q2.device)
    lib = _lib()
    err = lib.hvd_probe_pack2(q2.data_ptr(), k2.data_ptr(), v2.data_ptr(),
                              o2.data_ptr(), b * hp, s2 // 2,
                              float(sm_scale), _stream(q2))
    kernel_build.check_error(lib, err, "pack2")
    LAUNCHES["pack2"] += 1
    return o2


def pack(q, k, v):
    """The tool's packed operands (``tools/flash_vpu_probe.py:116-130``):
    q2 (b, h/2, 2S, 128) with head 2i's q in lanes 0:64 of rows 0:S and
    head 2i+1's in lanes 64:128 of rows S:2S, zeros elsewhere; k2 and v2
    (b, h/2, S, 128), both heads side by side."""
    b, h, s, d = q.shape
    if d != 64 or h % 2:
        raise ValueError(f"pack2 takes head_dim 64 and an even head count, "
                         f"got {h} heads of {d}")
    qp = q.reshape(b, h // 2, 2, s, d)
    zeros = torch.zeros_like(qp[:, :, 0])
    q2 = torch.cat([torch.cat([qp[:, :, 0], zeros], dim=-1),
                    torch.cat([zeros, qp[:, :, 1]], dim=-1)], dim=2)
    k2, v2 = (torch.cat(t.reshape(b, h // 2, 2, s, d).unbind(2), dim=-1)
              for t in (k, v))
    return q2, k2, v2


def pack2_attention(q, k, v, sm_scale, block_q=512):
    """The tool's ``pack2_attention``: packs two heads per contraction,
    runs B12 and unpacks ``o`` to (b, h, s, 64)."""
    b, h, s, d = q.shape
    o2 = pack2_fwd(*pack(q, k, v), sm_scale)
    return o2.reshape(b, h // 2, 2, s, d).reshape(b, h, s, d)


def simple1_attention(q, k, v, sm_scale, block_q=512):
    """The tool's ``simple1_attention``: ``o`` from kernel B14."""
    return simple1_fwd(q, k, v, sm_scale, with_lse=False)[0]


def simple1_lse_attention(q, k, v, sm_scale, block_q=512):
    """The tool's ``simple1_lse_attention``: kernel B13 writes ``o`` and
    lse; like the tool, it returns ``o``."""
    return simple1_fwd(q, k, v, sm_scale, with_lse=True)[0]


# ---------------------------------------------------------------------------
# The measurement
# ---------------------------------------------------------------------------


def inputs(shape: str, device, seed: int = 0):
    """The tool's data: q, k, v normal(0, 0.3) from ``RandomState(seed)``,
    bf16."""
    b, h, s, d, _ = SHAPES[shape]
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32) * 0.3)
            .to(device, torch.bfloat16) for _ in range(3)]


def _plain(q, k, v, causal, sm_scale):
    return fa.flash_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale,
                                  q_offset=0, k_offset=0)[0]


def variant_fn(name: str, shape: str, q, k, v):
    """One call of ``name`` at ``shape`` on these inputs, as a function of
    no argument. A probe at a causal shape raises ValueError: the probes
    are non-causal (the tool's asserts)."""
    causal = SHAPES[shape][4]
    sm = 1.0 / float(np.sqrt(q.shape[-1]))
    if name in PROBES and causal:
        raise ValueError(f"the {name} probe is non-causal; shape {shape} is "
                         f"causal")
    base = name.removesuffix("_grad")
    if base not in ("flash", "plain", "sdpa") and name not in PROBES:
        raise ValueError(f"unknown variant {name}; one of {VARIANTS}")
    if name in PROBES:
        fn = {"pack2": pack2_attention, "simple1": simple1_attention,
              "simple1_lse": simple1_lse_attention}[name]
        return lambda: fn(q, k, v, sm)

    def attn(q_, k_, v_):
        if base == "flash":
            return fa.flash_attention(q_, k_, v_, causal=causal)
        if base == "plain":
            return _plain(q_, k_, v_, causal, sm)
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal,
                                              scale=sm)

    if base == name:
        return lambda: attn(q, k, v)
    # the gradient reaches q, k and v, as the backward kernels compute all
    qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    do = torch.ones_like(q)
    return lambda: attn(*qkv).backward(do)


def measure(shape: str, name: str, device, iters: int = 20) -> dict:
    """Time one call of a variant at a shape (CUDA events, mean of
    ``iters`` after warm-up) and its MFU as the tool counts FLOPs."""
    b, h, s, d, causal = SHAPES[shape]
    q, k, v = inputs(shape, device)
    ms = time_ms(variant_fn(name, shape, q, k, v), iters, device)
    flops = attn_flops(b, h, s, d, causal) * (3 if name.endswith("_grad")
                                              else 1)
    return dict(shape=shape, variant=name, ms=ms,
                mfu=flops / (ms * 1e-3) / PEAK_FLOPS,
                fused_bwd_env=os.environ.get(env.FLASH_FUSED_BWD, "0"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", default="bert-large", choices=sorted(SHAPES))
    ap.add_argument("--only", required=True, choices=VARIANTS)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_vpu_probe needs a CUDA device", file=sys.stderr)
        return 1
    row = measure(args.shape, args.only, torch.device("cuda"), args.iters)
    row["card"] = card_line()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
