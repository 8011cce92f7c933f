"""Flash attention on hand-written Hopper kernels, with autograd.

Port of ``horovod_tpu/ops/pallas/flash_attention.py``. The public contract
is the same: ``flash_attention(q, k, v, *, causal, sm_scale, q_offset,
k_offset)`` over ``(batch, heads, seq, head_dim)``, differentiable, and
``flash_attention_partial`` returning ``(o, lse)`` with ``lse`` of shape
``(batch, heads, seq)`` in float32, natural log. ``q_offset``/``k_offset``
are the global positions of the first query/key row, so the causal mask
``q_offset + i >= k_offset + j`` follows global positions (ring attention).
A row whose keys are all masked gives ``o = 0`` and ``lse = -inf``.

Four CUDA kernels (``csrc/flash_attention.cu``) do the work on the card:
the forward, dq, dk/dv, and the fused dq/dk/dv backward. Each has a plain
PyTorch version beside it here (``*_reference``), written from the JAX
package's ``attention_reference`` and the backward formulas. A wrapper runs
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. Each wrapper counts its launches in
:data:`LAUNCHES`.

The backward takes the fused kernel when ``FLASH_FUSED_BWD=1`` and both
extents are at most :data:`FUSED_MAX_SEQ` (the JAX package's rule at its
default backward blocks of 1024, ``flash_attention.py:741-742``); else dq
and dk/dv. The switch is read at each backward call (the JAX package reads
it when it traces). ``FLASH_MXU_BF16`` is not read: the kernels always
feed bf16 to the tensor cores and round p and dS to bf16, which is that
switch's bf16 side.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from horovod_tpu_torch.ops import kernel_build
from horovod_tpu_torch.utils import env

NEG_INF = float("-inf")
HEAD_DIMS = (64, 128)
#: longest query or key extent the fused backward takes under the switch
#: (the JAX package's default backward block)
FUSED_MAX_SEQ = 1024

#: kernel launches since the last :func:`reset_launch_counts`, per kernel
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_bwd_fused": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    scalars = [I, I, I, I, F, I, I, I, P]  # BH Sq Sk D scale causal qo ko stream
    lib.hvd_flash_fwd.argtypes = [P] * 5 + scalars
    lib.hvd_flash_bwd_dq.argtypes = [P] * 7 + scalars
    lib.hvd_flash_bwd_dkv.argtypes = [P] * 8 + scalars
    lib.hvd_flash_bwd_fused.argtypes = [P] * 11 + scalars
    for fn in (lib.hvd_flash_fwd, lib.hvd_flash_bwd_dq, lib.hvd_flash_bwd_dkv,
               lib.hvd_flash_bwd_fused):
        fn.restype = ctypes.c_int
    lib.hvd_flash_bwd_fused_turns.argtypes = [I, I]
    lib.hvd_flash_bwd_fused_turns.restype = ctypes.c_longlong
    lib.hvd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return kernel_build.load("flash_attention", _declare)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _scores(q, k, causal, sm_scale, q_offset, k_offset):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        qi = q_offset + torch.arange(q.shape[2], device=q.device)
        kj = k_offset + torch.arange(k.shape[2], device=q.device)
        s = s.masked_fill(qi[:, None] < kj[None, :], NEG_INF)
    return s


def _safe(lse):
    """lse with fully masked rows (-inf) shifted to 0: exp(s - 0) of an
    all -inf row is 0, not NaN."""
    return torch.where(lse == NEG_INF, torch.zeros_like(lse), lse)


def _probs(q, k, lse, causal, sm_scale, q_offset, k_offset):
    s = _scores(q, k, causal, sm_scale, q_offset, k_offset)
    return torch.exp(s - _safe(lse)[..., None])


def flash_fwd_reference(q, k, v, *, causal, sm_scale, q_offset, k_offset):
    """Plain forward: ``(o, lse)``, computed in float32."""
    s = _scores(q, k, causal, sm_scale, q_offset, k_offset)
    lse = torch.logsumexp(s, dim=-1)  # -inf for fully masked rows
    p = torch.exp(s - _safe(lse)[..., None])
    return (p @ v.float()).to(q.dtype), lse


def _dscores(p, v, do, delta, sm_scale):
    dp = do.float() @ v.float().transpose(-1, -2)
    return p * (dp - delta[..., None]) * sm_scale


def flash_bwd_dq_reference(q, k, v, do, lse, delta, *, causal, sm_scale,
                           q_offset, k_offset):
    """Plain dq = sum_j ds_ij k_j, with ds = p (do.v - delta) sm_scale."""
    p = _probs(q, k, lse, causal, sm_scale, q_offset, k_offset)
    ds = _dscores(p, v, do, delta, sm_scale)
    return (ds @ k.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, do, lse, delta, *, causal, sm_scale,
                            q_offset, k_offset):
    """Plain dk = ds^T q and dv = p^T do."""
    p = _probs(q, k, lse, causal, sm_scale, q_offset, k_offset)
    ds = _dscores(p, v, do, delta, sm_scale)
    dv = p.transpose(-1, -2) @ do.float()
    dk = ds.transpose(-1, -2) @ q.float()
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_reference(q, k, v, do, lse, delta, *, causal, sm_scale,
                              q_offset, k_offset):
    """Plain fused backward: p once, then dv = p^T do, ds = p (do.v -
    delta) sm_scale, dq = ds k and dk = ds^T q from it."""
    p = _probs(q, k, lse, causal, sm_scale, q_offset, k_offset)
    ds = _dscores(p, v, do, delta, sm_scale)
    dv = p.transpose(-1, -2) @ do.float()
    dq = ds @ k.float()
    dk = ds.transpose(-1, -2) @ q.float()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def compute_delta(o, do) -> torch.Tensor:
    """The backward's per-row term delta_i = sum_d do[i, d] o[i, d], shape
    (B, H, S), float32."""
    return (do.float() * o.float()).sum(dim=-1)


# ---------------------------------------------------------------------------
# Wrappers: plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------


def _on_cpu(*tensors) -> bool:
    return kernel_build.on_cpu("flash attention", tensors)


def _check_kernel_inputs(q, k, v, *rest):
    """What the CUDA kernels take: bf16, contiguous (B, H, S, D) with
    D in HEAD_DIMS, 16-byte aligned, B*H within the grid's y extent."""
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the grid limit 65535")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs a non-empty sequence")
    for t in (q, k, v, *rest):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash attention kernel takes bfloat16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernel takes contiguous "
                             "(batch, heads, seq, head_dim) tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash attention kernel needs 16-byte aligned "
                             "tensors")


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention expects (batch, heads, seq, dim)")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"incompatible q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")


def _raise_on(err: int, what: str) -> None:
    kernel_build.check_error(_lib(), err, what)


def _scalars(q, k, causal, sm_scale, q_offset, k_offset):
    b, h, sq, d = q.shape
    return (b * h, sq, k.shape[2], d, float(sm_scale), int(bool(causal)),
            int(q_offset), int(k_offset),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, *, causal, sm_scale, q_offset, k_offset):
    """Forward: ``(o, lse)``. The kernel for CUDA tensors."""
    _check_shapes(q, k, v)
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              k_offset=k_offset)
    if _on_cpu(q, k, v):
        return flash_fwd_reference(q, k, v, **kw)
    _check_kernel_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = _lib().hvd_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_scalars(q, k, **kw))
    _raise_on(err, "flash forward")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal, sm_scale, q_offset,
                 k_offset):
    """dq. The kernel for CUDA tensors."""
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              k_offset=k_offset)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dq_reference(q, k, v, do, lse, delta, **kw)
    _check_kernel_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    err = _lib().hvd_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_scalars(q, k, **kw))
    _raise_on(err, "flash dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal, sm_scale, q_offset,
                  k_offset):
    """(dk, dv). The kernel for CUDA tensors."""
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              k_offset=k_offset)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_dkv_reference(q, k, v, do, lse, delta, **kw)
    _check_kernel_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _lib().hvd_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_scalars(q, k, **kw))
    _raise_on(err, "flash dk/dv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def flash_bwd_fused(q, k, v, do, lse, delta, *, causal, sm_scale, q_offset,
                    k_offset):
    """(dq, dk, dv) from one kernel that computes s and p once. The kernel
    for CUDA tensors; it takes any extent, but the backward sends it only
    extents up to :data:`FUSED_MAX_SEQ`. It sums dq across its key items
    in a fixed order in a float32 scratch of (B, H, Sq, D), with int32 turn
    counters (two per batch*head and query tile of 64, zeroed by the
    launch); the wrapper allocates both."""
    kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
              k_offset=k_offset)
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_bwd_fused_reference(q, k, v, do, lse, delta, **kw)
    _check_kernel_inputs(q, k, v, do)
    _check_rows(q, lse, delta)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lib = _lib()
    turns = torch.empty(
        lib.hvd_flash_bwd_fused_turns(q.shape[0] * q.shape[1], q.shape[2]),
        dtype=torch.int32, device=q.device)
    err = lib.hvd_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), turns.data_ptr(),
        *_scalars(q, k, **kw))
    _raise_on(err, "flash fused backward")
    LAUNCHES["flash_bwd_fused"] += 1
    return dq, dk, dv


def uses_fused_bwd(q, k) -> bool:
    """Whether a backward over these inputs takes the fused kernel:
    ``FLASH_FUSED_BWD`` set and both extents within :data:`FUSED_MAX_SEQ`."""
    return (env.flash_fused_bwd() and q.shape[2] <= FUSED_MAX_SEQ
            and k.shape[2] <= FUSED_MAX_SEQ)


def _check_rows(q, lse, delta):
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 of shape "
                             f"{tuple(q.shape[:3])}")


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, then the fused kernel or the dq and dk/dv kernels in
    the backward (the ``jax.custom_vjp`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, k_offset):
        kw = dict(causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                  k_offset=k_offset)
        o, lse = flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = compute_delta(o, do)
        if uses_fused_bwd(q, k):
            dq, dk, dv = flash_bwd_fused(q, k, v, do, lse, delta, **ctx.kw)
        else:
            dq = flash_bwd_dq(q, k, v, do, lse, delta, **ctx.kw)
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _scale(q, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    q_offset: int = 0, k_offset: int = 0) -> torch.Tensor:
    """Fused attention over ``(batch, heads, seq, head_dim)`` inputs,
    differentiable in q, k and v. ``sm_scale`` defaults to
    ``1/sqrt(head_dim)``."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, sm_scale),
                                 int(q_offset), int(k_offset))


def flash_attention_partial(q, k, v, *, causal: bool = False,
                            sm_scale: Optional[float] = None,
                            q_offset: int = 0, k_offset: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward only: ``(o, lse)``, with ``o`` normalised over these keys and
    ``lse`` their per-row log-sum-exp, for exact merging of partials."""
    return flash_fwd(q, k, v, causal=bool(causal),
                     sm_scale=_scale(q, sm_scale), q_offset=int(q_offset),
                     k_offset=int(k_offset))
