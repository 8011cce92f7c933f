"""AdamW over every parameter leaf in one Hopper kernel launch.

Port of ``horovod_tpu/ops/pallas/fused_adamw.py``. The surface is the
same: ``fused_adamw(learning_rate, b1, b2, eps, weight_decay)`` returns a
:class:`FusedAdamW` of ``init(params)`` and ``apply(params, state, grads)
-> (params, state)``, a step-level API rather than an optimizer that
returns deltas (adding deltas would read and write every parameter once
more). The state is :class:`ScaleByAdamState`, laid out as optax's
``(count, mu, nu)``, with ``mu`` and ``nu`` dicts keyed like the params;
``models/convert.py`` carries it to and from optax. Semantics follow
``optax.adamw``: bias-corrected moments and decoupled weight decay folded
into the learning-rate step.

Departures from the JAX package, made for the card:

* ``apply`` updates the parameters and both moments in place and returns
  the same tensors, as ``torch.optim`` does, so no second copy of the
  model and its moments is made;
* every leaf goes through the kernel. The TPU version sends leaves under
  16 K elements, lengths that are not a multiple of 128 and prime row
  counts to jnp (``fused_adamw.py:99-111``): that is TPU tiling, and the
  Hopper kernel masks its own ragged tail;
* one launch covers all the leaves of one (p, mu, nu, grad) dtype
  combination (``csrc/adamw.cu`` ``adamw_multi_kernel``) where the TPU
  makes one ``pallas_call`` per leaf.

The kernel has a plain PyTorch version beside it
(:func:`adamw_leaf_reference`, written from ``_jnp_leaf``). The wrapper
:func:`adamw_multi` runs it only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises. :data:`LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from horovod_tpu_torch.ops import kernel_build

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"adamw_multi": 0}

#: dtype codes of csrc/adamw.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.hvd_adamw_chunk_elems.argtypes = []
    lib.hvd_adamw_chunk_elems.restype = I
    # table n n_chunks p_dt m_dt v_dt g_dt b1 b2 ibc1 ibc2 lr wd eps stream
    lib.hvd_adamw_multi.argtypes = [P, I, L, I, I, I, I] + [F] * 7 + [P]
    lib.hvd_adamw_multi.restype = I
    # master mu nu grad p_out n g_dt p_dt b1 b2 ibc1 ibc2 lr wd eps stream
    lib.hvd_flat_adamw.argtypes = [P] * 5 + [L, I, I] + [F] * 7 + [P]
    lib.hvd_flat_adamw.restype = I
    lib.hvd_cuda_error_string.argtypes = [I]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p


def lib() -> ctypes.CDLL:
    """The loaded ``csrc/adamw.cu`` library, built at first use."""
    return kernel_build.load("adamw", _declare)


def check_kernel_tensor(what: str, t: torch.Tensor) -> None:
    """What the kernels take: float32 or bfloat16, contiguous, 16-byte
    aligned (they read four elements at a time)."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} kernel takes contiguous tensors")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs 16-byte aligned tensors")


def adamw_scalars(count: int, b1: float, b2: float, learning_rate: float,
                  weight_decay: float) -> np.ndarray:
    """``[b1, b2, 1/(1-b1^t), 1/(1-b2^t), lr, wd]`` in float32 for step
    ``t = count``, computed in float32 as the JAX package's ``jnp`` code
    does (``fused_adamw.py:153-159``); the kernels take them by value."""
    t = np.float32(count)
    one = np.float32(1.0)
    return np.array([b1, b2, one / (one - np.float32(b1) ** t),
                     one / (one - np.float32(b2) ** t), learning_rate,
                     weight_decay], np.float32)


def scalar_tensors(scalars, eps):
    """The plain versions' scalars: 0-dim float32 tensors, so every
    operation rounds in float32 as the kernels' do (Python floats would
    give double arithmetic, e.g. in ``1 - b1``)."""
    vals = [float(x) for x in np.asarray(scalars, np.float32)] + [eps]
    return [torch.tensor(x, dtype=torch.float32) for x in vals]


def adamw_leaf_reference(p, m, v, g, scalars, eps):
    """Plain AdamW on one leaf (``_jnp_leaf``): new ``(p, m, v)`` in their
    own dtypes, the math in float32."""
    b1, b2, ibc1, ibc2, lr, wd, eps = scalar_tensors(scalars, eps)
    gf = g.float()
    mf = b1 * m.float() + (1 - b1) * gf
    vf = b2 * v.float() + (1 - b2) * gf * gf
    pf = p.float()
    pf = pf - lr * ((mf * ibc1) / (torch.sqrt(vf * ibc2) + eps) + wd * pf)
    return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)


def _launch_group(ps, ms, vs, gs, scalars, eps) -> None:
    """One kernel launch over leaves of one dtype combination."""
    lb = lib()
    chunk = lb.hvd_adamw_chunk_elems()
    sizes = np.array([p.numel() for p in ps], np.int64)
    starts = np.zeros(len(ps) + 1, np.int64)
    np.cumsum(-(-sizes // chunk), out=starts[1:])
    table = np.concatenate([
        np.array([t.data_ptr() for t in ts], np.int64)
        for ts in (ps, ms, vs, gs)] + [sizes, starts])
    device = ps[0].device
    # pinned, so the copy is queued behind the step's work instead of
    # waiting for it; the table is built anew on every call
    table_dev = torch.from_numpy(table).pin_memory().to(device,
                                                        non_blocking=True)
    codes = [DTYPE_CODES[t[0].dtype] for t in (ps, ms, vs, gs)]
    err = lb.hvd_adamw_multi(
        table_dev.data_ptr(), len(ps), int(starts[-1]), *codes,
        *(float(x) for x in scalars), float(eps),
        torch.cuda.current_stream(device).cuda_stream)
    kernel_build.check_error(lb, err, "adamw multi-tensor")
    LAUNCHES["adamw_multi"] += 1


@torch.no_grad()
def adamw_multi(params: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                nus: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                scalars, *, eps: float) -> None:
    """AdamW on every leaf, in place: ``params[i]``, ``mus[i]`` and
    ``nus[i]`` take their new values. On CUDA tensors, one kernel launch
    per (p, mu, nu, grad) dtype combination; on CPU tensors, the plain
    version leaf by leaf."""
    leaves = list(zip(params, mus, nus, grads, strict=True))
    for p, m, v, g in leaves:
        if not p.shape == m.shape == v.shape == g.shape:
            raise ValueError(f"adamw leaf shapes differ: p {tuple(p.shape)}"
                             f", mu {tuple(m.shape)}, nu {tuple(v.shape)}, "
                             f"grad {tuple(g.shape)}")
    leaves = [leaf for leaf in leaves if leaf[0].numel()]
    if not leaves:
        return
    if kernel_build.on_cpu("adamw", [t for leaf in leaves for t in leaf]):
        for p, m, v, g in leaves:
            for t, new in zip((p, m, v),
                              adamw_leaf_reference(p, m, v, g, scalars, eps)):
                t.copy_(new)
        return
    groups: Dict[tuple, list] = {}
    for leaf in leaves:
        for t in leaf:
            check_kernel_tensor("adamw", t)
        groups.setdefault(tuple(t.dtype for t in leaf), []).append(leaf)
    for group in groups.values():
        _launch_group(*zip(*group), scalars, eps)


class ScaleByAdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` layout: the step count and the first
    and second moments, dicts keyed like the params."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class FusedAdamW(NamedTuple):
    """Step-level fused AdamW: ``apply(params, state, grads)``."""

    init: callable
    apply: callable


def check_keys(params, grads) -> None:
    """Gradients must be keyed exactly like the params."""
    if set(grads) != set(params):
        missing = sorted(set(params) - set(grads))
        extra = sorted(set(grads) - set(params))
        raise ValueError(f"gradients are keyed unlike the params: missing "
                         f"{missing}, unexpected {extra}")


def fused_adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 1e-4) -> FusedAdamW:
    """AdamW on the multi-tensor kernel. ``params`` and ``grads`` are dicts
    of tensors keyed alike (``dict(model.named_parameters())``); ``apply``
    updates the params and the state's moments in place and returns
    ``(params, new_state)``."""

    def init(params: Dict[str, torch.Tensor]) -> ScaleByAdamState:
        return ScaleByAdamState(
            count=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def apply(params, state: ScaleByAdamState, grads):
        check_keys(params, grads)
        count = min(state.count + 1, _INT32_MAX)  # optax.safe_int32_increment
        keys = list(params)
        adamw_multi([params[k] for k in keys], [state.mu[k] for k in keys],
                    [state.nu[k] for k in keys], [grads[k] for k in keys],
                    adamw_scalars(count, b1, b2, learning_rate, weight_decay),
                    eps=eps)
        return params, ScaleByAdamState(count, state.mu, state.nu)

    return FusedAdamW(init=init, apply=apply)
