"""Fused batch-norm apply + ReLU for the conv models, on a hand-written
Hopper kernel.

Port of ``horovod_tpu/ops/pallas/conv_bn_act.py``:

* :func:`bn_stats` — per-channel batch mean and variance in float32,
  ``var = E[x^2] - E[x]^2`` (the biased estimator), over every axis but the
  channel axis;
* :func:`scale_bias_act` — ``relu(x * s + b)`` with per-channel float32
  ``s`` and ``b``, differentiable. The forward is kernel B10
  (``csrc/conv_bn_act.cu``) for CUDA tensors and its plain version
  :func:`sba_plain` for CPU tensors; the backward is the masked chain of the
  JAX package's ``_sba_bwd`` in PyTorch (the TPU has no backward kernel);
* :class:`FusedBatchNormAct` — flax ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-3)`` + ReLU with the same variables (``scale``, ``bias``
  parameters, ``mean``, ``var`` running statistics) and update rule.

Layout: the port keeps activations as NCHW tensors in channels-last memory
(``x.permute(0, 3, 1, 2)`` of an NHWC tensor), so the channel axis is dim 1
and innermost in memory, as the TPU kernel assumed. The kernel takes any
``(N, C, ...)`` tensor whose channel axis is innermost in memory.

Departures from the JAX package, made for the card: ``HOROVOD_FUSED_BN_ACT``
is not read (on the TPU it picks jnp over the kernel; here a CUDA tensor
takes the kernel or the wrapper raises), and the TPU's lane gating (16 K
elements, ``C % 128``, ``128 % C``, 8 rows) is not kept: every shape goes
through the kernel, which masks its ragged tail. :data:`LAUNCHES` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch import nn

from horovod_tpu_torch.ops import kernel_build

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"sba": 0}

#: dtype codes of csrc/conv_bn_act.cu
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int
    # x s b y n C dtype stream
    lib.hvd_sba.argtypes = [P, P, P, P, ctypes.c_longlong, I, I, P]
    lib.hvd_sba.restype = I
    lib.hvd_cuda_error_string.argtypes = [I]
    lib.hvd_cuda_error_string.restype = ctypes.c_char_p


def _lib() -> ctypes.CDLL:
    return kernel_build.load("conv_bn_act", _declare)


def _reduce_dims(x: torch.Tensor) -> list:
    return [0] + list(range(2, x.ndim))


def per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast along dim 1 of ``x``."""
    return v.view((-1,) + (1,) * (x.ndim - 2))


def bn_stats(x: torch.Tensor):
    """Per-channel (dim 1) batch mean and biased variance in one float32
    pass: ``var = E[x^2] - E[x]^2`` (``conv_bn_act.py:52-61``)."""
    xf = x.float()
    dims = _reduce_dims(x)
    mean = xf.mean(dims)
    var = (xf * xf).mean(dims) - mean * mean
    return mean, var


def sba_plain(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor):
    """Plain ``relu(x * s + b)``: float32 math, each operation rounded, the
    result in x's dtype (``_sba_jnp``)."""
    y = x.float() * per_channel(s, x) + per_channel(b, x)
    return torch.clamp_min(y, 0.0).to(x.dtype)


def channels_innermost(x: torch.Tensor) -> bool:
    """Whether the channel axis (dim 1) is innermost and the tensor dense:
    channels-last contiguous for 4-d tensors."""
    return x.movedim(1, -1).is_contiguous()


def sba(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``relu(x * s + b)`` over channel dim 1: kernel B10 for CUDA tensors,
    :func:`sba_plain` for CPU tensors. No autograd."""
    if x.ndim < 2:
        raise ValueError(f"scale_bias_act takes (N, C, ...) tensors, got "
                         f"shape {tuple(x.shape)}")
    c = x.shape[1]
    for name, v in (("s", s), ("b", b)):
        if v.shape != (c,) or v.dtype != torch.float32:
            raise ValueError(f"scale_bias_act: {name} must be float32 of "
                             f"shape ({c},), got {v.dtype} "
                             f"{tuple(v.shape)}")
    if kernel_build.on_cpu("scale_bias_act", (x, s, b)):
        return sba_plain(x, s, b)
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"scale_bias_act kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not channels_innermost(x):
        raise ValueError("scale_bias_act kernel takes channels-last "
                         "contiguous tensors (channel axis innermost); got "
                         f"strides {x.stride()} for shape {tuple(x.shape)}")
    s, b = s.contiguous(), b.contiguous()
    y = torch.empty_like(x)  # the same channels-last strides
    if x.numel() == 0:
        return y
    err = _lib().hvd_sba(x.data_ptr(), s.data_ptr(), b.data_ptr(),
                         y.data_ptr(), x.numel(), c, DTYPE_CODES[x.dtype],
                         torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check_error(_lib(), err, "scale_bias_act")
    LAUNCHES["sba"] += 1
    return y


class _ScaleBiasAct(torch.autograd.Function):
    """Kernel B10 forward; the backward of ``_sba_bwd`` (``:145-155``):
    the gradient passes where ``x*s + b > 0``, ``dx`` in x's dtype, ``ds``
    and ``db`` summed in float32."""

    @staticmethod
    def forward(ctx, x, s, b):
        ctx.save_for_backward(x, s, b)
        return sba(x, s, b)

    @staticmethod
    def backward(ctx, g):
        x, s, b = ctx.saved_tensors
        xf, sc = x.float(), per_channel(s, x)
        gm = torch.where(xf * sc + per_channel(b, x) > 0.0, g.float(), 0.0)
        dims = _reduce_dims(x)
        return (gm * sc).to(x.dtype), (gm * xf).sum(dims), gm.sum(dims)


def scale_bias_act(x: torch.Tensor, s: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """``relu(x * s + b)`` with per-channel float32 ``s``/``b`` over channel
    dim 1, differentiable in all three."""
    return _ScaleBiasAct.apply(x, s, b)


class FusedBatchNormAct(nn.Module):
    """flax ``nn.BatchNorm(momentum, epsilon)`` + ReLU as one fused
    epilogue: the JAX ``FusedBatchNormAct`` (``conv_bn_act.py:169-198``).

    Parameters ``scale`` (ones) and ``bias`` (zeros) and buffers ``mean``
    (zeros) and ``var`` (ones), all float32 of shape (C,). In training mode
    the batch statistics normalise and the buffers take ``m * running +
    (1 - m) * batch`` (the biased variance, flax's momentum); in eval mode
    the buffers normalise. Gradients reach x through the apply and through
    the batch statistics."""

    def __init__(self, features: int, momentum: float = 0.9,
                 epsilon: float = 1e-3, device=None):
        super().__init__()
        self.momentum, self.epsilon = momentum, epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    _batch_stats = staticmethod(bn_stats)

    def statistics(self, x: torch.Tensor):
        """The (mean, var) that normalise ``x``: the batch's in training
        mode, where they also update the running buffers, else the
        buffers."""
        if not self.training:
            return self.mean, self.var
        mean, var = self._batch_stats(x)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1.0 - m) * mean)
            self.var.copy_(m * self.var + (1.0 - m) * var)
        return mean, var

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, var = self.statistics(x)
        s = self.scale * torch.rsqrt(var + self.epsilon)
        return scale_bias_act(x, s, self.bias - mean * s)
