"""Inception-V3 in PyTorch, training path.

Port of ``horovod_tpu/models/inception.py``: the space-to-depth stem, the
mixed blocks A-E and the classifier, with the flax modules' numerics:

* parameters are float32, compute is ``dtype`` (bfloat16 by default): each
  conv and the classifier cast their input and a copy of their weights to
  ``dtype``, as ``nn.Conv(dtype=bf16, param_dtype=f32)`` does; the input is
  cast at entry and the logits leave in float32;
* every ``ConvBN`` and the stem end in :class:`FusedBatchNormAct` (kernel
  B10 on the card), the JAX package's default (``fused=True``);
* flax ``"SAME"`` padding at stride 1 (odd kernels) is ``k // 2`` on each
  side; the strided convs and the max pools are ``VALID``; the 3x3 average
  pool is ``SAME`` and counts the padding, as flax's ``avg_pool`` does.

Layout: the public input is NHWC, as in JAX. Inside, activations are NCHW
tensors in channels-last memory (the channel axis innermost, as on the
TPU); ``torch.cat`` along dim 1 keeps that layout.

Submodules carry flax's names (``ConvBN_0``, ``InceptionA_1``,
``Conv_0``, ``BatchNorm_0``, ``SpaceToDepthStem_0``,
``FusedBatchNormAct_0``, ``classifier``), numbered in flax's order of
construction, so ``models/convert.py`` maps the two trees by name. In a
nested call ``c(a)(c(b)(x))`` flax constructs, and so numbers, the outer
module first.

Initial weights are flax's initialisers drawn from ``torch.Generator(seed)``:
convs ``variance_scaling(1, fan_in, truncated_normal)``, the stem
he-normal (scale 2), the classifier LeCun-normal with a zero bias. The
values differ from JAX's; the tests carry weights across.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.ops.conv_bn_act import FusedBatchNormAct
from horovod_tpu_torch.utils.device import resolve


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    a normal truncated at 2 std, with variance ``scale / fan_in``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def _weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """A conv weight's compute copy: ``dtype``, channels-last, so cuDNN
    keeps the activations channels-last without converting it per call."""
    return w.to(dtype, memory_format=torch.channels_last)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)``: ``kernel`` is float32 in PyTorch's
    (out, in, kh, kw) layout (flax's is (kh, kw, in, out))."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int], strides: Sequence[int] = (1, 1),
                 padding: str = "SAME", dtype=torch.bfloat16, device=None):
        super().__init__()
        kernel, strides = tuple(kernel), tuple(strides)
        if padding == "SAME":
            if strides != (1, 1) or not all(k % 2 for k in kernel):
                raise ValueError("SAME padding is ported for stride 1 and "
                                 "odd kernels only")
            self.padding = tuple(k // 2 for k in kernel)
        elif padding == "VALID":
            self.padding = (0, 0)
        else:
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.stride, self.dtype = strides, dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, *kernel,
                                               device=device))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), _weight(self.kernel, self.dtype),
                        stride=self.stride, padding=self.padding)


class ConvBN(nn.Module):
    """Conv, then batch norm and ReLU as one :class:`FusedBatchNormAct`,
    named ``BatchNorm_0`` as flax names it."""

    def __init__(self, in_features: int, features: int,
                 kernel: Sequence[int] = (3, 3),
                 strides: Sequence[int] = (1, 1), padding: str = "SAME",
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           dtype, device)
        self.BatchNorm_0 = FusedBatchNormAct(features, device=device)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


class SpaceToDepthStem(nn.Module):
    """Inception's 3x3/2 VALID stem conv as the JAX package computes it: pad
    an odd image by one row and column at the end, 2x2 space-to-depth to
    12 channels, and fold the 3x3 stride-2 kernel into a 2x2 stride-1 one
    over them (the tap that would read the padding gets a zero weight). The
    output equals the direct conv's. ``kernel`` keeps the canonical shape,
    (filters, 3, 3, 3) here. Takes NHWC, returns NCHW channels-last."""

    def __init__(self, filters: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.filters, self.dtype = filters, dtype
        self.kernel = nn.Parameter(torch.empty(filters, 3, 3, 3,
                                               device=device))

    def folded_kernel(self) -> torch.Tensor:
        """The (filters, 12, 2, 2) kernel over the space-to-depth input:
        ``w2[t, s, 6a + 3b + c] = w3[2t + a, 2s + b, c]`` in HWIO terms."""
        w4 = F.pad(self.kernel.permute(2, 3, 1, 0), (0, 0, 0, 0, 0, 1, 0, 1))
        w2 = w4.reshape(2, 2, 2, 2, 3, self.filters).permute(0, 2, 1, 3, 4, 5)
        return w2.reshape(2, 2, 12, self.filters).permute(3, 2, 0, 1)

    def forward(self, x):
        n, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            n, h, w, c = x.shape
        y = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(n, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)
        return F.conv2d(y.to(self.dtype),
                        _weight(self.folded_kernel(), self.dtype))


def _box3(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


class _AvgPoolSame(torch.autograd.Function):
    """flax's ``avg_pool((3, 3), strides=(1, 1), padding="SAME")``, which
    counts the padding: a 3x3 box filter over zero padding with the
    constant divisor 9. That filter is its own adjoint, so the backward is
    the same pool over the gradient. PyTorch's own backward of
    ``avg_pool2d`` gave wrong gradients for channels-last CUDA tensors
    (torch 2.11 + CUDA 12.8 on an H100: relative error ~1), while its
    forward is right on every layout."""

    @staticmethod
    def forward(ctx, x):
        return _box3(x)

    @staticmethod
    def backward(ctx, g):
        return _box3(g)


def _avg_pool_same(x):
    return _AvgPoolSame.apply(x)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


def _run(chain, x):
    for m in chain:
        x = m(x)
    return x


Spec = Tuple  # (features, kernel[, strides[, padding]])


class _FlaxNamed(nn.Module):
    """Registers children under flax's auto-names: ``<Class>_<n>``, ``n``
    counting that class's children in order of construction."""

    def __init__(self, dtype, device):
        super().__init__()
        self.dtype = dtype
        self._kw = dict(dtype=dtype, device=device)

    def _child(self, module: nn.Module) -> nn.Module:
        kind = type(module).__name__
        n = sum(1 for name in self._modules if name.rsplit("_", 1)[0] == kind)
        self.add_module(f"{kind}_{n}", module)
        return module

    def _convs(self, in_features: int, *specs: Spec, nested: bool = False):
        """ConvBNs applied in the order of ``specs`` to ``in_features``
        channels, returned in that order. ``nested=True`` is flax's
        ``c(a)(c(b)(x))``: constructed, and so named, last to first."""
        cins = [in_features] + [spec[0] for spec in specs[:-1]]
        mods = [None] * len(specs)
        order = range(len(specs))
        for i in (reversed(order) if nested else order):
            mods[i] = self._child(ConvBN(cins[i], *specs[i], **self._kw))
        return mods


class InceptionA(_FlaxNamed):
    def __init__(self, in_features: int, pool_features: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        c = in_features
        self.b1 = self._convs(c, (64, (1, 1)))
        self.b2 = self._convs(c, (48, (1, 1)), (64, (5, 5)), nested=True)
        self.b3 = self._convs(c, (64, (1, 1)), (96, (3, 3)), (96, (3, 3)),
                              nested=True)
        self.b4 = self._convs(c, (pool_features, (1, 1)))
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_run(self.b1, x), _run(self.b2, x),
                          _run(self.b3, x), _run(self.b4, _avg_pool_same(x))],
                         dim=1)


class InceptionB(_FlaxNamed):
    def __init__(self, in_features: int, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        c = in_features
        self.b1 = self._convs(c, (384, (3, 3), (2, 2), "VALID"))
        self.b2 = self._convs(c, (64, (1, 1)), (96, (3, 3)),
                              (96, (3, 3), (2, 2), "VALID"), nested=True)
        self.out_features = 384 + 96 + in_features

    def forward(self, x):
        return torch.cat([_run(self.b1, x), _run(self.b2, x), _max_pool(x)],
                         dim=1)


class InceptionC(_FlaxNamed):
    def __init__(self, in_features: int, channels_7x7: int,
                 dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        c, c7 = in_features, channels_7x7
        self.b1 = self._convs(c, (192, (1, 1)))
        self.b2 = self._convs(c, (c7, (1, 1)), (c7, (1, 7)), (192, (7, 1)),
                              nested=True)
        self.b3 = self._convs(c, (c7, (1, 1)), (c7, (7, 1)), (c7, (1, 7)),
                              (c7, (7, 1)), (192, (1, 7)))
        self.b4 = self._convs(c, (192, (1, 1)))
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([_run(self.b1, x), _run(self.b2, x),
                          _run(self.b3, x), _run(self.b4, _avg_pool_same(x))],
                         dim=1)


class InceptionD(_FlaxNamed):
    def __init__(self, in_features: int, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        c = in_features
        self.b1 = self._convs(c, (192, (1, 1)), (320, (3, 3), (2, 2), "VALID"),
                              nested=True)
        self.b2 = self._convs(c, (192, (1, 1)), (192, (1, 7)), (192, (7, 1)),
                              (192, (3, 3), (2, 2), "VALID"))
        self.out_features = 320 + 192 + in_features

    def forward(self, x):
        return torch.cat([_run(self.b1, x), _run(self.b2, x), _max_pool(x)],
                         dim=1)


class InceptionE(_FlaxNamed):
    def __init__(self, in_features: int, dtype=torch.bfloat16, device=None):
        super().__init__(dtype, device)
        c = in_features
        self.b1 = self._convs(c, (320, (1, 1)))
        self.b2 = self._convs(c, (384, (1, 1)))
        self.b2_split = (self._convs(384, (384, (1, 3)))
                         + self._convs(384, (384, (3, 1))))
        self.b3 = self._convs(c, (448, (1, 1)), (384, (3, 3)), nested=True)
        self.b3_split = (self._convs(384, (384, (1, 3)))
                         + self._convs(384, (384, (3, 1))))
        self.b4 = self._convs(c, (192, (1, 1)))
        self.out_features = 320 + 2 * 768 + 192

    def forward(self, x):
        b2, b3 = _run(self.b2, x), _run(self.b3, x)
        return torch.cat([_run(self.b1, x)] + [m(b2) for m in self.b2_split]
                         + [m(b3) for m in self.b3_split]
                         + [_run(self.b4, _avg_pool_same(x))], dim=1)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel`` float32 in PyTorch's (out, in) layout
    (flax's is (in, out)), ``bias`` float32; computes in ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype),
                        self.bias.to(self.dtype))


class InceptionV3(_FlaxNamed):
    """Inception-V3 on (N, H, W, 3) images (299 x 299 canonical), returning
    float32 (N, num_classes) logits. Train or eval mode is the module's
    (``model.train()``/``model.eval()``), flax's ``train`` argument.
    Parameters are made on ``device`` (default: the card, see
    :func:`horovod_tpu_torch.utils.device.resolve`) from ``seed``."""

    def __init__(self, num_classes: int = 1000, dtype=torch.bfloat16,
                 device=None, seed: int = 0):
        device = resolve(device)
        super().__init__(dtype, device)
        self.stem = [self._child(SpaceToDepthStem(32, dtype, device)),
                     self._child(FusedBatchNormAct(32, device=device))]
        self.stem += self._convs(32, (32, (3, 3), (1, 1), "VALID"))
        self.stem += self._convs(32, (64, (3, 3)))
        self.stem2 = self._convs(64, (80, (1, 1), (1, 1), "VALID"),
                                 (192, (3, 3), (1, 1), "VALID"))
        blocks, c = [], 192
        for block, *args in ((InceptionA, 32), (InceptionA, 64),
                             (InceptionA, 64), (InceptionB,),
                             (InceptionC, 128), (InceptionC, 160),
                             (InceptionC, 160), (InceptionC, 192),
                             (InceptionD,), (InceptionE,), (InceptionE,)):
            blocks.append(self._child(block(c, *args, dtype=dtype,
                                            device=device)))
            c = blocks[-1].out_features
        self.blocks = blocks
        self.classifier = Dense(c, num_classes, dtype, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        if self.classifier.kernel.is_meta:  # shapes only, no values to draw
            return
        gen = torch.Generator(self.classifier.kernel.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, SpaceToDepthStem):  # he_normal
                _variance_scaling_(m.kernel, 2.0, m.kernel[0].numel(), gen)
            elif isinstance(m, Conv):  # flax Conv's lecun_normal
                _variance_scaling_(m.kernel, 1.0, m.kernel[0].numel(), gen)
            elif isinstance(m, Dense):
                _variance_scaling_(m.kernel, 1.0, m.kernel.shape[1], gen)
                m.bias.zero_()
            elif isinstance(m, FusedBatchNormAct):
                for t, v in ((m.scale, 1.0), (m.bias, 0.0), (m.mean, 0.0),
                             (m.var, 1.0)):
                    t.fill_(v)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) images, got "
                             f"{tuple(images.shape)}")
        x = _run(self.stem, images.contiguous().to(self.dtype))
        x = _run(self.stem2, _max_pool(x))
        x = _max_pool(x)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return self.classifier(x).float()
