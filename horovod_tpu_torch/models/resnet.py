"""ResNet in PyTorch, training path.

Port of ``horovod_tpu/models/resnet.py``: ``ResNetBlock`` (3x3 + 3x3),
``BottleneckBlock`` (1x1, 3x3, 1x1), the space-to-depth stem
``SpaceToDepthConvInit`` and ``ResNet``, with the partials ``ResNet18`` to
``ResNet152``. The flax modules' numerics:

* parameters and batch statistics are float32, compute is ``dtype``
  (bfloat16 by default): each conv and the classifier cast their input and
  a copy of their weights to ``dtype``; the input is cast at entry and the
  logits leave in float32;
* convolutions have no bias, flax ``"SAME"`` padding (a 3x3 stride-2 conv
  over an even size pads only at the end) and He-normal kernels; the
  classifier is LeCun-normal with a zero bias;
* batch norm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: the
  biased variance ``E[x^2] - E[x]^2`` in float32, clipped at 0, normalises
  in training mode and enters the running statistics as ``0.9 * running +
  0.1 * batch`` (``torch.nn.BatchNorm2d`` would store the unbiased one);
  each block's last norm starts with a zero scale, so a block starts as
  its shortcut;
* where the JAX model has a norm then ReLU, the port runs
  :class:`BatchNormReLU`, the norm then ``F.relu`` in plain PyTorch: kernel
  B10 (``ops/conv_bn_act.py``) computes the same function, but one timing
  of the ResNet-50 step on the card chose the plain pair
  (``tools/resnet_bn_choice.py``). So the ResNet path runs none of the
  port's kernels: convolutions are cuDNN's, as the JAX model's are XLA's.

The stem is always the space-to-depth fold, as in the JAX package's
default: the 7x7 stride-2 conv over (H, W, 3) becomes a 4x4 stride-1 conv
over the (H/2, W/2, 12) space-to-depth image, padded (2, 1) on each side.
The parameter keeps the canonical (filters, 3, 7, 7) shape. An odd image
gets one zero row or column at the end first, which gives what the JAX
package's direct 7x7/2 conv gives there.

Layout: the public input is NHWC, as in JAX. Inside, activations are NCHW
tensors in channels-last memory (``models/inception.py``'s layout).
Submodules carry flax's names (``conv_init``, ``bn_init``,
``BottleneckBlock_<n>``, ``Conv_<k>``, ``BatchNorm_<k>``, ``conv_proj``,
``norm_proj``, ``Dense_0``), so ``models/convert.resnet_from_flax`` maps
the two trees by name. Initial weights are drawn from
``torch.Generator(seed)``: the values differ from JAX's; the tests carry
weights across.
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.inception import (Conv, Dense, _variance_scaling_,
                                                _weight)
from horovod_tpu_torch.ops import conv_bn_act as cba
from horovod_tpu_torch.ops.conv_bn_act import bn_stats
from horovod_tpu_torch.utils.device import resolve

MOMENTUM, EPSILON = 0.9, 1e-5


def flax_bn_stats(x: torch.Tensor):
    """``nn.BatchNorm``'s statistics: :func:`bn_stats`, the variance
    clipped at 0 as flax clips its roundoff."""
    mean, var = bn_stats(x)
    return mean, var.clamp_min(0.0)


class BatchNorm(cba.BatchNorm):
    """``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: ``x * s + b`` in
    float32, returned in x's dtype."""

    _batch_stats = staticmethod(flax_bn_stats)

    def __init__(self, features: int, device=None):
        super().__init__(features, MOMENTUM, EPSILON, device=device)


class BatchNormReLU(BatchNorm):
    """The norm, then ReLU, in plain PyTorch. Kernel B10 computes the same
    function in one pass, but the ResNet-50 step on the card was faster
    without it (``tools/resnet_bn_choice.py``, PERF.md)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(super().forward(x))


class _Block(nn.Module):
    """What the two blocks share: the projection shortcut, where the block
    changes the shape (``conv_proj`` + ``norm_proj``), and the closing
    ``relu(shortcut + branch)``. ``LAST`` names the norm that starts with
    a zero scale."""

    LAST = ""

    def _shortcut(self, in_features: int, strides, dtype, device) -> None:
        if in_features != self.out_features or tuple(strides) != (1, 1):
            self.conv_proj = Conv(in_features, self.out_features, (1, 1),
                                  strides, dtype=dtype, device=device)
            self.norm_proj = BatchNorm(self.out_features, device=device)
        else:
            self.conv_proj = self.norm_proj = None

    def _close(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.conv_proj is not None:
            x = self.norm_proj(self.conv_proj(x))
        return F.relu(x + y)


class ResNetBlock(_Block):
    """Basic 3x3 + 3x3 residual block (ResNet-18/34)."""

    LAST = "BatchNorm_1"

    def __init__(self, in_features: int, filters: int,
                 strides: Sequence[int] = (1, 1), dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.out_features = filters
        self.Conv_0 = Conv(in_features, filters, (3, 3), strides, **kw)
        self.BatchNorm_0 = BatchNormReLU(filters, device=device)
        self.Conv_1 = Conv(filters, filters, (3, 3), **kw)
        self.BatchNorm_1 = BatchNorm(filters, device=device)
        self._shortcut(in_features, strides, dtype, device)

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(x))
        return self._close(x, self.BatchNorm_1(self.Conv_1(y)))


class BottleneckBlock(_Block):
    """1x1, 3x3, 1x1 bottleneck block (ResNet-50/101/152): ``filters``
    wide inside, ``4 * filters`` out."""

    LAST = "BatchNorm_2"

    def __init__(self, in_features: int, filters: int,
                 strides: Sequence[int] = (1, 1), dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.out_features = 4 * filters
        self.Conv_0 = Conv(in_features, filters, (1, 1), **kw)
        self.BatchNorm_0 = BatchNormReLU(filters, device=device)
        self.Conv_1 = Conv(filters, filters, (3, 3), strides, **kw)
        self.BatchNorm_1 = BatchNormReLU(filters, device=device)
        self.Conv_2 = Conv(filters, 4 * filters, (1, 1), **kw)
        self.BatchNorm_2 = BatchNorm(4 * filters, device=device)
        self._shortcut(in_features, strides, dtype, device)

    def forward(self, x):
        y = self.BatchNorm_0(self.Conv_0(x))
        y = self.BatchNorm_1(self.Conv_1(y))
        return self._close(x, self.BatchNorm_2(self.Conv_2(y)))


class SpaceToDepthConvInit(nn.Module):
    """The 7x7/2 input conv as a 4x4/1 conv over the 2x2 space-to-depth
    image (the JAX package's ``SpaceToDepthConvInit``): the kernel, padded
    to 8x8 at the front, folds to ``w4[t, s, c * (2a + b) + ch] = w7[2t + a
    - 1, 2s + b - 1, ch]`` in HWIO terms, and the folded image is padded
    (2, 1) in each spatial dim. Takes NHWC RGB images, returns NCHW
    channels-last; ``kernel`` is (filters, 3, 7, 7)."""

    def __init__(self, filters: int, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.filters, self.dtype = filters, dtype
        self.kernel = nn.Parameter(torch.empty(filters, 3, 7, 7,
                                               device=device))

    def folded_kernel(self) -> torch.Tensor:
        """The (filters, 12, 4, 4) kernel over the folded image."""
        c, f = 3, self.filters
        w8 = F.pad(self.kernel.permute(2, 3, 1, 0), (0, 0, 0, 0, 1, 0, 1, 0))
        w4 = w8.reshape(4, 2, 4, 2, c, f).permute(0, 2, 1, 3, 4, 5)
        return w4.reshape(4, 4, 4 * c, f).permute(3, 2, 0, 1)

    def forward(self, x):
        n, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            n, h, w, c = x.shape
        y = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        y = F.pad(y.reshape(n, h // 2, w // 2, 4 * c), (0, 0, 2, 1, 2, 1))
        return F.conv2d(y.permute(0, 3, 1, 2).to(self.dtype),
                        _weight(self.folded_kernel(), self.dtype))


class ResNet(nn.Module):
    """ResNet on (N, H, W, 3) images (224 x 224 canonical), returning
    float32 (N, num_classes) logits. Train or eval mode is the module's,
    flax's ``train`` argument. Parameters are made on ``device`` (default:
    the card, see :func:`horovod_tpu_torch.utils.device.resolve`) from
    ``seed``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype=torch.bfloat16, device=None, seed: int = 0):
        super().__init__()
        device = resolve(device)
        self.dtype = dtype
        self.conv_init = SpaceToDepthConvInit(num_filters, dtype, device)
        self.bn_init = BatchNormReLU(num_filters, device=device)
        blocks, c = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                block = block_cls(c, num_filters * 2 ** i,
                                  (2, 2) if i > 0 and j == 0 else (1, 1),
                                  dtype=dtype, device=device)
                self.add_module(f"{block_cls.__name__}_{len(blocks)}", block)
                blocks.append(block)
                c = block.out_features
        self.blocks = blocks
        self.Dense_0 = Dense(c, num_classes, dtype, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        if self.Dense_0.kernel.is_meta:  # shapes only, no values to draw
            return
        gen = torch.Generator(self.Dense_0.kernel.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv, SpaceToDepthConvInit)):  # he_normal
                _variance_scaling_(m.kernel, 2.0, m.kernel[0].numel(), gen)
            elif isinstance(m, Dense):
                _variance_scaling_(m.kernel, 1.0, m.kernel.shape[1], gen)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                for t, v in ((m.scale, 1.0), (m.bias, 0.0), (m.mean, 0.0),
                             (m.var, 1.0)):
                    t.fill_(v)
        for block in self.blocks:
            getattr(block, block.LAST).scale.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) images, got "
                             f"{tuple(images.shape)}")
        x = self.bn_init(self.conv_init(images.contiguous().to(self.dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for block in self.blocks:
            x = block(x)
        return self.Dense_0(x.mean(dim=(2, 3))).float()


ResNet18 = partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=ResNetBlock)
ResNet34 = partial(ResNet, stage_sizes=(3, 4, 6, 3), block_cls=ResNetBlock)
ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3),
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3),
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3),
                    block_cls=BottleneckBlock)
