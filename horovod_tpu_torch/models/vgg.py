"""VGG in PyTorch, training path.

Port of ``horovod_tpu/models/vgg.py``: ``VGG`` (conv stages and the 2 x
4096 dense head) and the partials ``VGG11`` to ``VGG19``. VGG-16 is the
third model of the reference's headline scaling set; its 102,764,544
parameter ``fc1`` is the largest single gradient of any model the port
runs. The flax module's numerics:

* parameters are float32, compute is ``dtype`` (bfloat16 by default): each
  conv and dense layer casts its input and a copy of its weights and bias
  to ``dtype``; the input is cast at entry and the logits leave in
  float32;
* the convs are 3x3, stride 1, flax ``"SAME"`` padding (one on each side),
  with a bias; kernels are He-normal (``variance_scaling(2, fan_in,
  truncated_normal)``), the dense layers LeCun-normal, biases zero;
* ``batch_norm=True`` puts flax's ``nn.BatchNorm(momentum=0.9,
  epsilon=1e-5)`` after each conv: the port's plain norm
  (``models/resnet.BatchNorm``), not kernel B10, as the JAX model runs no
  Pallas kernel either;
* the 2x2 max pools are ``VALID``.

Layout: the public input is NHWC, as in JAX. Inside, activations are NCHW
tensors in channels-last memory (``models/inception.py``'s layout). The
flatten before ``fc1`` is in (H, W, C) order, as the JAX model's NHWC
reshape is, so ``fc1``'s rows are those of the flax kernel and
``models/convert.vgg_from_flax`` only transposes it: on channels-last
memory that order is the storage's own, and the permute costs nothing.

Submodules carry flax's names (``conv<stage>_<i>``, ``bn<stage>_<i>``,
``fc1``, ``fc2``, ``classifier``). The flatten's width needs the image
size at construction (flax infers it at ``init``): ``image_size`` (224).
"""

from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.inception import Dense, _variance_scaling_, \
    _weight
from horovod_tpu_torch.models.resnet import BatchNorm
from horovod_tpu_torch.utils.device import resolve


class Conv(nn.Module):
    """flax ``nn.Conv(features, (3, 3))`` at stride 1, ``"SAME"`` padding,
    with a bias: ``kernel`` float32 in PyTorch's (out, in, 3, 3) layout
    (flax's is (3, 3, in, out)), ``bias`` float32; computes in ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features, in_features, 3, 3,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), _weight(self.kernel, self.dtype),
                        self.bias.to(self.dtype), padding=1)


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H * W * C), the order of flax's reshape of an
    NHWC map."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class VGG(nn.Module):
    """Classic VGG on (N, H, W, 3) images: conv stages, then a 2 x
    4096 dense head, returning float32 (N, num_classes) logits.

    ``stage_sizes`` gives the convs of each stage; channels double each
    stage from 64 up to 512; each stage ends in a 2x2 max pool.
    ``batch_norm`` selects the BN variant (vgg*_bn). Train or eval mode is
    the module's (flax's ``train``; it matters only with ``batch_norm``).
    Parameters are made on ``device`` (default: the card, see
    :func:`horovod_tpu_torch.utils.device.resolve`) from ``seed``;
    ``device="meta"`` builds shapes only."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 batch_norm: bool = False, dtype=torch.bfloat16,
                 image_size: int = 224, device=None, seed: int = 0):
        super().__init__()
        device = resolve(device)
        self.dtype, self.batch_norm = dtype, batch_norm
        self.stage_sizes = tuple(stage_sizes)
        c_in, channels, size = 3, 64, image_size
        for stage, n_convs in enumerate(self.stage_sizes):
            for i in range(n_convs):
                self.add_module(f"conv{stage}_{i}",
                                Conv(c_in, channels, dtype, device))
                if batch_norm:
                    self.add_module(f"bn{stage}_{i}",
                                    BatchNorm(channels, device=device))
                c_in = channels
            size //= 2
            channels = min(channels * 2, 512)
        if size < 1:
            raise ValueError(f"image_size {image_size} is too small for "
                             f"{len(self.stage_sizes)} 2x2 pools")
        self.fc1 = Dense(size * size * c_in, 4096, dtype, device)
        self.fc2 = Dense(4096, 4096, dtype, device)
        self.classifier = Dense(4096, num_classes, dtype, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        if self.fc1.kernel.is_meta:  # shapes only, no values to draw
            return
        gen = torch.Generator(self.fc1.kernel.device).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv):  # he_normal
                _variance_scaling_(m.kernel, 2.0, m.kernel[0].numel(), gen)
                m.bias.zero_()
            elif isinstance(m, Dense):  # lecun_normal
                _variance_scaling_(m.kernel, 1.0, m.kernel.shape[1], gen)
                m.bias.zero_()
            elif isinstance(m, BatchNorm):
                for t, v in ((m.scale, 1.0), (m.bias, 0.0), (m.mean, 0.0),
                             (m.var, 1.0)):
                    t.fill_(v)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (N, H, W, 3) images, got "
                             f"{tuple(images.shape)}")
        # NHWC -> NCHW in channels-last memory
        x = images.contiguous().to(self.dtype).permute(0, 3, 1, 2)
        for stage, n_convs in enumerate(self.stage_sizes):
            for i in range(n_convs):
                x = getattr(self, f"conv{stage}_{i}")(x)
                if self.batch_norm:
                    x = getattr(self, f"bn{stage}_{i}")(x)
                x = F.relu(x)
            x = F.max_pool2d(x, 2, stride=2)
        x = F.relu(self.fc1(flatten_hwc(x)))
        x = F.relu(self.fc2(x))
        return self.classifier(x).float()


VGG11 = partial(VGG, stage_sizes=(1, 1, 2, 2, 2))
VGG13 = partial(VGG, stage_sizes=(2, 2, 2, 2, 2))
VGG16 = partial(VGG, stage_sizes=(2, 2, 3, 3, 3))
VGG19 = partial(VGG, stage_sizes=(2, 2, 4, 4, 4))
