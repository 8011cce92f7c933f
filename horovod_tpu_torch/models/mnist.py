"""The small MNIST convnet in PyTorch: port of
``horovod_tpu/models/mnist.py`` ``MnistConvNet``, the model of the JAX
package's MNIST example (``examples/jax_mnist.py``).

Two 3x3 convs (32 and 64 features, flax ``"SAME"`` padding, with a bias),
each followed by ReLU and a 2x2 stride-2 ``VALID`` average pool, then
``Dense(128)``, ReLU and ``Dense(num_classes)``; LeCun-normal kernels,
zero biases, compute in ``dtype`` (float32 by default), logits in float32.
Submodules carry flax's names (``Conv_0``, ``Conv_1``, ``Dense_0``,
``Dense_1``) for ``models/convert.mnist_from_flax``.

The flatten is in (H, W, C) order, the order of the JAX model's reshape of
its NHWC map (``:30``), so ``Dense_0``'s rows are the flax kernel's (7 x 7
x 64 = 3136 at 28 x 28). The average pool is a reshape and a mean, whose
backward is element-wise: PyTorch's own ``avg_pool2d`` backward gave
wrong gradients for channels-last CUDA tensors (``models/inception.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.inception import Dense, _variance_scaling_
from horovod_tpu_torch.models.vgg import Conv, flatten_hwc
from horovod_tpu_torch.utils.device import resolve


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """flax ``avg_pool(x, (2, 2), strides=(2, 2))`` (``VALID``) over an
    (N, C, H, W) map: an odd last row or column is dropped."""
    n, c, h, w = x.shape
    x = x[:, :, :h - h % 2, :w - w % 2]
    return x.unflatten(3, (w // 2, 2)).unflatten(2, (h // 2, 2)).mean((3, 5))


class MnistConvNet(nn.Module):
    """(N, H, W, 1) images (28 x 28 canonical) -> float32
    (N, num_classes) logits. ``image_size`` sets ``Dense_0``'s width (flax
    infers it at ``init``). Parameters are made on ``device`` (default: the
    card) from ``seed``."""

    def __init__(self, num_classes: int = 10, dtype=torch.float32,
                 image_size: int = 28, device=None, seed: int = 0):
        super().__init__()
        device = resolve(device)
        self.dtype = dtype
        self.Conv_0 = Conv(1, 32, dtype, device)
        self.Conv_1 = Conv(32, 64, dtype, device)
        side = image_size // 2 // 2
        self.Dense_0 = Dense(side * side * 64, 128, dtype, device)
        self.Dense_1 = Dense(128, num_classes, dtype, device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        if self.Dense_0.kernel.is_meta:
            return
        gen = torch.Generator(self.Dense_0.kernel.device).manual_seed(seed)
        for m in (self.Conv_0, self.Conv_1, self.Dense_0, self.Dense_1):
            fan_in = m.kernel[0].numel()  # in (x 3 x 3 for the convs)
            _variance_scaling_(m.kernel, 1.0, fan_in, gen)
            m.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.contiguous().to(self.dtype).permute(0, 3, 1, 2)
        x = avg_pool2(F.relu(self.Conv_0(x)))
        x = avg_pool2(F.relu(self.Conv_1(x)))
        x = F.relu(self.Dense_0(flatten_hwc(x)))
        return self.Dense_1(x).float()
