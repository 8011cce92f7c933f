"""The model zoo the port has (port of ``horovod_tpu/models/__init__.py``):
the transformers (BERT, GPT-2), ResNet and Inception-V3, in PyTorch on the
port's kernels. ``MnistConvNet``, the VGGs and ``moe`` come with their
modules (ROADMAP A7)."""

from horovod_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from horovod_tpu_torch.models.inception import InceptionV3
from horovod_tpu_torch.models.transformer import (
    BertBase,
    BertLarge,
    GPT2Medium,
    GPT2Small,
    Transformer,
    causal_lm_loss,
    masked_lm_loss,
    random_tokens,
)

__all__ = [
    "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
    "InceptionV3",
    "Transformer", "BertBase", "BertLarge", "GPT2Small", "GPT2Medium",
    "causal_lm_loss", "masked_lm_loss", "random_tokens",
]
