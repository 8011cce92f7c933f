"""The model zoo (port of ``horovod_tpu/models/__init__.py``): the MNIST
convnet, ResNet, VGG, Inception-V3, the expert-parallel MoE LM (``moe``)
and the transformers (BERT, GPT-2), in PyTorch on the port's kernels."""

from horovod_tpu_torch.models import moe
from horovod_tpu_torch.models.mnist import MnistConvNet
from horovod_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
)
from horovod_tpu_torch.models.vgg import VGG, VGG11, VGG13, VGG16, VGG19
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
    "MnistConvNet",
    "ResNet", "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
    "VGG", "VGG11", "VGG13", "VGG16", "VGG19", "InceptionV3", "moe",
    "Transformer", "BertBase", "BertLarge", "GPT2Small", "GPT2Medium",
    "causal_lm_loss", "masked_lm_loss", "random_tokens",
]
