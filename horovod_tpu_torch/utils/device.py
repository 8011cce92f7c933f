"""Where the port's models put their parameters when the caller names no
device: the card, as ``hvd.init()`` does."""

from __future__ import annotations

from typing import Union

import torch

from horovod_tpu_torch.core import basics


def resolve(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card:
    ``hvd.device()`` once ``hvd.init()`` has run, else the current CUDA
    device. Raises when ``None`` is given and no CUDA device is visible:
    pass ``device="cpu"`` to build on the CPU (``"meta"`` builds shapes
    only)."""
    if device is not None:
        return torch.device(device)
    if basics.is_initialized():
        return basics.device()
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to build the "
            "model on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
