"""Gradient compression (port of ``horovod_tpu/compression.py``).

A compressor casts a tensor to its wire type before the collective and
back after it. ``Compression.fp16`` uses bfloat16 on the wire, as the JAX
package does (same exponent range as float32); integer tensors pass
through."""

from __future__ import annotations

import torch


class Compressor:
    """``compress`` returns (wire_tensor, context); ``decompress`` undoes
    it with the context."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity (reference: torch/compression.py:35-43)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    """Floating tensors travel as bfloat16 and are cast back after
    (reference: torch/compression.py:45-60, fp16 -> bf16 as in the JAX
    package)."""

    wire_dtype = torch.bfloat16

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class Compression:
    """Gradient compression used during allreduce (reference:
    torch/compression.py:63-78)."""

    none = NoneCompressor
    fp16 = FP16Compressor
