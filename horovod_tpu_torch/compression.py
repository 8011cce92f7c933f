"""Gradient compression (port of ``horovod_tpu/torch/compression.py``,
whose public names the port keeps).

A compressor casts a tensor to its wire type before the collective and
back after it: ``Compression.fp16`` sends IEEE float16,
``Compression.bf16`` bfloat16; integer tensors pass through."""

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


class _CastCompressor(Compressor):
    """Floating tensors travel as :attr:`wire_dtype` and are cast back
    after; integer tensors pass through."""

    wire_dtype: torch.dtype

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """IEEE float16 on the wire (reference:
    horovod_tpu/torch/compression.py:40-55): a value past 65504 arrives
    as inf."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 on the wire (reference:
    horovod_tpu/torch/compression.py:58-73): float16's bytes with
    float32's exponent range."""

    wire_dtype = torch.bfloat16


class Compression:
    """Gradient compression used during allreduce (reference:
    torch/compression.py:63-78)."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
