"""The port's gradient compression (``horovod_tpu_torch/compression.py``)
against the torch binding of the JAX package
(``horovod_tpu/torch/compression.py``), whose public names the port keeps:
``Compression.none``, ``Compression.fp16`` (IEEE float16 on the wire) and
``Compression.bf16`` (bfloat16 on the wire). Round trips are compared bit
for bit: both sides make the same two casts.
"""

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.torch import compression as ref

WIRE = {"none": None, "fp16": torch.float16, "bf16": torch.bfloat16}
# 70000 lies past float16's largest finite value (65504): inf on its wire
OVERFLOW = [1e-6, 70000.0, 1.0001]


@pytest.mark.parametrize("name", sorted(WIRE))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
def test_wire_dtype_matches_the_torch_binding(name, dtype):
    x = torch.tensor(OVERFLOW, dtype=torch.float64).to(dtype)
    wire, ctx = getattr(hvd.Compression, name).compress(x)
    want, want_ctx = getattr(ref.Compression, name).compress(x)
    assert wire.dtype == want.dtype == (WIRE[name] or dtype)
    assert ctx == want_ctx
    assert ctx is None or ctx == dtype


@pytest.mark.parametrize("name", sorted(WIRE))
def test_round_trip_matches_the_torch_binding(name):
    x = torch.tensor(OVERFLOW, dtype=torch.float32)
    ours = getattr(hvd.Compression, name)
    theirs = getattr(ref.Compression, name)
    got = ours.decompress(*ours.compress(x))
    want = theirs.decompress(*theirs.compress(x))
    assert got.dtype == want.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if name == "fp16":
        assert np.isinf(got[1].item()) and got[1] > 0
    if name == "bf16":
        assert got[1].item() == 70144.0  # bfloat16's nearest, finite


@pytest.mark.parametrize("name", sorted(WIRE))
def test_integers_pass_through(name):
    x = torch.arange(-3, 4, dtype=torch.int32)
    wire, ctx = getattr(hvd.Compression, name).compress(x)
    assert wire is x and ctx is None
    assert getattr(hvd.Compression, name).decompress(wire, ctx) is x
