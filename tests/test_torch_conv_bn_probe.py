"""The port's conv + BN-statistics probe (``horovod_tpu_torch/tools/
conv_bn_probe.py``) against the JAX tool (``tools/pallas_conv_bn.py``), on
the CPU.

The TPU kernel cannot run here: its ``pallas_call`` has no interpret mode
and uses TPU VMEM scratch. So the port's plain version of kernel B11 is
held against the tool's own XLA reference: ``xla_conv`` for ``y`` and the
float32 conv's sums, exactly as the tool checks its kernel
(``tools/pallas_conv_bn.py:236-250``), at a small shape (2, 6, 6, 16 ->
32). Tolerances: ``y`` 1e-2 abs (both round a float32 conv to bf16, whose
spacing at these values is 4e-3, from sums taken in other orders); the
sums 1e-4 relative (float32 sums of 72 or 288 products in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from horovod_tpu_torch.tools import conv_bn_probe as probe
from tools import pallas_conv_bn as tool

N, SIZE, CIN, COUT = 2, 6, 16, 32


def test_plain_version_matches_the_tools_reference():
    x, xp, w = probe.inputs(N, SIZE, CIN, COUT, torch.device("cpu"))
    y, s, ss = probe.conv3x3_bn_stats(xp, w)  # CPU tensors: plain version
    assert y.shape == (N, SIZE, SIZE, COUT) and y.dtype == torch.bfloat16
    assert s.dtype == ss.dtype == torch.float32 and s.shape == (COUT,)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    wj = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    y_ref = np.asarray(tool.xla_conv(xj, wj), np.float32)
    np.testing.assert_allclose(y.float().numpy(), y_ref, rtol=0, atol=1e-2)
    yf32 = lax.conv_general_dilated(
        xj.astype(jnp.float32), wj.astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(s.numpy(), np.asarray(yf32.sum((0, 1, 2))),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ss.numpy(),
                               np.asarray((yf32 * yf32).sum((0, 1, 2))),
                               rtol=1e-4)


def test_errors_apply_the_tools_limits():
    _, xp, w = probe.inputs(N, SIZE, CIN, COUT, torch.device("cpu"))
    want = probe.conv3x3_bn_stats_plain(xp, w)
    assert probe.errors(want, want)["ok"]
    s = want[1]
    inside = (want[0], s + 0.99 * (2.0 + 1e-2 * s.abs()), want[2])
    outside = (want[0], s + 1.01 * (2.0 + 1e-2 * s.abs()), want[2])
    assert probe.errors(inside, want)["ok"]
    assert not probe.errors(outside, want)["ok"]


def test_work_at_the_tools_shape():
    """29.6 GFLOP and 30.8 MB at 128 x 14 x 14 x 256 -> 256: bound by
    operations (29.9 us at 989 TFLOP/s against 9.2 us of bytes)."""
    w = probe.work(128, 14, 256, 256)
    assert w["flops"] == 2 * 128 * 14 * 14 * 9 * 256 * 256
    assert abs(w["bytes"] / 1e6 - 30.8) < 0.05
    assert w["bound_by"] == "operations"
    assert abs(w["bound_ms"] - 0.0299) < 5e-4


def test_shapes_are_checked():
    with pytest.raises(ValueError, match="x_padded"):
        probe.conv3x3_bn_stats(torch.zeros(1, 5, 5, 8),
                               torch.zeros(3, 3, 4, 8))
