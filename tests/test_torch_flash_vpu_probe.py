"""The port's attention probes (``horovod_tpu_torch/tools/flash_vpu_probe.py``)
against the JAX tool (``tools/flash_vpu_probe.py``), on the CPU.

The port's probe functions run the plain versions of kernels B12-B14 (CPU
tensors); the tool's run its Pallas kernels in interpret mode. The same
numpy inputs go to both, at b 1, h 2, S 128, d 64 with ``block_q=64``, so
the tool's pack2 kernel selects its half by block and the select crosses S.
``simple1_fwd``'s lse is held against the JAX package's
``flash_attention_partial`` lse, because the tool's
``simple1_lse_attention`` drops its lse. Tolerance 2e-5 abs in float32: the
same float32 softmax and products in other orders (base 2 on the JAX side).
"""

import importlib

import numpy as np
import pytest
import torch

from horovod_tpu_torch.tools import flash_vpu_probe as tprobe
from tools import flash_vpu_probe as tool

jfa = importlib.import_module("horovod_tpu.ops.pallas.flash_attention")

ATOL = 2e-5
SM = 0.125


def _inputs(b=1, h=2, s=128, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("name", ["pack2_attention", "simple1_attention",
                                  "simple1_lse_attention"])
def test_probe_functions_match_the_tool(name):
    q, k, v = _inputs()
    want = np.asarray(getattr(tool, name)(q, k, v, SM, block_q=64))
    got = getattr(tprobe, name)(*map(torch.from_numpy, (q, k, v)), SM,
                                block_q=64)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_simple1_lse_matches_the_jax_partial_lse():
    q, k, v = _inputs(seed=1)
    o, lse = tprobe.simple1_fwd(*map(torch.from_numpy, (q, k, v)), SM,
                                with_lse=True)
    o_j, lse_j = jfa.flash_attention_partial(q, k, v, sm_scale=SM)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL, rtol=0)
    assert tprobe.simple1_fwd(*map(torch.from_numpy, (q, k, v)), SM,
                              with_lse=False)[1] is None


def test_pack_builds_the_tools_layout():
    """q2 holds head 2i's q in lanes 0:64 of rows 0:S and head 2i+1's in
    lanes 64:128 of rows S:2S; k2 and v2 hold the pair side by side; the
    packed kernel's plain version unpacks to each head's attention."""
    q, k, v = map(torch.from_numpy, _inputs(h=4, s=32, seed=2))
    q2, k2, v2 = tprobe.pack(q, k, v)
    assert q2.shape == (1, 2, 64, 128) and k2.shape == (1, 2, 32, 128)
    assert torch.equal(q2[0, 1, :32, :64], q[0, 2])
    assert torch.equal(q2[0, 1, 32:, 64:], q[0, 3])
    assert not q2[0, :, :32, 64:].any() and not q2[0, :, 32:, :64].any()
    assert torch.equal(v2[0, 1], torch.cat([v[0, 2], v[0, 3]], dim=-1))
    o2 = tprobe.pack2_fwd(q2, k2, v2, SM)
    o, _ = tprobe.simple1_reference(q, k, v, SM)
    np.testing.assert_allclose(o2.reshape(1, 2, 2, 32, 64).reshape(o.shape),
                               o, atol=ATOL, rtol=0)


def test_probes_refuse_what_the_tool_refuses():
    """Causal shapes (the tool's asserts), an odd head count and head_dim
    other than 64 for pack2, raise ValueError."""
    q, k, v = map(torch.from_numpy, _inputs(h=2, s=16))
    for name in tprobe.PROBES:
        with pytest.raises(ValueError, match="non-causal"):
            tprobe.variant_fn(name, "gpt2", q, k, v)
    q3 = torch.zeros(1, 3, 16, 64)
    with pytest.raises(ValueError, match="even head count"):
        tprobe.pack2_attention(q3, q3, q3, SM)
    q128 = torch.zeros(1, 2, 16, 128)
    with pytest.raises(ValueError, match="head_dim 64"):
        tprobe.pack2_attention(q128, q128, q128, SM)
    with pytest.raises(ValueError, match="unknown variant"):
        tprobe.variant_fn("xla", "bert-large", q, k, v)


def test_every_variant_runs_at_a_small_shape(monkeypatch):
    """Each CLI variant's call runs on CPU tensors (the plain versions),
    the gradients reach q, k and v; FLOPs are counted as the tool counts
    them."""
    monkeypatch.setitem(tprobe.SHAPES, "tiny", (1, 2, 32, 64, False))
    q, k, v = tprobe.inputs("tiny", torch.device("cpu"))
    for name in tprobe.VARIANTS:
        tprobe.variant_fn(name, "tiny", q.float(), k.float(), v.float())()
    for shape in tprobe.SHAPES.values():
        assert tprobe.attn_flops(*shape[:4], shape[4]) == \
            tool.attn_flops(*shape[:4], shape[4])
    assert set(tprobe.SHAPES) == set(tool.SHAPES) | {"tiny"}


def test_cli_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprobe.main(["--shape", "bert-large", "--only", "pack2"]) != 0
