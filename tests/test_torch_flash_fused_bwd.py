"""The port's fused attention backward (kernel B7's plain version, CPU
tensors) against the JAX package's ``_bwd_single_kernel``, and the
backward's choice between it and the dq + dk/dv kernels.

``FLASH_FUSED_BWD=1`` is set with ``monkeypatch.setenv`` for both sides:
the JAX package reads it when it traces the backward (each ``jax.grad``
here traces anew), the port at each backward call. The JAX package's
Pallas kernels run in interpret mode, as its own tests run them; every
extent here fits its default 1024 backward block, so its fused kernel
computes dq, dk and dv (a spy on ``_bwd_single_kernel`` proves it). The same
numpy inputs go to both. Cases: causal and not, head_dim 64 and 128, S 64
and 96, Sq != Sk, offsets, and rows with every key masked.

Tolerance 2e-5 abs in float32, as ``tests/test_torch_flash_attention.py``:
both sides compute the same float32 products, in other orders (base 2 in
one block on the JAX side, one exp over the row here).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("horovod_tpu.ops.pallas.flash_attention")

ATOL = 2e-5


def _inputs(b, h, sq, sk, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    w = rng.normal(size=(b, h, sq, d)).astype(np.float32)  # cotangent
    return q, k, v, w


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (still calling it)."""
    calls = [0]
    real = getattr(module, name)

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def _jax_grads(q, k, v, w, **kw):
    return [np.asarray(g) for g in jax.grad(
        lambda q, k, v: jnp.sum(jfa.flash_attention(q, k, v, **kw) * w),
        argnums=(0, 1, 2))(q, k, v)]


def _torch_grads(q, k, v, w, **kw):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(qt, kt, vt, **kw) * torch.from_numpy(w)) \
        .sum().backward()
    return [t.grad.numpy() for t in (qt, kt, vt)]


def _compare_fused(monkeypatch, q, k, v, w, **kw):
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    jax_fused = _spy(monkeypatch, jfa, "_bwd_single_kernel")
    port_fused = _spy(monkeypatch, tfa, "flash_bwd_fused")
    want = _jax_grads(q, k, v, w, **kw)
    got = _torch_grads(q, k, v, w, **kw)
    assert jax_fused[0] >= 1 and port_fused[0] == 1
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=name)
    return got


@pytest.mark.parametrize("s", [64, 96])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_backward_matches_jax(monkeypatch, causal, d, s):
    q, k, v, w = _inputs(1, 2, s, s, d, seed=s + d)
    _compare_fused(monkeypatch, q, k, v, w, causal=causal)


@pytest.mark.parametrize("sq,sk,offsets", [
    (64, 96, (32, 0)),    # a query shard against a longer key extent
    (96, 64, (0, 0)),     # more queries than keys
    (96, 96, (128, 0)),   # every key in the past
], ids=["sq<sk", "sq>sk", "past-keys"])
def test_fused_backward_lengths_and_offsets_match_jax(monkeypatch, sq, sk,
                                                      offsets):
    q, k, v, w = _inputs(2, 2, sq, sk, 64, seed=sq + sk)
    _compare_fused(monkeypatch, q, k, v, w, causal=True, q_offset=offsets[0],
                   k_offset=offsets[1], sm_scale=0.3)


def test_fused_backward_fully_masked_rows(monkeypatch):
    """Queries before every key get zero, finite gradients, and the same
    from the JAX package's fused kernel."""
    q, k, v, w = _inputs(1, 2, 64, 64, 64, seed=3)
    dq, dk, dv = _compare_fused(monkeypatch, q, k, v, w, causal=True,
                                q_offset=0, k_offset=40)
    assert all(np.isfinite(g).all() for g in (dq, dk, dv))
    assert np.all(dq[:, :, :40] == 0)


def test_fused_plain_version_matches_dq_and_dkv_plain_versions():
    """The fused plain version computes p once; the two-kernel plain
    versions compute it each: the same gradients to float32 rounding."""
    q, k, v, w = map(torch.from_numpy, _inputs(1, 2, 80, 48, 128, seed=5))
    kw = dict(causal=True, sm_scale=0.1, q_offset=10, k_offset=0)
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    args = (q, k, v, w, lse, tfa.compute_delta(o, w))
    fused = tfa.flash_bwd_fused(*args, **kw)
    two = (tfa.flash_bwd_dq(*args, **kw), *tfa.flash_bwd_dkv(*args, **kw))
    for a, b in zip(fused, two):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("switch,seq,fused", [
    ("1", 64, True),          # on, both extents within one 1024 block
    ("1", 1040, False),       # on, but longer than the block
    (None, 64, False),        # off
], ids=["on-fits", "on-too-long", "off"])
def test_backward_takes_the_fused_path_by_the_jax_rule(monkeypatch, switch,
                                                       seq, fused):
    """The fused backward runs when ``FLASH_FUSED_BWD`` is set and Sq, Sk <=
    1024 (the JAX package's rule at its default backward blocks); otherwise
    dq and dk/dv run. Counted at the wrappers."""
    if switch is None:
        monkeypatch.delenv("FLASH_FUSED_BWD", raising=False)
    else:
        monkeypatch.setenv("FLASH_FUSED_BWD", switch)
    counts = {name: _spy(monkeypatch, tfa, name) for name in
              ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")}
    q, k, v = (torch.randn(1, 1, seq, 64, requires_grad=True)
               for _ in range(3))
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    got = {name: c[0] for name, c in counts.items()}
    want = ({"flash_bwd_fused": 1, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
            if fused else
            {"flash_bwd_fused": 0, "flash_bwd_dq": 1, "flash_bwd_dkv": 1})
    assert got == want
    assert tfa.uses_fused_bwd(q, k) is fused
