"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b).norm() / b.norm().clamp(min=1e-12)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,offsets", [
    ((2, 4, 512, 64), False, (0, 0)),     # BERT's shape class
    ((1, 2, 1000, 64), True, (0, 0)),     # ragged edge, many k blocks
    ((1, 2, 300, 128), True, (0, 0)),     # head_dim 128, ragged
    ((1, 2, 256, 64), True, (256, 0)),    # every key in the past
    ((1, 2, 256, 64), True, (16, 80)),    # fully masked rows
])
def test_kernels_match_plain_on_card(cuda, shape, causal, offsets):
    """bf16 kernels against the plain version on float32 copies of the same
    bf16 inputs: o within 2e-2 abs, lse within 2e-3 abs, gradients within
    2e-2 relative to their norm (p and dS are rounded to bf16 before their
    products, as the kernels' source states)."""
    g = torch.Generator(cuda).manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=causal, sm_scale=shape[-1] ** -0.5,
              q_offset=offsets[0], k_offset=offsets[1])
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = tfa.flash_fwd_reference(*f[:3], **kw)
    assert (o.float() - o_ref).abs().max().item() <= 2e-2
    fin = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), fin)
    assert (lse - lse_ref)[fin].abs().max().item() <= 2e-3
    assert (o[~fin] == 0).all()
    delta = tfa.compute_delta(o, do)
    dq = tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    ref = (*f, lse, delta)
    dq_ref = tfa.flash_bwd_dq_reference(*ref, **kw)
    dk_ref, dv_ref = tfa.flash_bwd_dkv_reference(*ref, **kw)
    for a, b in ((dq, dq_ref), (dk, dk_ref), (dv, dv_ref)):
        assert torch.isfinite(a).all()
        assert _rel(a, b) <= 2e-2


@pytest.mark.gpu
def test_autograd_runs_the_kernels(cuda):
    """``flash_attention`` on CUDA tensors launches the forward, dq and
    dk/dv kernels once each, and its gradients match the plain path."""
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 4, 128, 64, generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    tfa.reset_launch_counts()
    tfa.flash_attention(q, k, v, causal=True).float().square().sum().backward()
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                            "flash_bwd_dkv": 1}
    qf, kf, vf = (t.detach().float().cpu().requires_grad_() for t in (q, k, v))
    tfa.flash_attention(qf, kf, vf, causal=True).square().sum().backward()
    for a, b in ((q, qf), (k, kf), (v, vf)):
        assert _rel(a.grad.cpu(), b.grad) <= 3e-2
