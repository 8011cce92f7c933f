"""The port's CUDA kernels against their plain PyTorch versions, on the card:
flash attention and its fused backward (csrc/flash_attention.cu) and the
attention probes (csrc/attention_probe.cu) within stated tolerances, the
AdamW kernels (csrc/adamw.cu) and the fused BN + ReLU (csrc/conv_bn_act.cu)
bit for bit, and the conv + BN-statistics probe (csrc/conv_bn_stats.cu)
within the JAX tool's limits.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX.)
"""

import pytest
import torch

from horovod_tpu_torch.ops import conv_bn_act as tcba
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.tools import conv_bn_probe as tprobe
from horovod_tpu_torch.tools import flash_vpu_probe as tvprobe


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
def test_autograd_runs_the_kernels(cuda, monkeypatch):
    """``flash_attention`` on CUDA tensors launches the forward, dq and
    dk/dv kernels once each (the fused backward's switch unset), and its
    gradients match the plain path."""
    monkeypatch.delenv("FLASH_FUSED_BWD", raising=False)
    g = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 4, 128, 64, generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    tfa.reset_launch_counts()
    tfa.flash_attention(q, k, v, causal=True).float().square().sum().backward()
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                            "flash_bwd_dkv": 1, "flash_bwd_fused": 0}
    qf, kf, vf = (t.detach().float().cpu().requires_grad_() for t in (q, k, v))
    tfa.flash_attention(qf, kf, vf, causal=True).square().sum().backward()
    for a, b in ((q, qf), (k, kf), (v, vf)):
        assert _rel(a.grad.cpu(), b.grad) <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal,offsets", [
    ((2, 4, 512, 512, 64), False, (0, 0)),    # BERT's shape class
    ((1, 2, 1000, 1000, 64), True, (0, 0)),   # ragged edge, 16 key blocks
    ((1, 2, 300, 700, 128), True, (400, 0)),  # head_dim 128, Sq != Sk
    ((1, 2, 256, 256, 64), True, (16, 80)),   # fully masked rows
])
def test_fused_backward_matches_plain_on_card(cuda, shape, causal, offsets):
    """B7 on bf16 inputs against its plain version on float32 copies and
    against the dq and dk/dv kernels: each gradient within 2e-2 relative to
    its norm; fully masked rows get dq 0."""
    b, h, sq, sk, d = shape
    g = torch.Generator(cuda).manual_seed(5)
    q, do = (torch.randn(b, h, sq, d, generator=g, device=cuda)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, h, sk, d, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=causal, sm_scale=d ** -0.5, q_offset=offsets[0],
              k_offset=offsets[1])
    o, lse = tfa.flash_fwd(q, k, v, **kw)
    delta = tfa.compute_delta(o, do)
    tfa.reset_launch_counts()
    got = tfa.flash_bwd_fused(q, k, v, do, lse, delta, **kw)
    assert tfa.LAUNCHES["flash_bwd_fused"] == 1
    two = (tfa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
           *tfa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    f = [t.float() for t in (q, k, v, do)]
    o_ref, lse_ref = tfa.flash_fwd_reference(*f[:3], **kw)
    ref = tfa.flash_bwd_fused_reference(
        *f, lse_ref, tfa.compute_delta(o_ref.float(), f[3]), **kw)
    for a, r, t in zip(got, ref, two):
        assert torch.isfinite(a).all()
        assert _rel(a, r) <= 2e-2
        assert _rel(a, t.float()) <= 2e-2
    assert (got[0][~torch.isfinite(lse_ref)] == 0).all()


@pytest.mark.gpu
def test_autograd_under_the_switch_runs_the_fused_kernel(cuda, monkeypatch):
    """With ``FLASH_FUSED_BWD=1`` the backward launches B7 once and neither
    dq nor dk/dv, and its gradients match the plain path."""
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    g = torch.Generator(cuda).manual_seed(6)
    q, k, v = (torch.randn(2, 4, 192, 64, generator=g, device=cuda)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    tfa.reset_launch_counts()
    tfa.flash_attention(q, k, v, causal=True).float().square().sum().backward()
    assert tfa.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "flash_bwd_fused": 1}
    qf, kf, vf = (t.detach().float().cpu().requires_grad_() for t in (q, k, v))
    tfa.flash_attention(qf, kf, vf, causal=True).square().sum().backward()
    for a, b in ((q, qf), (k, kf), (v, vf)):
        assert _rel(a.grad.cpu(), b.grad) <= 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("s,d", [(512, 64), (96, 64), (200, 128)])
def test_probe_kernels_match_plain_on_card(cuda, s, d):
    """B14 and B13 (o, lse) and, at head_dim 64, B12 on packed heads (S 96:
    a 64-row tile straddles the half select at S) against their plain
    versions on float32 copies: o within 2e-2 abs and 1e-2 relative to its
    norm, lse within 2e-3 abs. On the tool's data (scale 0.3) the softmax
    is nearly uniform, so unit-scale data, where it is peaked, is checked
    too; on both, uniform attention and half the sm_scale must miss the
    relative limit."""
    sm = d ** -0.5
    tvprobe.reset_launch_counts()
    for seed, scale in ((7, 0.3), (8, 1.0)):
        g = torch.Generator(cuda).manual_seed(seed)
        q, k, v = (scale * torch.randn(2, 4, s, d, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(3))
        f = [t.float() for t in (q, k, v)]
        o_ref, lse_ref = tvprobe.simple1_reference(*f, sm)
        assert _rel(f[2].mean(2, keepdim=True).expand_as(o_ref), o_ref) > 1e-2
        assert _rel(tvprobe.simple1_reference(*f, sm / 2)[0], o_ref) > 1e-2
        o, none = tvprobe.simple1_fwd(q, k, v, sm, with_lse=False)
        o2, lse = tvprobe.simple1_fwd(q, k, v, sm, with_lse=True)
        torch.cuda.synchronize()
        assert none is None
        for got in (o, o2):
            assert (got.float() - o_ref).abs().max().item() <= 2e-2
            assert _rel(got, o_ref) <= 1e-2
        assert (lse - lse_ref).abs().max().item() <= 2e-3
        if d == 64:
            q2, k2, v2 = tvprobe.pack(q, k, v)
            p = tvprobe.pack2_fwd(q2, k2, v2, sm)
            ref = tvprobe.pack2_reference(q2.float(), k2.float(), v2.float(),
                                          sm)
            whole = tvprobe.pack2_attention(q, k, v, sm)
            torch.cuda.synchronize()
            for got, want in ((p, ref), (whole, o_ref)):
                assert (got.float() - want).abs().max().item() <= 2e-2
                assert _rel(got, want) <= 1e-2
    n = 2  # one launch of each entry point for each of the two data
    assert tvprobe.LAUNCHES == {"simple1": n, "simple1_lse": n,
                                "pack2": 2 * n if d == 64 else 0}


def _adam_leaf(n, dtypes, gen, device):
    draw = [torch.randn(n, generator=gen, device=device),
            1e-2 * torch.randn(n, generator=gen, device=device),
            1e-4 * torch.rand(n, generator=gen, device=device),
            torch.randn(n, generator=gen, device=device)]
    return [t.to(d) for t, d in zip(draw, dtypes)]


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("dtypes", [(F32, F32, F32, F32),
                                    (BF16, F32, F32, BF16),
                                    (BF16, BF16, BF16, BF16),
                                    (F32, F32, F32, BF16)])
def test_adamw_multi_bit_equal_to_plain_on_card(cuda, dtypes):
    """The multi-tensor AdamW kernel over leaves with ragged tails (1, 7,
    4,099 elements) and several chunks (131 x 128, 50,000) against its
    plain version on copies, 3 steps: bit-equal (adamw.cu is built with
    -fmad=false; both round after every float32 operation)."""
    from horovod_tpu_torch.ops import fused_adamw as fadam

    gen = torch.Generator(cuda).manual_seed(2)
    leaves = [_adam_leaf(n, dtypes, gen, cuda)
              for n in (1, 7, 4099, 131 * 128, 50000)]
    ref = [[t.clone() for t in leaf] for leaf in leaves]
    fadam.reset_launch_counts()
    for step in range(1, 4):
        sc = fadam.adamw_scalars(step, 0.9, 0.999, 1e-3, 1e-2)
        fadam.adamw_multi(*map(list, zip(*leaves)), sc, eps=1e-8)
        for leaf in ref:
            leaf[:3] = fadam.adamw_leaf_reference(*leaf, sc, 1e-8)
        torch.cuda.synchronize()
        for got, want in zip(leaves, ref):
            for a, b in zip(got[:3], want[:3]):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert fadam.LAUNCHES["adamw_multi"] == 3  # one launch a step


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 16385, (1 << 20) + 3])
@pytest.mark.parametrize("grad_dtype,out_dtype", [(F32, F32), (BF16, BF16),
                                                  (F32, BF16)])
def test_flat_adamw_bit_equal_to_plain_on_card(cuda, n, grad_dtype,
                                               out_dtype):
    """The flat ZeRO AdamW kernel against its plain version on copies, 3
    steps, ragged lengths and bf16 gradients/outputs: bit-equal."""
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import fused_optimizer as fopt

    gen = torch.Generator(cuda).manual_seed(3)
    master, mu, nu, grad = _adam_leaf(n, (F32, F32, F32, grad_dtype), gen,
                                      cuda)
    ref = [t.clone() for t in (master, mu, nu)]
    for step in range(1, 4):
        sc = fadam.adamw_scalars(step, 0.9, 0.999, 1e-3, 1e-2)
        p, *_ = fopt.flat_adamw_shard(master, mu, nu, grad, sc, eps=1e-8,
                                      out_dtype=out_dtype)
        want = fopt.flat_adamw_reference(*ref, grad, sc, 1e-8, out_dtype)
        ref = list(want[1:])
        torch.cuda.synchronize()
        for a, b in zip((p, master, mu, nu), want):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_fused_and_zero1_agree_bit_for_bit_on_card(cuda):
    """At world 1 (NCCL), ``fused_adamw`` and ``sharded_adamw`` on the same
    weights and gradients give bit-equal float32 parameters (the bf16 leaf
    keeps bf16 moments under the first and f32 master and moments under
    the second, so it agrees to a bf16 unit); the first launches
    the multi-tensor kernel once a step, the second the flat kernel once
    per dtype group (two: f32 and bf16 leaves)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fused_adamw as fadam
    from horovod_tpu_torch.ops import fused_optimizer as fopt

    gen = torch.Generator(cuda).manual_seed(4)
    shapes = [(64, 33), (7,), (1000,), (3, 5, 9)]
    a = {f"w{i}": torch.randn(s, generator=gen, device=cuda)
         for i, s in enumerate(shapes)}
    a["w1"] = a["w1"].to(BF16)
    grads = {k: torch.randn(t.shape, generator=gen, device=cuda).to(t.dtype)
             for k, t in a.items()}
    b = {k: t.clone() for k, t in a.items()}
    hvd.shutdown()
    hvd.init()
    try:
        fused, zero = fadam.fused_adamw(1e-3), hvd.sharded_adamw(1e-3)
        fs, zs = fused.init(a), zero.init(b)
        fadam.reset_launch_counts()
        fopt.reset_launch_counts()
        for _ in range(2):
            _, fs = fused.apply(a, fs, grads)
            _, zs = zero.apply(b, zs, grads)
        torch.cuda.synchronize()
        for k in a:
            if a[k].dtype == F32:
                assert torch.equal(a[k], b[k]), k
            else:  # bf16 moments (fused) against f32 masters (ZeRO)
                err = (a[k].float() - b[k].float()).abs()
                assert (err <= 2.0 ** -7 * b[k].float().abs() + 2e-3).all()
        assert fadam.LAUNCHES["adamw_multi"] == 2 * 2  # two dtype combos
        assert fopt.LAUNCHES["flat_adamw"] == 2 * 2  # two dtype groups
    finally:
        hvd.shutdown()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (32, 64, 147, 147),   # Inception-V3's largest BN input
    (8, 2048, 8, 8),      # C % 128 == 0
    (4, 80, 7, 9),        # 16-byte vectors, ragged pixel count
    (4, 3, 5, 5), (4, 7, 5, 5), (2, 1000, 3, 3),  # element by element
    (1, 5),               # 5 elements
])
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_scale_bias_act_bit_equal_to_plain_on_card(cuda, shape, dtype):
    g = torch.Generator(cuda).manual_seed(len(shape) + shape[1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    if x.ndim == 4:
        x = x.contiguous(memory_format=torch.channels_last)
    s, b = (torch.randn(shape[1], generator=g, device=cuda)
            for _ in range(2))
    tcba.reset_launch_counts()
    y = tcba.sba(x, s, b)
    assert tcba.LAUNCHES == {"sba": 1}
    assert y.stride() == x.stride()
    assert torch.equal(y, tcba.sba_plain(x, s, b))


@pytest.mark.gpu
def test_scale_bias_act_refuses_nchw_on_card(cuda):
    x = torch.ones(2, 16, 4, 4, device=cuda, dtype=BF16)  # contiguous NCHW
    s, b = torch.ones(16, device=cuda), torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        tcba.sba(x, s, b)


@pytest.mark.gpu
def test_conv_bn_stats_within_the_tools_limits_on_card(cuda):
    """B11 at the tool's shape, 128 x 14 x 14 x 256 -> 256, against its
    plain version (a float32 conv of the same bf16 values; cuDNN's TF32
    off): y 2e-2 rel + abs, sum 1e-2 rel + 2.0 abs, sumsq 1e-2 rel."""
    torch.backends.cudnn.allow_tf32 = False
    _, xp, w = tprobe.inputs(tprobe.BATCH, tprobe.SIZE, tprobe.CHANNELS,
                             tprobe.CHANNELS, cuda)
    got = tprobe.conv3x3_bn_stats(xp, w)
    want = tprobe.conv3x3_bn_stats_plain(xp, w)
    assert tprobe.errors(got, want)["ok"]


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["channels-last", "cat slice", "NCHW"])
def test_inception_avg_pool_gradient_matches_cpu_on_card(cuda, layout):
    """Inception's SAME average pool on a channels-last input, with a dense
    channels-last gradient (a conv's dgrad), a channel slice of one (what
    ``torch.cat``'s backward passes on) and a contiguous NCHW one: the
    port's gradient on the card equals the CPU's within 1e-6 (its backward
    is the pool of the gradient). PyTorch's own ``avg_pool2d`` backward is
    run the same way and its error printed with the torch version
    (``-s``): the reason the port does not use it."""
    from horovod_tpu_torch.models import inception

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 35, 35, generator=g) \
        .contiguous(memory_format=torch.channels_last)
    up = torch.randn(2, 288, 35, 35, generator=g) \
        .contiguous(memory_format=torch.channels_last)
    grad = {"channels-last": lambda u: u[:, 224:].contiguous(
                memory_format=torch.channels_last),
            "cat slice": lambda u: u[:, 224:],
            "NCHW": lambda u: u[:, 224:].contiguous()}[layout]
    errs = {}
    for name, pool in (("F.avg_pool2d", inception._box3),
                       ("port", inception._avg_pool_same)):
        grads = []
        for dev in (cuda, torch.device("cpu")):
            xt = x.to(dev).detach().requires_grad_()
            pool(xt).backward(grad(up.to(dev)))
            grads.append(xt.grad.cpu())
        errs[name] = _rel(grads[0], grads[1])
    print(f"torch {torch.__version__}, {layout} gradient: F.avg_pool2d "
          f"backward rel {errs['F.avg_pool2d']:.3e}, port {errs['port']:.3e}")
    assert errs["port"] <= 1e-6
