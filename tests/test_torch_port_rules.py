"""Rules the port keeps: it never reaches JAX or the JAX package, its entry
points run on the card unless asked for the CPU, and a kernel never falls
back to its plain version for a tensor that is not on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.inception import InceptionV3
from horovod_tpu_torch.models.transformer import BertLarge, GPT2Small
from horovod_tpu_torch.ops import conv_bn_act as tcba
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import fused_adamw as tadam
from horovod_tpu_torch.ops import kernel_build
from horovod_tpu_torch.ops import fused_optimizer as topt
from horovod_tpu_torch.tools import conv_bn_probe as tprobe
from horovod_tpu_torch.tools import flash_vpu_probe as tvprobe

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _port_files():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.models.convert,"
            " horovod_tpu_torch.models.transformer,"
            " horovod_tpu_torch.models.inception,"
            " horovod_tpu_torch.ops.conv_bn_act, horovod_tpu_torch.training,"
            " horovod_tpu_torch.tools.conv_bn_probe,"
            " horovod_tpu_torch.utils.device;"
            " bad = [m for m in sys.modules if m.split('.')[0] in %r];"
            " assert not bad, bad" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def test_init_without_device_raises_without_a_card(no_card):
    hvd.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hvd.init()
    assert not hvd.is_initialized()


@pytest.mark.parametrize("build", [
    lambda: InceptionV3(),
    lambda: BertLarge(vocab_size=64, max_seq=16),
    lambda: GPT2Small(vocab_size=64, max_seq=16, num_layers=1),
], ids=["inception", "bert-large", "gpt2-small"])
def test_models_without_device_raise_without_a_card(no_card, build):
    """A model built with no device takes the card, as ``hvd.init()`` does,
    and raises without one, naming ``device='cpu'``."""
    hvd.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA device.*device='cpu'"):
        build()


def test_models_without_device_take_hvd_device_once_initialized():
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        model = InceptionV3(num_classes=10, dtype=torch.float32)
        assert next(model.parameters()).device == hvd.device()
    finally:
        hvd.shutdown()


def test_cuda_tensor_does_not_fall_back(no_card, monkeypatch):
    """A tensor that is not on the CPU takes the kernel route: on a machine
    without the toolchain that route raises, it never computes the plain
    version, and no launch is counted."""
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tfa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    # a bf16 tensor taken as a CUDA one reaches the kernel build, which
    # needs nvcc: it raises instead of returning the plain result
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    before = dict(tfa.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_attention(q, q, q)
    assert tfa.LAUNCHES == before


def test_cuda_tensor_does_not_fall_back_adamw(no_card, monkeypatch):
    """The AdamW wrappers, given tensors taken as CUDA ones, go to the
    kernel build, which needs nvcc: they raise, leave the tensors as they
    were and count no launch."""
    with pytest.raises(ValueError, match="no kernel for meta"):
        tadam.adamw_multi(*[[torch.zeros(4, device="meta")]] * 4,
                          np.zeros(6, np.float32), eps=1e-8)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(kernel_build, "on_cpu", lambda what, tensors: False)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    p, m, v, g = (torch.full((8,), 0.5) for _ in range(4))
    before = (dict(tadam.LAUNCHES), dict(topt.LAUNCHES))
    sc = tadam.adamw_scalars(1, 0.9, 0.999, 1e-3, 1e-4)
    opt = tadam.fused_adamw(1e-3)
    for call in (lambda: tadam.adamw_multi([p], [m], [v], [g], sc, eps=1e-8),
                 lambda: opt.apply({"p": p}, opt.init({"p": p}), {"p": g}),
                 lambda: topt.flat_adamw_shard(p, m, v, g, sc, eps=1e-8,
                                               out_dtype=torch.float32)):
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert all(bool((t == 0.5).all()) for t in (p, m, v, g))
    assert (dict(tadam.LAUNCHES), dict(topt.LAUNCHES)) == before


def _raises_without_nvcc(monkeypatch):
    """Take every tensor as a CUDA one, on a machine without nvcc."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    monkeypatch.setattr(kernel_build, "on_cpu", lambda what, tensors: False)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")


def test_cuda_tensor_does_not_fall_back_scale_bias_act(no_card,
                                                        monkeypatch):
    """B10's wrapper, given tensors taken as CUDA ones, goes to the kernel
    build and raises: it neither computes the plain version nor counts a
    launch."""
    x = torch.ones(2, 4, 3, 3).contiguous(memory_format=torch.channels_last)
    s, b = torch.ones(4), torch.zeros(4)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tcba.scale_bias_act(x.to("meta"), s.to("meta"), b.to("meta"))
    _raises_without_nvcc(monkeypatch)
    before = dict(tcba.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        tcba.scale_bias_act(x, s, b)
    with pytest.raises(RuntimeError, match="nvcc"):
        tcba.FusedBatchNormAct(4, device="cpu")(x)
    assert tcba.LAUNCHES == before


def test_scale_bias_act_kernel_refuses_other_layouts(monkeypatch):
    """The kernel takes channels-last tensors only: a contiguous NCHW
    tensor taken as a CUDA one is refused before any build."""
    monkeypatch.setattr(kernel_build, "on_cpu", lambda what, tensors: False)
    x = torch.ones(2, 4, 3, 3)
    with pytest.raises(ValueError, match="channels-last"):
        tcba.sba(x, torch.ones(4), torch.zeros(4))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tcba.sba(x.half().contiguous(memory_format=torch.channels_last),
                 torch.ones(4), torch.zeros(4))


def test_cuda_tensor_does_not_fall_back_conv_bn_stats(no_card, monkeypatch):
    _, xp, w = tprobe.inputs(1, 4, 32, 64, torch.device("cpu"))
    with pytest.raises(ValueError, match="no kernel for meta"):
        tprobe.conv3x3_bn_stats(xp.to("meta"), w.to("meta"))
    _raises_without_nvcc(monkeypatch)
    before = dict(tprobe.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        tprobe.conv3x3_bn_stats(xp, w)
    assert tprobe.LAUNCHES == before


def test_cuda_tensor_does_not_fall_back_fused_backward(no_card, monkeypatch):
    """Under ``FLASH_FUSED_BWD=1`` a backward over tensors taken as CUDA
    ones reaches B7's build and raises: no plain result, no dq + dk/dv in
    its place, no launch counted."""
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 16)
    args = (q, q, q, q, lse, lse)
    kw = dict(causal=True, sm_scale=0.125, q_offset=0, k_offset=0)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tfa.flash_bwd_fused(*(t.to("meta") for t in args), **kw)
    _raises_without_nvcc(monkeypatch)
    monkeypatch.setattr(tfa, "_on_cpu", lambda *t: False)
    monkeypatch.setenv("FLASH_FUSED_BWD", "1")
    before = dict(tfa.LAUNCHES)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa.flash_bwd_fused(*args, **kw)
    with pytest.raises(RuntimeError, match="nvcc"):
        tfa._FlashAttention.backward(
            type("Ctx", (), {"saved_tensors": (q, q, q, q, lse), "kw": kw}),
            q)
    assert tfa.LAUNCHES == before


def test_cuda_tensor_does_not_fall_back_attention_probes(no_card,
                                                         monkeypatch):
    q = torch.zeros(1, 2, 16, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tvprobe.simple1_attention(q.to("meta"), q.to("meta"), q.to("meta"),
                                  0.125)
    _raises_without_nvcc(monkeypatch)
    before = dict(tvprobe.LAUNCHES)
    for fn in (tvprobe.pack2_attention, tvprobe.simple1_attention,
               tvprobe.simple1_lse_attention):
        with pytest.raises(RuntimeError, match="nvcc"):
            fn(q, q, q, 0.125)
    assert tvprobe.LAUNCHES == before


def test_library_hash_covers_only_the_headers_a_source_includes(
        tmp_path, monkeypatch):
    """A library is keyed by its source and the csrc headers it includes,
    also through another header: editing a header rebuilds the sources
    that use it and no other."""
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "t.cuh"\n')
    (tmp_path / "b.cu").write_text("#include <stdint.h>\n")
    (tmp_path / "t.cuh").write_text('#include "u.cuh"\n')
    (tmp_path / "u.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernel_build, "CSRC", tmp_path)
    assert [p.name for p in kernel_build.sources("a")] == ["a.cu", "t.cuh",
                                                           "u.cuh"]
    before = {n: kernel_build.library_path(n) for n in "ab"}
    (tmp_path / "u.cuh").write_text("// v2\n")
    assert kernel_build.library_path("a") != before["a"]
    assert kernel_build.library_path("b") == before["b"]


def test_forward_mainloop_header_is_a_source_of_both_forward_libraries():
    """The flash forward and the attention probes run one Hopper mainloop,
    ``csrc/attention_fwd_sm90.cuh``: both libraries list it among their
    sources, so an edit to it rebuilds both, and it is the only place that
    issues wgmma; neither forward kernel keeps a mma.sync path beside it."""
    header = "attention_fwd_sm90.cuh"
    for name in ("flash_attention", "attention_probe"):
        assert header in [p.name for p in kernel_build.sources(name)], name
    wgmma = [p.name for p in kernel_build.CSRC.iterdir()
             if "wgmma.mma_async" in p.read_text()]
    assert wgmma == [header]
    probe_src = (kernel_build.CSRC / "attention_probe.cu").read_text()
    assert "attention_fwd_sm90<" in probe_src and "mma16816" not in probe_src
    flash_src = (kernel_build.CSRC / "flash_attention.cu").read_text()
    fwd = flash_src[flash_src.index("flash_fwd_kernel("):
                    flash_src.index("flash_bwd_dq_kernel(")]
    assert "attention_fwd_sm90<" in fwd and "mma16816" not in fwd


def test_sass_witness_counts_the_forward_kernels_instructions(monkeypatch):
    """``chip_smoke.py``'s witness that the design reached the card: the
    functions of ``cuobjdump -sass`` are demangled with their template
    arguments, and their HGMMA, UTMALDG and SYNCS instructions counted,
    predicated ones included."""
    import types

    import chip_smoke

    sass = """
        code for sm_90a
                Function : _ZN51_GLOBAL__N__d4d25e85_18_attention_probe_cu_6706b63e16probe_fwd_kernelILi128ELi64ELb0EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiifiii
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0090*/                   SYNCS.EXCH.64 URZ, [UR4], UR6 ;
        /*00a0*/              @!P0 UTMALDG.3D [UR8], [UR10] ;
        /*00b0*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*00c0*/                   HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR8], R24 ;
                Function : _ZN12_GLOBAL__N_119flash_bwd_dq_kernelILi64ELi64EEEvPK13__nv_bfloat16S3_S3_S3_PKfS5_PS1_iifiii
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""
    monkeypatch.setattr(chip_smoke.kernel_build, "nvcc",
                        lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=sass))
    assert chip_smoke.sass_counts("attention_probe") == {
        "probe_fwd_kernel<128,64,false>": {"HGMMA": 2, "UTMALDG": 1,
                                           "SYNCS": 1},
        "flash_bwd_dq_kernel<64,64>": {"HGMMA": 0, "UTMALDG": 0, "SYNCS": 0}}


def _smoke(*args):
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ,
                                                PYTHONPATH=str(REPO)))


def test_chip_smoke_fails_without_a_card(no_card):
    out = _smoke()
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "no CUDA device" in out.stdout


def test_chip_smoke_cpu_rehearsal_prints_no_result(no_card):
    """The CPU rehearsal drives every phase with the plain versions at tiny
    sizes (profile and turns included) and never prints a result line."""
    out = _smoke("--cpu-dry", "--profile", "--turns", "2")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "DRY RUN complete" in out.stdout
    for phase in ("adamw_multi model:", "adamw_multi mixed:",
                  "flat_adamw world-1 shard:", "flat_adamw ragged:",
                  "timing the AdamW kernels", "fused_adamw vs sharded_adamw",
                  "slice (hooks:", "slice (fused:", "slice (zero:",
                  "losses of zero vs hooks", "2 turns of the three paths",
                  "sba: ", "timing sba over one Inception-V3 forward",
                  "conv_bn_stats 2x6x6x32->32",
                  "tiny Inception-V3 2 x 75^2 on cpu",
                  "InceptionE train mode on cpu",
                  "slice (Inception-V3)", "fused case e_d128",
                  "timing fused case a", "probe pack2 B1 H2 S96 D64",
                  "probe data tool: control uniform attention",
                  "probe data unit: control half sm_scale",
                  "probe simple1_lse B1 H2 S96 D64, unit data",
                  "probe functions driven once each",
                  "timing the probe kernels", "slice (GPT-2, dq + dk/dv)",
                  "slice (GPT-2, fused backward B7)",
                  "GPT-2 losses, fused backward vs dq + dk/dv"):
        assert phase in out.stdout, phase
    assert "BERT-Large MLM" in out.stdout
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_time_ms_on_the_cpu_times_the_calls_after_warm_up():
    """``utils.measure.time_ms`` on the CPU: three warm-up calls, then the
    host clock around ``iters`` calls."""
    from horovod_tpu_torch.utils import measure

    calls = []
    ms = measure.time_ms(lambda: calls.append(1), 5, torch.device("cpu"))
    assert len(calls) == 3 + 5 and ms >= 0.0


def test_forward_before_after_tool_reads_chip_smokes_shapes_by_its_timer():
    """``tools/fwd_before_after.py`` times the forward at ``chip_smoke.py``'s
    timed flash cases, its probes at the probe phase's shape, and with this
    checkout's ``time_ms`` whichever checkout it imports, so its numbers and
    the kernels line's are read by one method."""
    import chip_smoke
    from horovod_tpu_torch.tools import fwd_before_after as tool
    from horovod_tpu_torch.utils import measure

    assert set(tool.SHAPES) == set(chip_smoke.FULL["timed"])
    for name, shape in tool.SHAPES.items():
        assert chip_smoke.FULL["cases"][name] == (*shape, 0, 0), name
    assert chip_smoke.FULL["vprobe_case"] == tool.SHAPES["a"][:4]
    timer = tool.this_timer()
    assert Path(timer.__file__).resolve() == Path(measure.__file__).resolve()
    assert timer.time_ms.__doc__ == measure.time_ms.__doc__
