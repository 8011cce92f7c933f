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
from horovod_tpu_torch.models.resnet import ResNet50
from horovod_tpu_torch.models.transformer import BertLarge, GPT2Small
from horovod_tpu_torch.ops import conv_bn_act as tcba
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.ops import fused_adamw as tadam
from horovod_tpu_torch.ops import kernel_build
from horovod_tpu_torch.ops import fused_optimizer as topt
from horovod_tpu_torch.tools import conv_bn_probe as tprobe
from horovod_tpu_torch.tools import flash_vpu_probe as tvprobe

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "horovod_tpu")


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


def _public_names(path: Path) -> list:
    """The names a package's ``__init__`` makes public, in its order: what
    it imports from modules, and its own public functions and classes."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


def test_public_surface_is_the_jax_bindings_but_mesh():
    """Every public name of ``horovod_tpu.torch`` (read from its source,
    not imported: the port never imports the JAX package) exists in the
    port, and the port's ``__init__`` names them in the same order.
    ``mesh`` has no counterpart: PyTorch has no device mesh of that kind."""
    theirs = _public_names(REPO / "horovod_tpu" / "torch" / "__init__.py")
    assert "mesh" in theirs and "DistributedOptimizer" in theirs
    theirs.remove("mesh")
    missing = [n for n in theirs if not hasattr(hvd, n)]
    assert not missing, missing
    ours = _public_names(REPO / "horovod_tpu_torch" / "__init__.py")
    assert [n for n in ours if n in theirs] == theirs
    assert not hasattr(hvd, "mesh")


def _all_of(path: Path) -> list:
    """A package ``__init__``'s ``__all__``, read from its source."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


# The reference's exports whose modules the port does not have yet, each
# with the ROADMAP queue-A item that brings it: none is left.
UNPORTED_EXPORTS = {}
# Exports the port leaves out by decision: the device mesh and its axis
# names (PyTorch has no device mesh of that kind), and the
# single-controller stacked mode's ``stack_per_worker`` (one process a GPU
# has no stacked worker dimension).
DECIDED_OUT = {"mesh", "CROSS_AXIS", "LOCAL_AXIS", "GLOBAL_AXES",
               "stack_per_worker"}


@pytest.mark.parametrize("init,module", [
    ("__init__.py", "horovod_tpu_torch"),
    ("models/__init__.py", "horovod_tpu_torch.models"),
    ("parallel/__init__.py", "horovod_tpu_torch.parallel"),
])
def test_reference_exports_resolve_in_the_port(init, module):
    """Every name of the JAX package's ``__all__`` (the package, its
    models and its parallel package) resolves in the port's counterpart,
    unless its module is not ported yet (then it is listed with its
    queue-A item and must not resolve: a listed name that the port has
    gets off the list) or it is out by decision. ``mesh`` stays out."""
    import importlib

    theirs = _all_of(REPO / "horovod_tpu" / init)
    ours = importlib.import_module(module)
    missing = [n for n in theirs if not hasattr(ours, n)
               and n not in UNPORTED_EXPORTS and n not in DECIDED_OUT]
    assert not missing, missing
    stale = [n for n in theirs if hasattr(ours, n)
             and (n in UNPORTED_EXPORTS or n in DECIDED_OUT)]
    assert not stale, stale
    assert UNPORTED_EXPORTS == {}
    assert not hasattr(hvd, "mesh")
    if module == "horovod_tpu_torch.models":
        assert ours.ResNet50 is ResNet50 and ours.BertLarge is BertLarge
    if module == "horovod_tpu_torch":
        assert hvd.ddl_built() is False and hvd.mlsl_built() is False
        assert callable(hvd.grouped_allreduce_async)
        assert callable(hvd.dump_debug_state)
        assert callable(hvd.serve) and hvd.tracing.__name__ == \
            "horovod_tpu_torch.tracing"


def test_serve_is_the_function_and_its_package_still_imports():
    """``hvd.serve`` is the function (as ``horovod_tpu.serve`` is the JAX
    package's root attribute), while ``horovod_tpu_torch.serve`` stays a
    package reachable through ``sys.modules``: its modules import with
    ``from``, after ``import horovod_tpu_torch``, in a fresh process."""
    code = ("import sys, horovod_tpu_torch as hvd\n"
            "from horovod_tpu_torch.serve.kv_cache import DecodeEngine\n"
            "from horovod_tpu_torch.serve import paging\n"
            "pkg = sys.modules['horovod_tpu_torch.serve']\n"
            "assert callable(hvd.serve) and hvd.serve is pkg.serve\n"
            "assert pkg.__path__ and DecodeEngine.__module__ == "
            "'horovod_tpu_torch.serve.kv_cache'\n"
            "assert paging.PagedDecodeEngine is pkg.PagedDecodeEngine\n"
            "assert hvd.ServePolicy is pkg.ServePolicy\n"
            "assert 'jax' not in sys.modules\n"
            "import threading\n"
            "assert threading.active_count() == 1, threading.enumerate()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_distributed_gradient_tape_reduces_a_gradient_function(monkeypatch):
    """``DistributedGradientTape`` wraps a function that returns gradients
    (``torch.func.grad``'s) and gives them back averaged, in each of the
    JAX package's three return conventions."""
    for k in ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_COORDINATOR_ADDR"):
        monkeypatch.delenv(k, raising=False)
    hvd.shutdown()
    hvd.init(device="cpu")
    try:
        def loss(p, x):
            return ((p["w"] * x).sum() - 1.0) ** 2

        x = torch.arange(3.0)
        p = {"w": torch.ones(3)}
        want = torch.func.grad(loss)(p, x)
        got = hvd.DistributedGradientTape(torch.func.grad(loss))(p, x)
        assert torch.equal(got["w"], want["w"])
        val, g = hvd.DistributedGradientTape(
            lambda *a: (loss(*a), torch.func.grad(loss)(*a)),
            returns="value_and_grads")(p, x)
        assert torch.equal(g["w"], want["w"]) and float(val) == 4.0
        g, aux = hvd.DistributedGradientTape(
            torch.func.grad_and_value(loss), returns="grads_and_aux")(p, x)
        assert torch.equal(g["w"], want["w"]) and float(aux) == 4.0
        with pytest.raises(ValueError):
            hvd.DistributedGradientTape(lambda: None, returns="bad")
    finally:
        hvd.shutdown()


def test_observability_planes_leave_jax_out_and_start_nothing(tmp_path):
    """The four planes import no JAX; configured for the CPU, fed and
    dumped, they start no thread (the memory sampler runs for a card only)
    and open no socket."""
    code = (
        "import os, sys, threading\n"
        "import torch\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import comms, flight_recorder, goodput,"
        " memory\n"
        "memory.configure(rank=0, device='cpu')\n"
        "comms.configure(rank=0, world=1)\n"
        "goodput.configure(rank=0, world=1)\n"
        "memory.tracker().note_tree_bytes('params', [torch.ones(4)])\n"
        "comms.record('allreduce', 'device', 16, 0.001)\n"
        "goodput.record_step(0.01)\n"
        "hvd.dump_debug_state(path='d.json')\n"
        "assert memory.memory_state()['subsystems']['params']['bytes'] "
        "== 16\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "socks = []\n"
        "for fd in os.listdir('/proc/self/fd'):\n"
        "    try:\n"
        "        link = os.readlink('/proc/self/fd/' + fd)\n"
        "    except OSError:\n"
        "        continue\n"
        "    if link.startswith('socket:'):\n"
        "        socks.append(link)\n"
        "assert not socks, socks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for knob in ("HOROVOD_RENDEZVOUS_HTTP_ADDR", "HOROVOD_RENDEZVOUS_HTTP_PORT",
                 "HOROVOD_METRICS_PORT", "HOROVOD_MEMORY"):
        env.pop(knob, None)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)
    assert (tmp_path / "d.json").exists()


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, horovod_tpu_torch, horovod_tpu_torch.models.convert,"
            " horovod_tpu_torch.models.transformer,"
            " horovod_tpu_torch.models.inception,"
            " horovod_tpu_torch.models.resnet,"
            " horovod_tpu_torch.ops.conv_bn_act, horovod_tpu_torch.training,"
            " horovod_tpu_torch.tools.conv_bn_probe,"
            " horovod_tpu_torch.utils.device,"
            " horovod_tpu_torch.runtime.runtime,"
            " horovod_tpu_torch.runtime.gloo_controller,"
            " horovod_tpu_torch.stall, horovod_tpu_torch.timeline;"
            " bad = [m for m in sys.modules if m.split('.')[0] in %r];"
            " assert not bad, bad" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_new_runtime_modules_leave_jax_out_and_start_nothing():
    """Importing the port, its metrics, native loader, timeline and stall
    modules (and reading ``hvd.metrics()``) imports no JAX, starts no
    thread and opens no socket: the endpoint and the writers exist only
    when a knob or a call asks for them."""
    code = (
        "import os, sys, threading\n"
        "import horovod_tpu_torch as hvd, horovod_tpu_torch.metrics\n"
        "import horovod_tpu_torch.runtime.native\n"
        "import horovod_tpu_torch.runtime.runtime\n"
        "import horovod_tpu_torch.timeline, horovod_tpu_torch.stall\n"
        "hvd.metrics()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "socks = []\n"
        "for fd in os.listdir('/proc/self/fd'):\n"
        "    try:\n"
        "        link = os.readlink('/proc/self/fd/' + fd)\n"
        "    except OSError:  # the listing's own descriptor\n"
        "        continue\n"
        "    if link.startswith('socket:'):\n"
        "        socks.append(link)\n"
        "assert not socks, socks\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for knob in ("HOROVOD_METRICS_PORT", "HOROVOD_TIMELINE"):
        env.pop(knob, None)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_training_api_leaves_jax_out_and_starts_nothing(tmp_path):
    """The training API, the profiler, the step guard, the callbacks and
    the examples import no JAX; ``hvd.profiler``, ``hvd.callbacks``,
    ``hvd.training`` and ``hvd.integrity`` are modules; after ``init(device=
    "cpu")`` with no knob set the profiler is off and records nothing, and
    no thread and no file exist (run in an empty directory)."""
    code = (
        "import os, sys, threading, types\n"
        "import horovod_tpu_torch as hvd\n"
        "import horovod_tpu_torch.examples.synthetic_benchmark\n"
        "import horovod_tpu_torch.examples.mnist\n"
        "import horovod_tpu_torch.examples.bert_large_sparse\n"
        "import horovod_tpu_torch.integrity.guards\n"
        "for name in ('profiler', 'callbacks', 'training', 'integrity'):\n"
        "    assert isinstance(getattr(hvd, name), types.ModuleType), name\n"
        "hvd.init(device='cpu')\n"
        "assert not hvd.profiler.enabled() and not hvd.integrity.enabled()\n"
        "with hvd.profiler.step() as rec:\n"
        "    hvd.profiler.auto_step()\n"
        "assert rec is None and hvd.profiler.history() == []\n"
        "assert hvd.profiler.profiler()._device_trace is None\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "hvd.shutdown()\n"
        "assert os.listdir('.') == [], os.listdir('.')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for knob in ("HOROVOD_METRICS_PORT", "HOROVOD_METRICS_DUMP",
                 "HOROVOD_TIMELINE", "HOROVOD_PROFILE", "HOROVOD_PROFILE_DIR",
                 "HOROVOD_PROFILE_JAX", "HOROVOD_INTEGRITY"):
        env.pop(knob, None)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)


def test_checkpoint_layer_leaves_jax_out_and_starts_nothing(tmp_path):
    """The checkpoint layer (``checkpoint``, ``ckpt``, ``elastic.
    fault_inject``, ZeRO's export and re-slice) imports no JAX, flax or
    msgpack; ``hvd.checkpoint`` and ``hvd.ckpt`` are modules; importing it
    starts no thread, and a manager starts its writer thread only at its
    first asynchronous commit."""
    code = (
        "import os, sys, threading, types\n"
        "import horovod_tpu_torch as hvd\n"
        "import horovod_tpu_torch.checkpoint, horovod_tpu_torch.ckpt\n"
        "import horovod_tpu_torch.elastic.fault_inject\n"
        "from horovod_tpu_torch.ckpt import (io, manifest, replica, restore,\n"
        "                                    stats, tree, writer)\n"
        "from horovod_tpu_torch.parallel import zero\n"
        "for name in ('checkpoint', 'ckpt'):\n"
        "    assert isinstance(getattr(hvd, name), types.ModuleType), name\n"
        "assert issubclass(hvd.CheckpointCorruptError, RuntimeError)\n"
        "for name in ('is_sharded_state', 'layout_of', 'export_shard_arrays',\n"
        "             'from_full_buffers'):\n"
        "    assert callable(getattr(zero, name)), name\n"
        "mgr = hvd.ckpt.CheckpointManager('ck', async_write=True)\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)


def test_elastic_layer_leaves_jax_out_and_starts_nothing(tmp_path):
    """The elastic layer (``elastic``, ``run.rendezvous``,
    ``utils.resilience``, ``integrity``) imports no JAX; ``hvd.elastic`` is
    a module; importing it, building a state and parsing the faults starts
    no thread and opens no socket: the store, the heartbeat and the driver
    exist only when a caller starts them."""
    code = (
        "import os, sys, threading, types\n"
        "import torch\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.elastic import driver, runner, state\n"
        "from horovod_tpu_torch.run import rendezvous\n"
        "from horovod_tpu_torch.utils import resilience\n"
        "from horovod_tpu_torch.integrity import digest, inject, rollback\n"
        "assert isinstance(hvd.elastic, types.ModuleType)\n"
        "st = hvd.elastic.ArrayState({'w': torch.ones(2)}, None)\n"
        "st.commit()\n"
        "resilience.parse_net_faults('flaky:0.5;kv_outage:3')\n"
        "hvd.elastic.fault_inject.specs_from_env()\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "socks = []\n"
        "for fd in os.listdir('/proc/self/fd'):\n"
        "    try:\n"
        "        link = os.readlink('/proc/self/fd/' + fd)\n"
        "    except OSError:\n"
        "        continue\n"
        "    if link.startswith('socket:'):\n"
        "        socks.append(link)\n"
        "assert not socks, socks\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
        "assert not bad, bad\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for knob in ("HOROVOD_RENDEZVOUS_HTTP_ADDR", "HOROVOD_RENDEZVOUS_HTTP_PORT",
                 "HOROVOD_FAULT_INJECT", "HOROVOD_CKPT_DIR",
                 "HOROVOD_ELASTIC_SPILL_DIR"):
        env.pop(knob, None)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, timeout=120)


def _exported(path: Path) -> set:
    import re

    text = path.read_text()
    block = text[text.index('extern "C" {'):]
    return set(re.findall(r"^\w[\w\s\*]*?\b(hv\w+)\(", block, re.M))


def test_native_library_is_built_from_the_ports_sources_only(monkeypatch,
                                                             tmp_path):
    """The cycle engine and trace writer are the port's own copies
    (``horovod_tpu_torch/cpp``) with the JAX package's C ABI, compiled by
    one command that names no file outside that folder; the JAX package's
    ``cpp/`` and its transport library are never built or loaded."""
    from horovod_tpu_torch.runtime import native

    assert native.CPP == REPO / "horovod_tpu_torch" / "cpp"
    ours = set().union(*(_exported(native.CPP / s) for s in native.SOURCES))
    theirs = set().union(*(_exported(REPO / "horovod_tpu" / "cpp" / s)
                           for s in native.SOURCES))
    assert len(theirs) == 13 and ours == theirs | {"hvd_cycle_abi_version"}
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    so = native.build()
    assert so.parent == tmp_path and so.exists()
    (cmd,) = calls
    files = [Path(a) for a in cmd if a.endswith(".cc")]
    assert files == [native.CPP / s for s in native.SOURCES]
    for f in _port_files():
        text = f.read_text()
        assert "libhvdtpu_net" not in text, f
        assert "horovod_tpu/cpp" not in text, f


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
    lambda: ResNet50(),
], ids=["inception", "bert-large", "gpt2-small", "resnet50"])
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
    arguments, and their HGMMA, UTMALDG, UBLKCP and SYNCS instructions
    counted, predicated ones included: the forward's, the probe's, the
    backward's (dq, dk/dv, fused) and the conv's kernels (an instance by
    its N tile, not a head dim), the flat AdamW kernel's bulk copies, and
    none in a kernel without them, read by its name alone when it has no
    template arguments."""
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
                Function : _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a419flash_bwd_dq_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16iiifiii
        /*0010*/                   SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR4], RZ ;
        /*0020*/              @!P1 UTMALDG.3D [UR16], [UR6] ;
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R88, gdesc[UR8], R88, gsb0 ;
        /*0040*/                   HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR12], R24, gsb0 ;
                Function : _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a420flash_bwd_dkv_kernelILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_iiifiii
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0020*/                   UTMALDG.3D [UR8], [UR10] ;
        /*0030*/                   HGMMA.64x64x16.F32.BF16 R24, R8, gdesc[UR8], R24 ;
                Function : _ZN51_GLOBAL__N__614f4d45_18_flash_attention_cu_6c7cf8a422flash_bwd_fused_kernelILi128EEEv14CUtensorMap_stS1_S1_S1_PKfS3_P13__nv_bfloat16S5_S5_PfPiiiifiii
        /*0010*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR4], R3 ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0030*/              @!P2 UTMALDG.3D [UR8], [UR10] ;
                Function : _ZN49_GLOBAL__N__2a1f5c3b_16_conv_bn_stats_cu_5b1d9e2e20conv3x3_stats_kernelILi128EEEv14CUtensorMap_stPK13__nv_bfloat16PS2_PfS6_iiiii
        /*0010*/                   UTMALDG.2D [UR8], [UR10] ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0030*/                   SYNCS.ARRIVE.TRANS64.A1T0 RZ, [UR4], RZ ;
                Function : _ZN49_GLOBAL__N__2a1f5c3b_16_conv_bn_stats_cu_5b1d9e2e17column_sum_kernelEPKfS1_PfS2_ii
        /*0010*/                   FADD R4, R4, R5 ;
                Function : _ZN40_GLOBAL__N__4c957c12_8_adamw_cu_8b6950d017flat_adamw_kernelI13__nv_bfloat16fEEvPfS2_S2_PKT_PT0_lNS_7ScalarsE
        /*0010*/                   SYNCS.EXCH.64 URZ, [UR4], UR6 ;
        /*0020*/                   UBLKCP.S.G [UR8], [UR10], UR12 ;
        /*0030*/                   UBLKCP.S.G [UR8], [UR14], UR12 ;
"""
    monkeypatch.setattr(chip_smoke.kernel_build, "nvcc",
                        lambda: "/opt/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **k: types.SimpleNamespace(stdout=sass))
    wgmma = {"UBLKCP": 0}
    assert chip_smoke.sass_counts("attention_probe") == {
        "probe_fwd_kernel<128,64,false>": {"HGMMA": 2, "UTMALDG": 1,
                                           "SYNCS": 1, **wgmma},
        "flash_bwd_dq_kernel<128>": {"HGMMA": 2, "UTMALDG": 1, "SYNCS": 1,
                                     **wgmma},
        "flash_bwd_dkv_kernel<64>": {"HGMMA": 1, "UTMALDG": 1, "SYNCS": 1,
                                     **wgmma},
        "flash_bwd_fused_kernel<128>": {"HGMMA": 1, "UTMALDG": 1, "SYNCS": 1,
                                        **wgmma},
        "conv3x3_stats_kernel<128>": {"HGMMA": 1, "UTMALDG": 1, "SYNCS": 1,
                                      **wgmma},
        "column_sum_kernel": dict.fromkeys(chip_smoke.SASS_OPS, 0),
        "flat_adamw_kernel<bf16,f32>": {"HGMMA": 0, "UTMALDG": 0,
                                        "UBLKCP": 2, "SYNCS": 1}}


def _witness_counts(missing=None, lacking=None):
    """SASS counts of every instance the witness expects, less the
    instance ``missing`` and with none of its own copy instruction
    (UTMALDG, or UBLKCP for the flat AdamW kernel) in ``lacking``."""
    import chip_smoke

    counts = {lib: {} for lib in chip_smoke.HOPPER_KERNELS}
    for lib, kernels in chip_smoke.HOPPER_KERNELS.items():
        for kernel, (firsts, ops) in kernels.items():
            args = ("64,64,true", "128,128,true", "128,64,false") \
                if kernel == "probe_fwd_kernel" else firsts
            for a in args:
                counts[lib][f"{kernel}<{a}>"] = {
                    op: (20 if op == "SYNCS" else 4) if op in ops else 0
                    for op in chip_smoke.SASS_OPS}
    # a kernel of a witnessed library that is not witnessed
    counts["conv_bn_stats"]["column_sum_kernel"] = dict.fromkeys(
        chip_smoke.SASS_OPS, 0)
    for lib in counts:
        counts[lib].pop(missing, None)
        if lacking in counts[lib]:
            copy = "UBLKCP" if lib == "adamw" else "UTMALDG"
            counts[lib][lacking][copy] = 0
    return counts


@pytest.mark.parametrize("fault", [None, "missing", "lacking", "serialised",
                                   "conv missing", "fused lacking",
                                   "flat lacking"])
def test_sass_witness_holds_every_wgmma_kernel_at_both_head_dims(
        monkeypatch, fault):
    """``chip_smoke.hopper_witness`` holds the forward, dq, dk/dv and fused
    backward kernels of ``flash_attention`` and the probe kernel of
    ``attention_probe`` to HGMMA, UTMALDG and SYNCS in a D64 and a D128
    instance each, the conv kernel of ``conv_bn_stats`` in its N-tile
    instances of 64 and 128 (its own entry: it has no head dim), and the
    flat AdamW kernel of ``adamw`` to UBLKCP (1-D bulk copies) and SYNCS in
    its f32 and bf16 gradient instances: it fails when an instance is
    missing or lacks one of them, or when ptxas reports a serialised
    wgmma."""
    import chip_smoke

    wgmma = (chip_smoke.HEAD_DIMS, chip_smoke.WGMMA_OPS)
    assert chip_smoke.HOPPER_KERNELS["flash_attention"] == dict.fromkeys(
        ["flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
         "flash_bwd_fused_kernel"], wgmma)
    assert chip_smoke.HOPPER_KERNELS["conv_bn_stats"] == {
        "conv3x3_stats_kernel": (("64", "128"), chip_smoke.WGMMA_OPS)}
    assert chip_smoke.HOPPER_KERNELS["adamw"] == {
        "flat_adamw_kernel": (("f32", "bf16"), ("UBLKCP", "SYNCS"))}
    counts = _witness_counts(
        missing={"missing": "flash_bwd_dkv_kernel<128>",
                 "conv missing": "conv3x3_stats_kernel<64>"}.get(fault),
        lacking={"lacking": "flash_bwd_dq_kernel<64>",
                 "fused lacking": "flash_bwd_fused_kernel<128>",
                 "flat lacking": "flat_adamw_kernel<bf16>"}.get(fault))
    ptxas = ("ptxas info    : (C7512) Potential Performance Loss: "
             "wgmma.mma_async instructions are serialized due to "
             "insufficient register resources" if fault == "serialised"
             else "ptxas info    : Used 168 registers")
    monkeypatch.setattr(chip_smoke, "sass_counts", lambda lib: counts[lib])
    monkeypatch.setattr(chip_smoke.kernel_build, "build_log",
                        lambda lib: ptxas)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    if fault is None:
        chip_smoke.hopper_witness()
    else:
        with pytest.raises(SystemExit):
            chip_smoke.hopper_witness()


def test_backward_kernels_run_the_hopper_backward_mainloop():
    """dq, dk/dv and the fused backward B7 run ``csrc/attention_bwd_sm90.cuh``,
    a source of the flash_attention library (its edits rebuild it) built on
    the forward header's wgmma primitives; none keeps the mma.sync tiles or
    the hand transposes (``mma16816``, ``load_tile_t``) of the first
    designs, and the header that held them is gone."""
    header = "attention_bwd_sm90.cuh"
    assert header in [p.name for p in kernel_build.sources("flash_attention")]
    assert not (kernel_build.CSRC / "mma_tiles.cuh").exists()
    src = (kernel_build.CSRC / "flash_attention.cu").read_text()
    bwd = src[src.index("flash_bwd_dq_kernel("):]
    for mainloop in ("attention_bwd_dq_sm90<", "attention_bwd_dkv_sm90<",
                     "attention_bwd_fused_sm90<"):
        assert mainloop in bwd, mainloop
    mainloop = (kernel_build.CSRC / header).read_text()
    for old in ("mma16816", "load_tile_t", "load_b(", "c_to_a(",
                "mma.sync.aligned"):
        assert old not in src and old not in mainloop, old


def test_conv_kernel_is_a_wgmma_implicit_gemm_on_the_forward_primitives():
    """B11 runs on the forward header's wgmma, TMA and mbarrier primitives
    (an edit to the header rebuilds it): its weights come in by a 2-D TMA
    map, its activations by cp.async into the swizzled stages, and no
    mma.sync body of its first design is left."""
    header = "attention_fwd_sm90.cuh"
    assert header in [p.name for p in kernel_build.sources("conv_bn_stats")]
    src = (kernel_build.CSRC / "conv_bn_stats.cu").read_text()
    for used in ("wgmma_ss_n128<", "wgmma_ss_n64<", "tma_load_2d(",
                 "encode_2d(", "cp.async.cg.shared.global", "mbar_wait("):
        assert used in src, used
    for old in ("mma16816", "mma.sync.aligned", "Bs[(nv + j)"):
        assert old not in src, old


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
                  "GPT-2 losses, fused backward vs dq + dk/dv",
                  "runtime per step (hooks):",
                  "slice (hooks, fusion threshold 0:",
                  "hooks losses, threshold 0 vs phase 4",
                  "phase 4b rehearsed", "engine native: cache "
                  "NativeResponseCache", "engine python: cache ResponseCache",
                  "phase 4c: losses bit-equal on both engines",
                  "cycle markers", "GET /metrics: status 200",
                  "runtime per step (Inception-V3):",
                  "runtime per step (GPT-2, fused backward B7):",
                  "slice (ResNet-50)", "runtime per step (ResNet-50):",
                  "collectives through the runtime at world 1",
                  "10a training API", "10b profiler cost",
                  "10c profiler on BERT-Large hooks", "10d integrity guard",
                  "10d NaN step skipped", "10e example bert_large_sparse",
                  "11a P2 checkpoint", "11b in-place hazard",
                  "11c rank-0 checkpoint", "11c corrupt copy",
                  "12a re-form", "12b rollback in place",
                  "digest on/off in turns", "phase 12 kernel launches",
                  "goodput: 1 elastic_reform incident(s)",
                  "12b goodput: 1 rollback incident(s)", "13 routes:",
                  "13 memory:", "13 comms:", "13 OOM record:",
                  "13 goodput:", "13 observability planes on BERT-Large P2",
                  "phase 13 kernel launches", "13 P4 (stage 2",
                  "14a BERT-Large fused_qkv + remat", "first loss",
                  "14b VGG-16", "fc1.kernel", "14c MoE LM",
                  "alltoalls issued a step", "GPT-2-small loss turns",
                  "phase 14 kernel launches", "15a probes at world 1",
                  "15a probe cache: written, read back",
                  "15b autotune on BERT-Large", "autotune_commit",
                  "frozen knobs:", "losses (bit-equal to phase 4's)",
                  "step ms in turns", "phase 15 kernel launches",
                  "16a: ring steps over 4 shards",
                  "16b: ring_attention losses bit-equal to phase 7's: True",
                  "16b: ulysses_attention losses bit-equal to phase 7's: "
                  "True", "16b: pipeline_apply, 1 stage",
                  "phase 16 kernel launches", "17a dense:", "17a paged:",
                  "17b dense: 8 requests", "17b paged: 8 requests",
                  "served tokens vs the teacher-forced uncached forward",
                  "17b goodput:", "phase 17 kernel launches",
                  "18a: tpurun-torch -np 1 ran BERT-tiny MLM",
                  "18a: each step's wait for its batch",
                  "18a: losses bit-equal to the in-process run",
                  "18a: --postmortem over the dumps",
                  "18b: serve_kill_replica (tiny): ok=True",
                  "suspected culprit: rank 2",
                  "18b: the survivors' tokens vs the teacher-forced",
                  "phase 18 kernel launches"):
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


def test_backward_before_after_tool_reads_chip_smokes_shapes_by_its_timer():
    """``tools/bwd_before_after.py`` times dq, dk/dv, the two together and
    aten's flash backward at ``chip_smoke.py``'s timed flash cases (the
    forward tool's shapes), and B7 at phase 2f's timed cases, the shapes
    the backward sends it, by this checkout's ``time_ms`` whichever
    checkout it imports, and runs its turns through the forward tool's
    loop."""
    import chip_smoke
    from horovod_tpu_torch.tools import bwd_before_after as tool
    from horovod_tpu_torch.tools import fwd_before_after as fwd
    from horovod_tpu_torch.utils import measure

    assert tool.SHAPES == fwd.SHAPES
    assert set(tool.SHAPES) == set(chip_smoke.FULL["timed"])
    for name, shape in tool.SHAPES.items():
        assert chip_smoke.FULL["cases"][name] == (*shape, 0, 0), name
    assert tool.FUSED == chip_smoke.FULL["fused_timed"]
    for name in tool.FUSED:
        b, h, s, d, causal = tool.SHAPES[name]
        assert s <= tfa.FUSED_MAX_SEQ
        assert chip_smoke.FULL["fused_cases"][name] == (b, h, s, s, d, causal,
                                                        0, 0), name
    timer = tool.this_timer()
    assert Path(timer.__file__).resolve() == Path(measure.__file__).resolve()
    assert Path(tool.FWD.__file__).resolve() == Path(fwd.__file__).resolve()
    assert tool.FWD.HERE == fwd.HERE == REPO


def test_conv_before_after_tool_reads_the_probes_sweep_by_its_timer():
    """``tools/conv_before_after.py`` times B11 and its two cuDNN
    yardsticks at the probe's sweep (``chip_smoke.py``'s phase-2e shapes),
    by this checkout's ``time_ms`` whichever checkout it imports, and runs
    its turns through the forward tool's loop; its module imports nothing
    of the package at its top, so a worker can import another checkout's."""
    import chip_smoke
    from horovod_tpu_torch.tools import conv_before_after as tool
    from horovod_tpu_torch.tools import fwd_before_after as fwd
    from horovod_tpu_torch.utils import measure

    assert tool.SWEEP == tprobe.SWEEP and tool.BATCH == tprobe.BATCH
    assert chip_smoke.FULL["probe_shapes"] == tuple(
        (tool.BATCH, size, c) for size, c in tool.SWEEP)
    timer = tool.this_timer()
    assert Path(timer.__file__).resolve() == Path(measure.__file__).resolve()
    assert Path(tool.FWD.__file__).resolve() == Path(fwd.__file__).resolve()
    assert tool.FWD.HERE == REPO
    top = ast.parse(Path(tool.__file__).read_text()).body
    imported = [a.name for node in top if isinstance(node, ast.Import)
                for a in node.names]
    imported += [node.module for node in top
                 if isinstance(node, ast.ImportFrom)]
    assert not [m for m in imported if m.startswith("horovod_tpu_torch")]


def test_fused_wait_probe_patches_the_kernel_the_package_runs(tmp_path):
    """``tools/fused_wait_probe.py`` measures B7's waits for a dq turn in a
    patched copy of the sources: each of its anchors occurs once in the
    package's current sources (so the copy is the kernel the package runs,
    plus counters), the copy gains the counters and their reader, and the
    package's own sources carry none."""
    from horovod_tpu_torch.tools import fused_wait_probe as tool

    copy = tool.patched_sources(tmp_path / "csrc")
    header = (copy / "attention_bwd_sm90.cuh").read_text()
    assert header.count("atomicAdd(&g_wait_cycles") == 1
    assert header.count("atomicAdd(&g_span_cycles") == 1
    assert "hvd_wait_cycles" in (copy / "flash_attention.cu").read_text()
    for name in ("attention_bwd_sm90.cuh", "flash_attention.cu"):
        assert "g_wait_cycles" not in (kernel_build.CSRC / name).read_text()
    assert set(tool.SHAPES) >= {"a", "b"}


def test_runtime_before_after_tool_rehearses_on_the_cpu():
    """The runtime tool's turn loop and step breakdown on the CPU, one
    layer deep: this checkout's runtime at its defaults and at threshold 0
    against the same checkout taken as the other one."""
    import json

    out = subprocess.run(
        [sys.executable, "horovod_tpu_torch/tools/runtime_before_after.py",
         "--cpu", "--other", str(REPO), "--configs", "fused,t0",
         "--turns", "1", "--steps", "1", "--layers", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    medians = rows[-1]["medians"]
    assert set(medians) == {"bert other", "bert fused", "bert t0"}
    n = medians["bert t0"]["requested_allreduce"]
    assert medians["bert t0"]["runtime_allreduce"] == n
    assert 0 < medians["bert fused"]["runtime_allreduce"] <= n
    for config in medians.values():
        assert config["step_ms"] > 0


def test_resnet_bn_choice_tool_rehearses_on_the_cpu():
    """The B10-or-plain tool's turn on the CPU, a small ResNet-50 step:
    both variants train to the same losses (the same function)."""
    import json

    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.tools.resnet_bn_choice",
         "--cpu", "--turns", "1", "--steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["variant"] for r in rows[:2]] == ["b10", "plain"]
    np.testing.assert_allclose(rows[0]["losses"], rows[1]["losses"],
                               rtol=1e-5)
    assert set(rows[-1]["step_ms_median"]) == {"b10", "plain"}
    assert rows[-1]["where"] == "cpu rehearsal"
