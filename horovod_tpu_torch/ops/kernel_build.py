"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` holds kernels behind a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/horovod_tpu_torch/`` at the root of the checkout, named by a hash of
the source, the ``csrc`` headers it includes (``#include "..."``) and its
flags (:data:`NVCC_FLAGS` plus the source's own :data:`EXTRA_FLAGS`), so an
edited source or header rebuilds the sources that use it and an unchanged
one is built once. Nothing is built at import: the first call that needs a
kernel builds it (or :func:`build` does, for every source at once).

There is no PyTorch header in the sources, so a build takes seconds; the
binding is ``ctypes`` with declared argument types, pointers from
``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.

It also holds what every kernel wrapper shares: :func:`on_cpu` picks the
route (the plain version for CPU tensors, the kernel for CUDA tensors) and
:func:`check_error` raises on a launch's CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source on top of NVCC_FLAGS. adamw, conv_bn_act: no
# multiply-add contraction, so the kernels round like their plain PyTorch
# versions
EXTRA_FLAGS: Dict[str, tuple] = {"adamw": ("-fmad=false",),
                                 "conv_bn_act": ("-fmad=false",)}

_libs: Dict[str, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on ``PATH``."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from horovod_tpu_torch/csrc at first use")


def flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another header, in the order first met."""
    files = [CSRC / f"{name}.cu"]
    for f in files:  # grows while it is walked
        for inc in _LOCAL_INCLUDE.findall(f.read_bytes()):
            header = CSRC / inc.decode()
            if header not in files:
                files.append(header)
    return files


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in sources(name))
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) goes to ``<library>.log``. Raises
    with the compiler's errors if any build fails."""
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, so in paths.items():
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        so = paths[name]
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{out}")
            continue
        os.replace(tmp, so)  # atomic: concurrent builds race harmlessly
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """What the compiler printed for the current library of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def on_cpu(what: str, tensors) -> bool:
    """Which route a wrapper takes: True when every tensor lies on the CPU
    (the plain version), False when all lie on one CUDA device (the
    kernel); anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{what} inputs on several devices: "
                         f"{sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{what} has no kernel for {device}")
    return False


def check_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``lib`` exports
    ``hvd_cuda_error_string``)."""
    if err:
        msg = lib.hvd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel failed: {msg} (cudaError {err})")


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed;
    ``declare`` sets ``argtypes``/``restype`` on its functions once."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        declare(lib)
        _libs[name] = lib
    return lib
