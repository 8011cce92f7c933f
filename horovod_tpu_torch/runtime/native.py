"""The native cycle engine and trace writer, built with ``g++`` and loaded
with ctypes (port of the cycle and timeline part of
``horovod_tpu/runtime/native.py``; the TCP transport, ``cpp/net.cc``, is not
ported: the port's control plane is a gloo process group).

``horovod_tpu_torch/cpp/cycle.cc`` (the response cache's LRU and bits,
``hvc_cache_*``; the fusion bin-packing, ``hvc_fuse``) and ``cpp/
timeline.cc`` (the trace writer on a lock-free ring, ``hvd_tl_*``) are
host code. :func:`load` compiles them into one shared library under
``build/horovod_tpu_torch/`` at the root of the checkout, named by a hash of
the sources and the flags, so an edited source rebuilds and an unchanged
one is built once. Nothing is built at import.

Several processes may build at once (the test workers, the ranks of a
world): an ``fcntl`` lock beside the library serialises them, the compiler
writes to a file of its own and the library takes its name by an atomic
rename, so no process loads a half-written library. The library's
``hvd_cycle_abi_version`` must equal :data:`ABI_VERSION`.

The library is loaded as a ``ctypes.PyDLL``: its calls keep the
interpreter lock. Each takes microseconds; a ``CDLL`` call gives the lock
up and then waits to take it back, and on the cycle thread, beside the
Python of autograd's hooks, those waits made the native cache slower than
the Python one (PERF.md, section 5).

Unlike the JAX package, which falls back to its Python engine without a
word when the library cannot be built, a failure here raises
:class:`NativeBuildError` with the compiler's output: the Python engine
runs only when ``HOROVOD_NATIVE_CYCLE=0`` asks for it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

CPP = Path(__file__).resolve().parent.parent / "cpp"
SOURCES = ("cycle.cc", "timeline.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "horovod_tpu_torch"
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")
ABI_VERSION = 1  # hvd_cycle_abi_version() in cpp/cycle.cc

_lib: Optional[ctypes.PyDLL] = None
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded."""


def compiler() -> str:
    """The C++ compiler: ``$CXX``, else ``g++``."""
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    digest = hashlib.sha256(
        b"".join((CPP / s).read_bytes() for s in SOURCES)
        + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libhvdcycle_{digest[:16]}.so"


def build() -> Path:
    """The library's path, compiled first if no process has built it. The
    compiler's output goes to ``<library>.log``."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():  # built by another process while this one waited
            return so
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [compiler(), *FLAGS, "-o", str(tmp),
               *(str(CPP / s) for s in SOURCES)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            out, rc = proc.stdout + proc.stderr, proc.returncode
        except (OSError, subprocess.TimeoutExpired) as exc:
            out, rc = f"{type(exc).__name__}: {exc}", -1
        so.with_suffix(".log").write_text(out)
        if rc != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"building the native cycle engine failed ({' '.join(cmd)}, "
                f"exit {rc}); HOROVOD_NATIVE_CYCLE=0 runs the Python "
                f"engine instead:\n{out}")
        os.replace(tmp, so)
    return so


def load() -> ctypes.PyDLL:
    """The loaded library, built if needed; raises :class:`NativeBuildError`
    when it cannot be built or loaded, or its ABI version differs."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                lib = ctypes.PyDLL(str(so))
                lib.hvd_cycle_abi_version.restype = ctypes.c_int
                got = lib.hvd_cycle_abi_version()
            except (OSError, AttributeError) as exc:
                raise NativeBuildError(f"loading {so} failed: {exc}") from exc
            if got != ABI_VERSION:
                raise NativeBuildError(
                    f"{so}: ABI version {got}, expected {ABI_VERSION}")
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.PyDLL) -> None:
    c_void_p, c_char_p, c_int64 = ctypes.c_void_p, ctypes.c_char_p, \
        ctypes.c_int64
    # timeline writer (timeline.cc)
    lib.hvd_tl_open.restype = c_void_p
    lib.hvd_tl_open.argtypes = [c_char_p]
    lib.hvd_tl_emit.restype = ctypes.c_int
    lib.hvd_tl_emit.argtypes = [c_void_p, ctypes.c_char, ctypes.c_int,
                                ctypes.c_double, c_char_p, c_char_p,
                                c_char_p]
    lib.hvd_tl_close.argtypes = [c_void_p]
    # response cache and fusion (cycle.cc)
    lib.hvc_cache_new.restype = c_void_p
    lib.hvc_cache_new.argtypes = [c_int64]
    lib.hvc_cache_free.argtypes = [c_void_p]
    lib.hvc_cache_cached.restype = ctypes.c_int
    lib.hvc_cache_cached.argtypes = [c_void_p, c_char_p, c_char_p, c_int64]
    lib.hvc_cache_put.restype = c_int64
    lib.hvc_cache_put.argtypes = [c_void_p, c_char_p, c_char_p, c_int64,
                                  c_char_p, c_int64]
    lib.hvc_cache_bit_for_name.restype = c_int64
    lib.hvc_cache_bit_for_name.argtypes = [c_void_p, c_char_p]
    lib.hvc_cache_get_len.restype = c_int64
    lib.hvc_cache_get_len.argtypes = [c_void_p, c_int64]
    lib.hvc_cache_get.restype = c_int64
    lib.hvc_cache_get.argtypes = [c_void_p, c_int64, c_char_p, c_int64]
    lib.hvc_cache_invalidate.argtypes = [c_void_p, c_char_p]
    lib.hvc_cache_size.restype = c_int64
    lib.hvc_cache_size.argtypes = [c_void_p]
    lib.hvc_fuse.restype = c_int64
    lib.hvc_fuse.argtypes = [
        c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(c_int64),
        ctypes.POINTER(c_int64), c_int64, ctypes.POINTER(ctypes.c_int32),
        c_int64]
