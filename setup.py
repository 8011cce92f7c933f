"""Build / install horovod_tpu.

Analogue (in spirit) of the reference's env-flag-driven build
(reference: setup.py:331-560 — HOROVOD_WITH[OUT]_* knobs selecting which
native pieces to build). The TPU build has exactly one native artifact —
the C++ runtime library (TCP transport + host collectives + timeline
writer, horovod_tpu/cpp/) — compiled with the system toolchain; there is
no CUDA/NCCL probe to do.

Env knobs:
  HOROVOD_TPU_WITHOUT_NATIVE=1   skip building the C++ library (it can
                                 still be built lazily at first use; the
                                 framework degrades to pure-Python
                                 transports if no toolchain exists)
  CXX / CXXFLAGS                 forwarded to make
"""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    def run(self):
        if os.environ.get("HOROVOD_TPU_WITHOUT_NATIVE", "") not in ("1", "true"):
            cpp_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "horovod_tpu", "cpp")
            try:
                subprocess.run(["make", "-C", cpp_dir], check=True)
            except (OSError, subprocess.CalledProcessError) as exc:
                print(f"warning: native library build failed ({exc}); "
                      "the framework will retry lazily at first use")
        super().run()


setup(
    name="horovod_tpu",
    version=open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "horovod_tpu", "version.py"))
    .read().split('"')[1],
    description="TPU-native distributed data-parallel training framework",
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch",
                                    "horovod_tpu_torch.*"]),
    package_data={"horovod_tpu": ["cpp/*.cc", "cpp/Makefile"],
                  "horovod_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    extras_require={
        "torch": ["torch"],
        "spark": ["pyspark"],
    },
    entry_points={"console_scripts": [
        "tpurun = horovod_tpu.run.run:main",
    ]},
    cmdclass={"build_py": BuildWithNative},
)
