"""Packaging for horovod_tpu.

Reference parity: the reference's setup.py (396 LoC) is a feature-probing
build that compiles test programs to detect MPI flags, C++ ABI, CUDA and
NCCL (setup.py:170-363) — none of which exist on TPU. What remains to build
is the native control-plane core (`hvd_core.cc`), compiled here as a plain
shared library (no Python ABI dependency — it is loaded via ctypes, the same
channel the reference uses, mpi_ops.py:68-77). If no compiler is available
the package still works: every native path has a pure-Python fallback with
identical semantics.

    pip install .            # builds _hvd_core.so alongside hvd_core.cc
    python setup.py build    # same, in-place tree
"""

from __future__ import annotations

import os
import subprocess

from setuptools import Command, find_packages, setup
from setuptools.command.build_py import build_py


def _compile_core(src: str, out: str) -> bool:
    cmd = ["g++", "-std=c++17", "-O2", "-fPIC", "-shared", "-o", out, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        return res.returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


class BuildWithNativeCore(build_py):
    def run(self):
        super().run()
        for base in ([self.build_lib] if not self.editable_mode else ["."]):
            src = os.path.join(base, "horovod_tpu", "core", "native",
                               "hvd_core.cc")
            if os.path.exists(src):
                out = os.path.join(os.path.dirname(src), "_hvd_core.so")
                if _compile_core(src, out):
                    print(f"built native control-plane core: {out}")
                else:
                    print("WARNING: native core build failed; the "
                          "pure-Python control plane will be used.")


setup(
    name="horovod_tpu",
    version="0.1.0",
    description=("TPU-native Horovod-style data-parallel training: XLA "
                 "collectives over ICI, custom groups as replica_groups, "
                 "DistributedOptimizer, sequence parallelism."),
    packages=find_packages(include=["horovod_tpu", "horovod_tpu.*",
                                    "horovod_tpu_torch*"]),
    package_data={"horovod_tpu.core.native": ["hvd_core.cc"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    cmdclass={"build_py": BuildWithNativeCore},
)
