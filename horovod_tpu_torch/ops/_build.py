"""Build and load the port's CUDA sources (``horovod_tpu_torch/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library under ``horovod_tpu_torch/_build/``, at
first use, then loaded with ``ctypes``. The library's file name carries a
hash of the source, of every header under ``csrc/`` (``*.cuh``) and of
the flags, so an edited source or header is rebuilt and a stale library is
never loaded (a header edit rebuilds every source, the ones that do not
include it too). Nothing here runs at import: the CPU tests import every
module, and this host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# Every source the port builds, by name (``csrc/<name>.cu``): A1 the AdamW
# update, B2 BatchNorm's gradient sums, B1 its forward sums, A2 the fused
# cross-entropy head's logit tiles, B4 and B3 the flash-attention backward
# and forward.
SOURCES = ("adamw", "batchnorm", "bn_sums", "ce_head", "flash_bwd",
           "flash_fwd")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on "
        "PATH. The port's kernels are built from source at first use.")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for rel in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, rel), "rb") as f:
            digest.update(rel.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _compile_cmd(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source (default: all of :data:`SOURCES`) that has
    no up-to-date library, all ``nvcc`` processes started together. Returns
    ``{name: library path}``; raises with the compiler's output if any
    build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    paths = {}
    for name in names:
        out = library_path(name)
        paths[name] = out
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])  # atomic: concurrent ranks may race
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _libs[name] = lib
        return lib
