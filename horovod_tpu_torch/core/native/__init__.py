"""ctypes bindings for the native control plane (``hvd_core.cc``).

Counterpart of ``horovod_tpu/core/native/__init__.py``, over a copy of its
C++ source: the request table and its validation, the fusion planner,
stall detection and the timeline writer, one ctypes binding for all of
them. The library is compiled with ``g++`` at first use (never at import)
into ``horovod_tpu_torch/_build/``, under a file name that carries a hash
of the source and the flags, as ``ops/_build.py`` names the CUDA
libraries: an edited source is rebuilt and a stale library is never
loaded. Processes that start at once (a spawned world, test workers) take
turns on a lock file, and the build writes a temporary file and renames it
into place, so none loads a half-written library. Without a toolchain, or
when the build fails, the loader warns with the reference's text and the
callers carry on with the Python paths (``core/negotiate.py``,
``ops/fusion.py``, ``core/timeline.py``), which have the same semantics
and byte-identical error texts.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "hvd_core.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "_build")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
ABI_VERSION = 1

_build_lock = threading.Lock()
_lib = None
_load_failed = False


def library_path() -> str:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libhvd_core-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    """Compile ``hvd_core.cc`` into ``out`` unless it is there already."""
    import warnings

    if os.path.exists(out):
        return True
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        # One build at a time: the other processes wait here, then find
        # the library in place.
        with open(os.path.join(BUILD_DIR, "hvd_core.lock"), "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(out):
                return True
            cmd = ["g++", *CXX_FLAGS, "-o", tmp, _SRC]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
            if res.returncode != 0:
                warnings.warn(
                    f"hvd_core native build failed, using pure-Python "
                    f"control plane: {res.stderr[-500:]}")
                return False
            os.replace(tmp, out)  # atomic: a reader never sees half a file
            return True
    except (OSError, subprocess.SubprocessError) as e:
        warnings.warn(f"hvd_core native build unavailable ({e}); using "
                      f"pure-Python control plane.")
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _load_failed
    with _build_lock:
        if _lib is not None or _load_failed:
            return _lib
        out = library_path()
        if not _build(out):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError as e:
            import warnings

            warnings.warn(f"hvd_core load failed ({e}); using pure-Python "
                          f"control plane.")
            _load_failed = True
            return None
        lib.hvd_core_create.restype = ctypes.c_void_p
        lib.hvd_core_create.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_double]
        lib.hvd_core_destroy.argtypes = [ctypes.c_void_p]
        lib.hvd_core_submit.restype = ctypes.c_int
        lib.hvd_core_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.hvd_core_response_sizes.restype = ctypes.c_int
        lib.hvd_core_response_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.hvd_core_response_root.restype = ctypes.c_int
        lib.hvd_core_response_root.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.hvd_core_response_done.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.hvd_core_stalled.restype = ctypes.c_int
        lib.hvd_core_stalled.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.hvd_core_plan_fusion.restype = ctypes.c_int
        lib.hvd_core_plan_fusion.argtypes = [
            ctypes.c_longlong, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.hvd_core_timeline_start.restype = ctypes.c_int
        lib.hvd_core_timeline_start.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p]
        lib.hvd_core_timeline_stop.argtypes = [ctypes.c_void_p]
        lib.hvd_core_timeline_event.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char]
        lib.hvd_core_abi_version.restype = ctypes.c_int
        if lib.hvd_core_abi_version() != ABI_VERSION:
            import warnings

            warnings.warn(f"hvd_core load failed (ABI version "
                          f"{lib.hvd_core_abi_version()}, expected "
                          f"{ABI_VERSION}); using pure-Python control "
                          f"plane.")
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (builds it at the
    first call)."""
    return _load() is not None


class NativeCore:
    """One native control-plane instance (per ``hvd.init``, rebuilt at an
    elastic reconfigure)."""

    ERR_LEN = 2048

    def __init__(self, group_sizes: list[int], stall_seconds: float = 60.0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native core unavailable")
        self._lib = lib
        arr = (ctypes.c_int * len(group_sizes))(*group_sizes)
        self._handle = lib.hvd_core_create(
            len(group_sizes), arr, ctypes.c_double(stall_seconds))
        if not self._handle:
            raise RuntimeError("hvd_core_create failed")
        self._group_sizes = list(group_sizes)

    @property
    def group_sizes(self) -> list[int]:
        return list(self._group_sizes)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.hvd_core_destroy(self._handle)
            self._handle = None

    def __del__(self):  # best effort; an explicit close is preferred
        try:
            self.close()
        except Exception:
            pass

    def submit(self, group: int, name: str, op: int, dtype: str,
               shape: tuple[int, ...], root_rank: int, rank: int
               ) -> tuple[int, str]:
        """Returns (status, error): status 0 pending, 1 ready, -1 error."""
        dims = (ctypes.c_longlong * max(1, len(shape)))(*(shape or (0,)))
        err = ctypes.create_string_buffer(self.ERR_LEN)
        status = self._lib.hvd_core_submit(
            self._handle, group, name.encode(), op, dtype.encode(),
            len(shape), dims, root_rank, rank, err, self.ERR_LEN)
        return status, err.value.decode()

    def response_sizes(self, group: int, name: str) -> list[int] | None:
        n = self._group_sizes[group]
        out = (ctypes.c_longlong * n)()
        got = self._lib.hvd_core_response_sizes(
            self._handle, group, name.encode(), out, n)
        if got < 0:
            return None
        return [int(out[i]) for i in range(got)]

    def response_root(self, group: int, name: str) -> int:
        return self._lib.hvd_core_response_root(
            self._handle, group, name.encode())

    def response_done(self, group: int, name: str) -> None:
        self._lib.hvd_core_response_done(self._handle, group, name.encode())

    def stalled(self, group: int) -> list[str]:
        buf = ctypes.create_string_buffer(1 << 16)
        n = self._lib.hvd_core_stalled(self._handle, group, buf, 1 << 16)
        if n <= 0:
            return []
        return buf.value.decode().split("\n")

    def plan_fusion(self, threshold: int, nbytes: list[int],
                    dtype_codes: list[int]) -> list[int]:
        n = len(nbytes)
        if n == 0:
            return []
        nb = (ctypes.c_longlong * n)(*nbytes)
        dc = (ctypes.c_int * n)(*dtype_codes)
        out = (ctypes.c_int * n)()
        got = self._lib.hvd_core_plan_fusion(threshold, n, nb, dc, out)
        if got < 0:
            raise RuntimeError("hvd_core_plan_fusion failed")
        return [int(out[i]) for i in range(n)]

    def timeline_start(self, path: str) -> bool:
        return self._lib.hvd_core_timeline_start(
            self._handle, path.encode()) == 0

    def timeline_stop(self) -> None:
        self._lib.hvd_core_timeline_stop(self._handle)

    def timeline_event(self, tensor: str, activity: str, phase: str) -> None:
        self._lib.hvd_core_timeline_event(
            self._handle, tensor.encode(), activity.encode(),
            phase.encode()[0:1] or b"i")
