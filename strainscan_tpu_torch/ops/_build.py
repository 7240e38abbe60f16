"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles the sources into a shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a``), named by a hash of
the sources and flags, under ``csrc/_build/``; ``ctypes`` loads it.  A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")
SOURCES = ("probe_count.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None


def nvcc_path() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH and $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def build() -> str:
    """Path of the compiled library, building it if it is not there yet."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    so_path = os.path.join(BUILD_DIR, f"probe_count-{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, name) for name in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            ll, u = ctypes.c_longlong, ctypes.c_uint32
            so.probe_prep_launch.restype = i
            so.probe_prep_launch.argtypes = [i, p, ll, i, i, i, u, u, p, p, p]
            so.count_fp_launch.restype = i
            so.count_fp_launch.argtypes = [i, p, p, p, ll, i, i, i, i, i, p,
                                           u, i, u, p, p]
            so.cuda_error_string.restype = ctypes.c_char_p
            so.cuda_error_string.argtypes = [i]
            _LIB = so
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
