"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source to an object, all at once in parallel
(``-gencode arch=compute_90a,code=sm_90a``), and links them into one shared
library with a plain C interface, named by a hash of the sources, headers
and flags, under ``csrc/_build/``; ``ctypes`` loads it.  A missing ``nvcc``
or a failed build raises: there is no fallback.
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
SOURCES = ("probe_count.cu", "count_fp_bins.cu", "count_exact.cu",
           "row_gather.cu")
HEADERS = ("kmer_window.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

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


def _run(cmds):
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}\n{err}")


def build() -> str:
    """Path of the compiled library, building it if it is not there yet."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"kernels-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    objs = [os.path.join(BUILD_DIR, f"{name}-{tag}.{os.getpid()}.o")
            for name in SOURCES]
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC, name)]
          for name, obj in zip(SOURCES, objs)])
    tmp = f"{so_path}.tmp{os.getpid()}"
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    for obj in objs:
        os.remove(obj)
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
            so.fp_coarse_count_launch.restype = i
            so.fp_coarse_count_launch.argtypes = [i, p, p, p, p, ll, i, i, i,
                                                  i, i, u, u, i, i, i, i, p,
                                                  p, p, ll, p]
            so.fp_coarse_scatter_launch.restype = i
            so.fp_coarse_scatter_launch.argtypes = [i, p, p, p, p, ll, i, i,
                                                    i, i, i, u, u, i, i, i, i,
                                                    i, p, p, p, p, p]
            so.fp_fine_split_launch.restype = i
            so.fp_fine_split_launch.argtypes = [i, p, p, i, i, i, p, p, p, p]
            so.fp_bin_probe_launch.restype = i
            so.fp_bin_probe_launch.argtypes = [i, p, p, i, p, i, i, i, i, p,
                                               ll, p]
            so.count_exact_launch.restype = i
            so.count_exact_launch.argtypes = [i, p, p, p, p, ll, i, i, i, i,
                                              i, p, u, i, ll, p, p, ll, p, p]
            so.count_exact_list_shape.restype = None
            so.count_exact_list_shape.argtypes = [i, p, p, p, p, ll, i, i, i,
                                                  i, i, p]
            so.exact_apply_launch.restype = i
            so.exact_apply_launch.argtypes = [i, p, p, ll, i, p, ll, ll, p]
            so.row_gather_launch.restype = i
            so.row_gather_launch.argtypes = [i, p, ll, i, p, ll, i, i, p, p]
            so.cuda_error_string.restype = ctypes.c_char_p
            so.cuda_error_string.argtypes = [i]
            _LIB = so
        return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = lib().cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
