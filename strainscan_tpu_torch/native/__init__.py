"""Compile-on-demand ctypes bindings for the native FASTX parser.

The shared library is built from ``fastx.c`` with the system ``g++`` the
first time it is needed and cached next to the source keyed by a source
hash.  Every entry point degrades gracefully: if no compiler or zlib is
available, callers fall back to the pure-Python reader in
:mod:`strainscan_tpu_torch.io.fastx`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastx.c")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_so() -> Optional[str]:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    build_dir = os.path.join(_DIR, "_build")
    so_path = os.path.join(build_dir, f"fastx-{tag}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(build_dir, exist_ok=True)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-x", "c", _SRC,
           "-o", tmp, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
        return so_path
    except Exception:
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-x", "c", _SRC, "-o", tmp,
                 "-lz"],
                check=True, capture_output=True)
            os.replace(tmp, so_path)
            return so_path
        except Exception:
            return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, or None when native support is unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        so = _build_so()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.fastx_open.restype = ctypes.c_void_p
        lib.fastx_open.argtypes = [ctypes.c_char_p]
        lib.fastx_close.argtypes = [ctypes.c_void_p]
        lib.fastx_next_batch.restype = ctypes.c_int
        lib.fastx_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.fastx_kmers.restype = ctypes.c_longlong
        lib.fastx_kmers.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64))]
        lib.fastx_free_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64)]
        lib.table_build.restype = ctypes.c_int
        lib.table_build.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.pack_batch.restype = ctypes.c_int
        lib.pack_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p]
        lib.table_build_fp.restype = ctypes.c_int
        lib.table_build_fp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_uint32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.u64_lookup_sorted.restype = ctypes.c_int
        lib.u64_lookup_sorted.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p]
        lib.u64_kway_merge_unique.restype = ctypes.c_longlong
        lib.u64_kway_merge_unique.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.i32_sorted_intersect, lib.i32_sorted_diff,
                   lib.u64_sorted_intersect, lib.u64_sorted_diff):
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_void_p]
        lib.enet_cd_path.restype = ctypes.c_int
        lib.enet_cd_path.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_double, ctypes.c_longlong,
            ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        _LIB = lib
        return _LIB
