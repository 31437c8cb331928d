"""Loader for the native host-packing extension (``csrc/host_pack.cpp``).

The port's own copy of ``chatts_tpu/utils/native.py``, with the entry point
the processor uses.  Builds the shared library on first use with g++ into
``chatts_tpu_torch/_build/`` (git-ignored) and binds it via ctypes.  This is
host code, not a device kernel: where g++ is missing or the build fails,
``build_scatter_map`` returns None and the processor takes its numpy path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "csrc", "host_pack.cpp")
_OUT_DIR = os.path.join(_PKG_DIR, "_build")
_SO_PATH = os.path.join(_OUT_DIR, "libhostpack.so")


def _host_tag() -> str:
    """Fingerprint of this host's CPU feature set.  The library builds with
    -march=native, so a cached .so from a different machine can SIGILL —
    rebuild whenever the fingerprint recorded at build time changes."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        import platform

        flags = platform.processor()
    return hashlib.sha1(flags.encode()).hexdigest()[:12]


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        return None
    os.makedirs(_OUT_DIR, exist_ok=True)
    stamp = _SO_PATH + ".host"
    tag = _host_tag()
    if (os.path.exists(_SO_PATH)
            and os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SRC)):
        try:
            with open(stamp) as f:
                if f.read().strip() == tag:
                    return _SO_PATH
        except OSError:
            pass  # no stamp: rebuild (pre-stamp cache or foreign binary)
    # Write to a private name, then rename: a concurrent loader never sees a
    # half-written library.
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO_PATH)
        with open(stamp, "w") as f:
            f.write(tag)
        return _SO_PATH
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.build_scatter_map.restype = ctypes.c_int
        lib.build_scatter_map.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return _LIB


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def build_scatter_map(
    patch_cnt: np.ndarray,
    seq_of: np.ndarray,
    starts: np.ndarray,
    n_pad: int,
    p_max: int,
    seq_sentinel: int,
    tok_sentinel: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The (series, patch) -> (sequence, token) scatter map, or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(patch_cnt)
    patch_cnt = np.ascontiguousarray(patch_cnt, np.int32)
    seq_of = np.ascontiguousarray(seq_of, np.int32)
    starts = np.ascontiguousarray(starts, np.int32)
    scatter_seq = np.empty((n_pad, p_max), np.int32)
    scatter_tok = np.empty((n_pad, p_max), np.int32)
    rc = lib.build_scatter_map(
        _ptr(patch_cnt, ctypes.c_int32), _ptr(seq_of, ctypes.c_int32),
        _ptr(starts, ctypes.c_int32),
        n, n_pad, p_max, seq_sentinel, tok_sentinel,
        _ptr(scatter_seq, ctypes.c_int32), _ptr(scatter_tok, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return scatter_seq, scatter_tok
