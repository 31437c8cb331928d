"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``chatts_tpu_torch/csrc/<name>.cu`` compiles on first use into
``chatts_tpu_torch/_build/lib<name>.so`` (git-ignored) for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>.so csrc/<name>.cu

The sources have a plain C interface, so no PyTorch header is compiled and a
build takes seconds.  A library is rebuilt when its source, or any header
``csrc/*.cuh`` (the kernels may share them), is newer.  The
compiler's output, with ``-Xptxas -v``'s register and spill counts, is kept
beside the library as ``lib<name>.log``.

This is the counterpart of ``chatts_tpu/utils/native.py`` (g++ on first use,
ctypes binding), with one difference: there is no fallback.  A kernel that
does not build raises, and a CUDA tensor never silently takes another path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

KERNELS = ("flash_attention", "ragged_decode_attention", "ragged_decode_attention_int8",
           "int4_matmul", "int4_matmul_a8", "fused_glue", "mla_decode", "moe_int4")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# A C signature: (restype, [argtypes]).  Every pointer and the stream are
# c_void_p; ctypes would otherwise pass them as 32-bit ints.
Signature = Tuple[object, Sequence[object]]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_typed: set = set()  # (library, function) pairs whose signature is set


@dataclasses.dataclass
class BuildInfo:
    name: str
    path: str
    seconds: float  # 0.0 when the library was already up to date
    log: str  # nvcc's output, -Xptxas -v included


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    """Whether the library is missing or older than its source or than any
    shared header."""
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    built = os.path.getmtime(lib)
    sources = [source_path(name), *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]
    return any(built < os.path.getmtime(src) for src in sources)


def _command(name: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, source_path(name)]


def build(names: Iterable[str] = KERNELS) -> List[BuildInfo]:
    """Compile every stale library among ``names``, in parallel.

    Raises RuntimeError with nvcc's output when a compile fails."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if name not in KERNELS:
            raise ValueError(f"unknown kernel {name!r}; known: {KERNELS}")
        if _stale(name):
            # Write to a private name, then rename: a concurrent loader never
            # sees a half-written library.
            tmp = f"{library_path(name)}.{os.getpid()}.tmp"
            procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    infos = []
    failures = []
    for name in names:
        log_path = library_path(name)[:-3] + ".log"
        if name not in procs:
            log = ""
            if os.path.exists(log_path):
                with open(log_path) as f:
                    log = f.read()
            infos.append(BuildInfo(name, library_path(name), 0.0, log))
            continue
        tmp, start, proc = procs[name]
        log, _ = proc.communicate()
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, library_path(name))
        with open(log_path, "w") as f:
            f.write(log)
        infos.append(BuildInfo(name, library_path(name), seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return infos


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as the int a C launcher
    takes for ``cudaStream_t``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_launch(err: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error code other than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_gradients(what: str, *tensors) -> None:
    """Raise when autograd would record a call of kernel ``what``: the
    kernels fill outputs through ``ctypes`` and have no backward, so their
    outputs would carry no gradient and everything before them would
    silently get none. Checked before the device dispatch, so the plain
    version on the CPU refuses too. Training takes the plain attention
    (``attn_impl="xla"``) and float projections instead."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward; call it under "
                           "torch.no_grad() or with inputs that need no gradient")


def load(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if stale, with
    ``restype``/``argtypes`` set from ``signatures``."""
    with _lock:
        lib: Optional[ctypes.CDLL] = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        for fn, (restype, argtypes) in signatures.items():
            # Two wrappers may load one library, each with its own functions.
            if (name, fn) not in _typed:
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
                _typed.add((name, fn))
        return lib
