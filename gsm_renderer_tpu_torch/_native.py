"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

``--fmad=false`` keeps ``a * b + c`` as two rounded operations, as the plain
PyTorch versions (and the JAX reference) compute it, so kernel and plain
version agree bit for bit up to the transcendental functions.

The build runs on first use into ``_build/<content hash>/`` next to this file
(listed in .gitignore) and is reused while the sources are unchanged.  The
libraries are loaded with ``ctypes``; every C entry point returns
``cudaGetLastError()`` after its launches and :class:`Kernel` raises on a
non-zero value.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG / "_build"
SOURCES = ("project", "binning", "blend")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ on first use")
    return found


def build_dir() -> Path:
    """Directory of the libraries for the current sources."""
    h = hashlib.sha256()
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, one nvcc each, all in
    parallel.  Raises RuntimeError with the compiler's output on failure.
    The ``-Xptxas -v`` report (registers, shared memory, spills) is kept in
    ``<name>.log`` beside each library."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    nvcc = None
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, tmp, lib, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, lib, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}.cu (rc {rc}):\n"
                          + (out / f"{name}.log").read_text()[-4000:])
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, building first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            lib.gsm_error_string.argtypes = [ctypes.c_int]
            lib.gsm_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint32
F = ctypes.c_float


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    ``launches`` grows by one per successful call of :meth:`launch` and only
    there, so a run can show that its main path went through the kernel."""

    def __init__(self, name: str, lib: str, symbol: str, argtypes: list):
        self.name, self.lib, self.symbol = name, lib, symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes + [P]
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream().cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            msg = load(self.lib).gsm_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def ptr_or_null(t: torch.Tensor | None) -> int | None:
    """The device pointer of ``t``, or a null pointer for None."""
    return None if t is None else t.data_ptr()


MAX_PTRS = 8


def ptr_array(tensors) -> ctypes.Array:
    """Host array of up to MAX_PTRS device pointers (unused entries 0), for
    a C entry point that copies them into a by-value kernel argument."""
    if len(tensors) > MAX_PTRS:
        raise ValueError(f"at most {MAX_PTRS} pointers, got {len(tensors)}")
    ptrs = [t.data_ptr() for t in tensors] + [0] * (MAX_PTRS - len(tensors))
    return (ctypes.c_void_p * MAX_PTRS)(*ptrs)


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Validate a kernel operand before its pointer is passed to C."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
