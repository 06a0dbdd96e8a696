"""The host-side native helper: the PLY decoders and the Morton sort in C++.

Port of ``gsm_renderer_tpu/native``: ``gsm_native.cpp`` is a copy of the JAX
package's source, built with the same g++ flags, so that both packages
decode a file to the same bits.  The library is built on first use into
``_build/native-<hash of the source and flags>/`` of this package (listed in
.gitignore), never next to the source, and loaded with ``ctypes``; it never
loads the JAX package's library.  A host without g++ takes the NumPy paths
of ``io/ply.py`` and ``io/scene.py``, as the JAX package does;
:func:`native_available` says which one a host gets, and
``io.ply.last_decoder()`` which decoder the last ``load_ply`` used.  Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SOURCE = _HERE / "gsm_native.cpp"
_BUILD_ROOT = _HERE.parent / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
#: seconds g++ may take
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return _BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libgsm_native.so"


def _build(path: Path) -> bool:
    """Compile the source into ``path`` (through a temporary file, so that
    processes building at once never load a partial library)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"libgsm_native.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True,
                       timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, path)
    return True


def get_lib():
    """The loaded library (built first if needed), or None where it cannot
    be built or loaded.  Tried once a process."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None

        i64, i32 = ctypes.c_int64, ctypes.c_int32
        fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")

        lib.ply_decode_standard.restype = i64
        lib.ply_decode_standard.argtypes = (
            [u8p, i64, i64] + [i32] * 16 + [i32] * 3 + [fp] * 5)
        lib.ply_decode_compressed.restype = None
        lib.ply_decode_compressed.argtypes = [fp, i64, u32p, i64] + [fp] * 5
        lib.morton_sort_indices.restype = None
        lib.morton_sort_indices.argtypes = [fp, i64, i64p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads on this host (building it on
    the first call)."""
    return get_lib() is not None


def morton_sort_indices(positions: np.ndarray) -> np.ndarray | None:
    """Native Morton argsort of (N, 3) positions; None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, np.float32)
    order = np.empty(pos.shape[0], np.int64)
    lib.morton_sort_indices(pos, pos.shape[0], order)
    return order
