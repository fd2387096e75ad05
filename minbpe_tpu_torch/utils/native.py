"""ctypes binding for the native pre-split scanner (csrc/presplit.cpp).

The port's own copy of the scanner is compiled with g++ at first use into
the package's build directory, keyed by the source's content (portable
flags, no -march=native). When no C++ compiler is there, ``available()`` is
False and callers use the pure-Python scanner (utils/presplit.py), as
minbpe_tpu does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "presplit.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_lib = None
_tried = False
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(open(SOURCE, "rb").read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libpresplit-{h.hexdigest()[:12]}.so")


def build_command(out: str) -> list[str] | None:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    return None if cxx is None else [cxx, *CXX_FLAGS, "-o", out, SOURCE]


def build() -> str | None:
    """Compile the scanner unless built; the library path, or None when
    there is no C++ compiler. Raises if the compiler fails."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = build_command(tmp)
    if cmd is None:
        return None
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        path = build()
        _tried = True
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.presplit_init.restype = None
        lib.presplit_init.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
        ]
        lib.presplit_run.restype = ctypes.c_int64
        lib.presplit_run.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
        ]
        from . import presplit

        starts, flags, _ = presplit._load()
        starts = np.ascontiguousarray(starts, dtype=np.int32)
        flags = np.ascontiguousarray(flags, dtype=np.uint8)
        lib.presplit_init(
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(starts),
        )
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def split_offsets(data: bytes, mode: int) -> np.ndarray | None:
    """Chunk-end byte offsets (int64) for UTF-8 bytes. mode: 4 = GPT-4,
    2 = GPT-2. None when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if not data:
        return np.zeros(0, dtype=np.int64)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(data), dtype=np.int64)
    k = lib.presplit_run(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(out), mode,
    )
    if k < 0:
        raise RuntimeError(f"native presplit failed with code {k}")
    return out[:k].copy()

