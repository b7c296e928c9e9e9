"""Lazy build and load of the port's native (C++) host runtime.

Compiles every ``.cpp`` in this directory into one shared library with g++
at first use, under ``build/minlz_tpu_torch/`` at the root of the checkout
(beside the CUDA kernels' library), and loads it with ctypes.  No binary is
kept next to the sources.

``get_lib()`` returns None when the build or the load fails, and the block
API then runs the Python oracle.  The failure is kept: ``build_error()``
returns it, and the callers that need the native codec (the device encode
with the native serializer) raise with it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "minlz_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libminlz_native.so")
_lock = threading.Lock()
_lib = None
_error = None


def _sources() -> list[str]:
    return sorted(
        os.path.join(_DIR, f) for f in os.listdir(_DIR) if f.endswith(".cpp")
    )


def _needs_build() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > lib_mtime for s in _sources())


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fvisibility=hidden", "-o", tmp, *_sources(),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise OSError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                      f"{res.stdout}{res.stderr}")
    os.replace(tmp, LIB_PATH)


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if _needs_build():
                _build()
            lib = ctypes.CDLL(LIB_PATH)
            lib.minlz_crc32c.restype = ctypes.c_uint32
            lib.minlz_crc32c.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
            ]
            lib.minlz_huff0_decode_stream.restype = ctypes.c_long
            lib.minlz_huff0_decode_stream.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.minlz_huff0_encode_stream.restype = ctypes.c_long
            lib.minlz_huff0_encode_stream.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            _lib = lib
        except (OSError, AttributeError) as exc:
            # No g++, a failed compile, or a library that lacks a symbol.
            _error = exc
    return _lib


def build_error():
    """The exception that kept the native library from loading, or None."""
    get_lib()
    return _error
