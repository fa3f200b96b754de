"""LZ4 block-format codec bindings (native C++ host stage).

Replaces round-2's zlib stand-in: a config named LZ4 now runs real LZ4
(the public block format), implemented in mgard_tpu/native/lz4.cpp. The
reference's *device* LZ4 kernels (reference: include/mgard-x/Lossless/
LZ4/LZ4Kernels.hpp, LZ4Fused.hpp) byte-chase through the stream with
data-dependent trip counts — work a whole-array vector program cannot
express profitably — so LZ4 runs host-side here, the same placement the
reference gives Zstd.
"""

from __future__ import annotations

import ctypes

import numpy as np

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from ..native import load

        lib = load("lz4")
        lib.mgard_lz4_bound.restype = ctypes.c_int64
        lib.mgard_lz4_bound.argtypes = [ctypes.c_int64]
        lib.mgard_lz4_compress.restype = ctypes.c_int64
        lib.mgard_lz4_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.mgard_lz4_decompress.restype = ctypes.c_int64
        lib.mgard_lz4_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ]
        _LIB = lib
    return _LIB


def compress(data: bytes) -> bytes:
    lib = _lib()
    n = len(data)
    cap = lib.mgard_lz4_bound(n)
    out = ctypes.create_string_buffer(cap)
    written = lib.mgard_lz4_compress(data, n, out, cap)
    if written < 0:
        raise RuntimeError("lz4 compress failed")
    return out.raw[:written]


def decompress(data: bytes, out_size: int) -> bytes:
    lib = _lib()
    out = ctypes.create_string_buffer(out_size)
    written = lib.mgard_lz4_decompress(data, len(data), out, out_size)
    if written != out_size:
        raise RuntimeError(
            f"lz4 decompress produced {written} bytes, expected {out_size}"
        )
    return out.raw


def available() -> bool:
    try:
        _lib()
        return True
    except Exception:
        return False


def _self_test() -> None:
    rng = np.random.default_rng(0)
    for n in (0, 1, 13, 100, 65536):
        a = rng.integers(0, 8, n, dtype=np.uint8).tobytes()
        assert decompress(compress(a), n) == a
