"""Host-side lossless codecs: Zstd / zlib / LZ4-class byte compression.

Parity with the reference's host stages: CPU_Lossless
(reference: include/mgard-x/Lossless/CPU.hpp:92-168 — host zstd of the
quantized stream) and the Zstd second stage
(reference: include/mgard-x/Lossless/Zstd.hpp:30-120 — host
ZSTD_compress/decompress with device staging). Here the staging is the
device->host transfer of the already-entropy-coded bytes.
"""

from __future__ import annotations

import zlib

try:
    import zstandard as _zstd

    _HAVE_ZSTD = True
except ImportError:  # pragma: no cover
    _zstd = None
    _HAVE_ZSTD = False


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    if _HAVE_ZSTD:
        # Opt-in libzstd worker threads (standard single frame, any
        # decoder reads it) via MGARD_TPU_ZSTD_THREADS. Default stays 0
        # (single-threaded): multithreaded frames are not byte-identical
        # across worker counts, and golden tests pin writer bytes.
        import os

        try:
            threads = int(os.environ.get("MGARD_TPU_ZSTD_THREADS", "0"))
        except ValueError:
            threads = 0
        return _zstd.ZstdCompressor(level=level,
                                    threads=max(threads, 0)).compress(data)
    return zlib.compress(data, min(level + 3, 9))


def zstd_decompress(blob: bytes, expected_size: int | None = None) -> bytes:
    if _HAVE_ZSTD:
        dctx = _zstd.ZstdDecompressor()
        try:
            return dctx.decompress(blob, max_output_size=expected_size or 0)
        except _zstd.ZstdError:
            if not blob.startswith(b"\x28\xb5\x2f\xfd"):
                # produced by the zlib fallback of another host
                return zlib.decompress(blob)
            raise
    return zlib.decompress(blob)


def zlib_compress(data: bytes, level: int = 6) -> bytes:
    return zlib.compress(data, level)


def zlib_decompress(blob: bytes) -> bytes:
    return zlib.decompress(blob)
