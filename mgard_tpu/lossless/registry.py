"""Composed lossless stage: backend selection + optional host second stage.

Plays the role of the reference ComposedLosslessCompressor
(reference: include/mgard-x/Lossless/Lossless.hpp:24-260): the quantized
int32 stream is entropy-coded by the selected backend (device Huffman /
BlockDelta / ...), optionally followed by a host byte-compressor stage
(Zstd / LZ4 / zlib) exactly like Huffman_LZ4 / Huffman_Zstd.
"""

from __future__ import annotations

import struct

import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..dtypes import lossless_type
from . import host, huffman

_HDR = "<BQ"  # backend id, inner payload size


def lossless_compress(quantized_flat, config: Config) -> bytes:
    """Compress a flat device int32 symbol array to bytes."""
    lt = config.lossless
    n = int(quantized_flat.shape[0])
    if lt in (lossless_type.BFP, lossless_type.BFP_Zstd):
        # small streams fall back to BFX (see highlevel._effective_raw_lt);
        # the backend id written below keeps the blob self-describing
        from ..highlevel import _effective_raw_lt

        lt = _effective_raw_lt(lt, n)
    if lt in (lossless_type.Huffman, lossless_type.Huffman_Zstd, lossless_type.Huffman_LZ4):
        # Interop-only backend: its device kernels were measured about two
        # orders of magnitude slower than BFP/BFX on the device this
        # framework was first built for, with no ratio gain; not measured
        # on the GPU. Kept selectable for reference-stream parity; warn
        # once so a perf user picking the reference's default class is not
        # silently slow.
        from ..utils.log import log as _log

        if not getattr(lossless_compress, "_huff_warned", False):
            lossless_compress._huff_warned = True
            _log.warn(
                "device Huffman is interop-only (slow); use "
                "lossless=BFP (speed) or BFX/BFP_Zstd (ratio) for production"
            )
        if getattr(config, "huffman_mono", True):
            from . import huffman_mono

            inner = huffman_mono.encode(
                quantized_flat, config.huff_dict_size, config.huff_block_size
            )
        else:
            inner = huffman.encode(
                quantized_flat, config.huff_dict_size, config.huff_block_size
            )
        if lt == lossless_type.Huffman_Zstd:
            inner = host.zstd_compress(inner, config.zstd_compress_level)
        elif lt == lossless_type.Huffman_LZ4:
            from . import lz4

            inner = struct.pack("<Q", len(inner)) + lz4.compress(inner)
    elif lt == lossless_type.CPU_Lossless:
        raw = np.asarray(quantized_flat).astype("<i4").tobytes()
        inner = struct.pack("<Q", n) + host.zstd_compress(raw, config.zstd_compress_level)
    elif lt == lossless_type.ZeroRLE_Rans:
        from . import rle_rans

        inner = rle_rans.encode(quantized_flat, config)
    elif lt == lossless_type.BlockDelta:
        from . import block_delta

        inner = block_delta.encode(quantized_flat, config)
    elif lt == lossless_type.LZ4:
        from . import lz4

        raw = np.asarray(quantized_flat).astype("<i4").tobytes()
        inner = struct.pack("<Q", n) + lz4.compress(raw)
    elif lt == lossless_type.SymbolRans:
        from . import symbol_rans

        inner = symbol_rans.encode(quantized_flat, config)
    elif lt in (lossless_type.BFX, lossless_type.BFX_Zstd):
        from . import bfx

        inner = bfx.encode(quantized_flat, config)
        if lt == lossless_type.BFX_Zstd:
            inner = host.zstd_compress(inner, config.zstd_compress_level)
    elif lt in (lossless_type.BFP, lossless_type.BFP_Zstd):
        from . import bfp

        inner = bfp.encode(quantized_flat, config)
        if lt == lossless_type.BFP_Zstd:
            inner = host.zstd_compress(inner, config.zstd_compress_level)
    else:
        raise ValueError(f"unsupported lossless backend {lt}")
    return struct.pack(_HDR, int(lt), len(inner)) + inner


def lossless_decompress(data: bytes, offset: int = 0):
    """Returns (device int32 flat symbols, bytes consumed)."""
    bt, inner_size = struct.unpack_from(_HDR, data, offset)
    lt = lossless_type(bt)
    p = offset + struct.calcsize(_HDR)
    inner = data[p : p + inner_size]
    if len(inner) != inner_size:
        raise ValueError("truncated lossless payload")
    consumed = struct.calcsize(_HDR) + inner_size

    if lt in (lossless_type.Huffman, lossless_type.Huffman_Zstd, lossless_type.Huffman_LZ4):
        if lt == lossless_type.Huffman_Zstd:
            inner = host.zstd_decompress(bytes(inner))
        elif lt == lossless_type.Huffman_LZ4:
            from . import lz4

            (raw_n,) = struct.unpack_from("<Q", inner, 0)
            inner = lz4.decompress(bytes(inner[8:]), raw_n)
        if bytes(inner[:4]) == b"HUF2":
            from . import huffman_mono

            syms, _ = huffman_mono.decode(bytes(inner))
        else:
            syms, _ = huffman.decode(bytes(inner))
        return syms, consumed
    if lt in (lossless_type.CPU_Lossless, lossless_type.LZ4):
        (n,) = struct.unpack_from("<Q", inner, 0)
        blob = bytes(inner[8:])
        if lt == lossless_type.CPU_Lossless:
            raw = host.zstd_decompress(blob, expected_size=4 * n)
        else:
            from . import lz4

            raw = lz4.decompress(blob, 4 * n)
        syms = np.frombuffer(raw, dtype="<i4", count=n).copy()
        return jnp.asarray(syms), consumed
    if lt == lossless_type.ZeroRLE_Rans:
        from . import rle_rans

        return rle_rans.decode(bytes(inner)), consumed
    if lt == lossless_type.BlockDelta:
        from . import block_delta

        return block_delta.decode(bytes(inner)), consumed
    if lt == lossless_type.SymbolRans:
        from . import symbol_rans

        return symbol_rans.decode(bytes(inner)), consumed
    if lt in (lossless_type.BFX, lossless_type.BFX_Zstd):
        from . import bfx

        if lt == lossless_type.BFX_Zstd:
            inner = host.zstd_decompress(bytes(inner))
        syms, _ = bfx.decode(bytes(inner))
        return syms, consumed
    if lt in (lossless_type.BFP, lossless_type.BFP_Zstd):
        from . import bfp

        if lt == lossless_type.BFP_Zstd:
            inner = host.zstd_decompress(bytes(inner))
        syms, _ = bfp.decode(bytes(inner))
        return syms, consumed
    raise ValueError(f"unsupported lossless backend {lt}")
