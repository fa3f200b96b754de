"""Lossless backends for the quantized integer stream.

Composed like the reference ComposedLosslessCompressor
(reference: include/mgard-x/Lossless/Lossless.hpp:24-260), selected by
lossless_type. Device backends (Huffman, BlockDelta, ZeroRLE+rANS) encode on
the device; CPU_Lossless and the second-stage LZ4/Zstd run on host over the already
entropy-coded bytes.
"""

from .registry import lossless_compress, lossless_decompress  # noqa: F401
