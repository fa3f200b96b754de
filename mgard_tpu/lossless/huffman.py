"""Device Huffman codec (a re-design of the reference's parallel
Huffman stage, include/mgard-x/Lossless/ParallelHuffman/Huffman.hpp:33-640).

Architecture differences from the CUDA lineage (cuSZ):
  * Histogram on device; canonical, length-limited (package-merge) codebook on
    host — the survey notes a host codebook from a device histogram is the
    idiomatic substitute for the reference's cooperative grid-sync tree build
    (GetCodebook.hpp:50-140).
  * Encode: fully vectorized, scatter-free bit packing. Symbols are chunked
    (huff_block_size per chunk, reference Deflate's chunking); within a chunk
    each symbol's code contributes to at most two 32-bit words (code length
    <= 16 < 32). Because word indices are a 0/1-increment staircase over
    symbols, per-word sums of contributions are computed as modular cumsum
    differences at group boundaries located with a vectorized bisection —
    gathers only, no scatter (scatters serialize on some devices; gathers
    vectorize).
  * Chunk streams are condensed into one contiguous word stream with a
    marker-cumsum-gather compaction (single C-element scatter + one gather).
  * Decode: one-gather-per-symbol direct LUT (2^max_len entries) canonical
    decode, lax.scan over in-chunk positions, vectorized across all chunks
    (the reference decodes chunks in parallel, symbols serially — same shape).
"""

from __future__ import annotations

import struct
import zlib
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.compact import staircase_last_le

MAX_CODE_LEN = 16


# ----------------------------------------------------------------------
# Host: canonical, length-limited codebook
# ----------------------------------------------------------------------
def package_merge_lengths(freq: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Optimal length-limited Huffman code lengths (package-merge).

    Plays the role of the reference's GenerateCL cooperative kernel
    (GetCodebook.hpp) but with an optimal-length-limit guarantee.
    Returns uint8 lengths, 0 for absent symbols.
    """
    freq = np.asarray(freq, dtype=np.int64)
    lens = np.zeros(freq.shape[0], dtype=np.uint8)
    syms = np.nonzero(freq)[0]
    n = len(syms)
    if n == 0:
        return lens
    if n == 1:
        lens[syms[0]] = 1
        return lens
    if n > (1 << max_len):
        raise ValueError(f"{n} symbols cannot fit in {max_len}-bit codes")
    order = np.argsort(freq[syms], kind="stable")
    w = freq[syms][order].tolist()
    # Each package is (weight, list of leaf indices it contains).
    leaves = [(wi, (i,)) for i, wi in enumerate(w)]
    merged = list(leaves)
    for _ in range(max_len - 1):
        paired = [
            (merged[j][0] + merged[j + 1][0], merged[j][1] + merged[j + 1][1])
            for j in range(0, len(merged) - 1, 2)
        ]
        merged = sorted(leaves + paired, key=lambda t: t[0])
    counts = np.zeros(n, dtype=np.int64)
    for _, items in merged[: 2 * n - 2]:
        for i in items:
            counts[i] += 1
    lens[syms[order]] = counts.astype(np.uint8)
    # Kraft sanity
    assert abs(np.sum(2.0 ** -counts.astype(np.float64)) - 1.0) < 1e-9
    return lens


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical codes (uint32) from code lengths: symbols sorted by
    (length, symbol id) get sequential codes."""
    lens = np.asarray(lens)
    codes = np.zeros(lens.shape[0], dtype=np.uint32)
    code = 0
    prev_len = 0
    for l in range(1, MAX_CODE_LEN + 1):
        for sym in np.nonzero(lens == l)[0]:
            code <<= l - prev_len
            prev_len = l
            codes[sym] = code
            code += 1
    return codes


def decode_lut(lens: np.ndarray, codes: np.ndarray, max_len: int = MAX_CODE_LEN) -> np.ndarray:
    """Direct-lookup decode table: peek max_len bits -> (symbol << 5) | len."""
    lut = np.zeros(1 << max_len, dtype=np.uint32)
    for sym in np.nonzero(lens)[0]:
        l = int(lens[sym])
        lo = int(codes[sym]) << (max_len - l)
        hi = lo + (1 << (max_len - l))
        lut[lo:hi] = (np.uint32(sym) << 5) | np.uint32(l)
    return lut


# ----------------------------------------------------------------------
# Device: histogram / encode / decode
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnums=(1,))
def histogram(symbols, dict_size: int):
    return jnp.bincount(symbols.ravel(), length=dict_size)


@partial(jax.jit, static_argnums=(3,))
def encode_kernel(symbols_padded, len_table, code_table, K: int):
    """Pack (C*K,) symbols into per-chunk bitstreams and condense.

    Returns (words (C*K,) uint32 [only the first total_words valid],
             chunk_bits (C,) int32, total_words int32)."""
    N = symbols_padded.shape[0]
    C = N // K
    sym = symbols_padded.reshape(C, K)
    lens = len_table[sym].astype(jnp.int32)  # (C, K)
    codes = code_table[sym].astype(jnp.uint32)

    offs = jnp.cumsum(lens, axis=1, dtype=jnp.int32) - lens  # exclusive
    chunk_bits = offs[:, -1] + lens[:, -1]
    w0 = (offs >> 5).astype(jnp.int32)
    bitpos = (offs & 31).astype(jnp.int32)

    sh0 = 32 - bitpos - lens  # in [-31, 31] for len in [1, 32]
    pos = sh0 >= 0
    # keep all shift arithmetic in uint32: mixed-type shifts promote to int64
    # under x64 (memory blowup + wrong high bits)
    sh_l = jnp.where(pos, sh0, 0).astype(jnp.uint32)
    sh_r = jnp.where(pos, 0, -sh0).astype(jnp.uint32)
    sh_c1 = jnp.where(pos, 0, 32 + sh0).astype(jnp.uint32)
    c0 = jnp.where(pos, codes << sh_l, codes >> sh_r).astype(jnp.uint32)
    c1 = jnp.where(pos, jnp.uint32(0), codes << sh_c1).astype(jnp.uint32)

    S0 = jnp.cumsum(c0.astype(jnp.uint32), axis=1)  # modular
    S1 = jnp.cumsum(c1.astype(jnp.uint32), axis=1)

    # word w value = sum(c0 of symbols with w0==w) + sum(c1 with w0==w-1)
    e = staircase_last_le(w0, K, K)  # (C, K): last symbol with w0 <= w
    S0e = jnp.take_along_axis(S0, e, axis=1)
    S1e = jnp.take_along_axis(S1, e, axis=1)
    S0p = jnp.concatenate([jnp.zeros((C, 1), jnp.uint32), S0e[:, :-1]], axis=1)
    S1p = jnp.concatenate([jnp.zeros((C, 1), jnp.uint32), S1e[:, :-1]], axis=1)
    S1pp = jnp.concatenate([jnp.zeros((C, 1), jnp.uint32), S1p[:, :-1]], axis=1)
    words_padded = (S0e - S0p) + (S1p - S1pp)  # (C, K)

    # condense chunks -> contiguous stream
    wcount = (chunk_bits + 31) >> 5  # (C,)
    starts = jnp.cumsum(wcount) - wcount  # (C,)
    total = starts[-1] + wcount[-1]
    marker = jnp.zeros(N, jnp.int32).at[starts[1:]].add(1, mode="drop")
    chunk_id = jnp.cumsum(marker)  # (N,)
    local = jnp.arange(N, dtype=jnp.int32) - starts[chunk_id]
    flat_idx = jnp.clip(chunk_id * K + local, 0, N - 1)
    words = words_padded.ravel()[flat_idx]
    return words, chunk_bits.astype(jnp.int32), total.astype(jnp.int32)


@partial(jax.jit, static_argnums=(2, 3))
def decode_kernel(words, chunk_starts, K: int, C: int, lut=None):
    """Decode C chunks of K symbols each from the condensed word stream.

    chunk_starts: (C,) int32 word index of each chunk's first word.
    Returns (C*K,) int32 symbols."""
    maxlen_bits = MAX_CODE_LEN

    def step(bitpos, _):
        widx = chunk_starts + (bitpos >> 5)
        nw = words.shape[0]
        wa = words[jnp.clip(widx, 0, nw - 1)].astype(jnp.uint32)
        wb = words[jnp.clip(widx + 1, 0, nw - 1)].astype(jnp.uint32)
        # all-window arithmetic strictly in uint32 (mixed-type shifts would
        # promote to int64 under x64 and leak high bits into the peek)
        b = (bitpos & 31).astype(jnp.uint32)
        window = jnp.where(
            b > 0,
            (wa << b) | (wb >> (jnp.uint32(32) - jnp.maximum(b, jnp.uint32(1)))),
            wa,
        ).astype(jnp.uint32)
        peek = (window >> jnp.uint32(32 - maxlen_bits)).astype(jnp.int32)
        entry = lut[peek]
        length = (entry & 31).astype(jnp.int32)
        symbol = (entry >> 5).astype(jnp.int32)
        return bitpos + length, symbol

    bitpos0 = jnp.zeros((C,), jnp.int32)
    _, syms = jax.lax.scan(step, bitpos0, None, length=K)
    return syms.T.reshape(C * K)  # (K, C) -> (C, K) -> flat


# ----------------------------------------------------------------------
# Blob (de)serialization
# ----------------------------------------------------------------------
class HuffmanBlob(NamedTuple):
    n_symbols: int
    dict_size: int
    block_size: int
    lens: np.ndarray  # (dict_size,) uint8
    chunk_bits: np.ndarray  # (C,) int32
    words: np.ndarray  # (total_words,) uint32


_MAGIC = b"HUF1"


def serialize_blob(b: HuffmanBlob) -> bytes:
    lens_z = zlib.compress(b.lens.tobytes(), 6)
    cb = b.chunk_bits.astype("<u4")
    cb_z = zlib.compress(cb.tobytes(), 1)
    head = struct.pack(
        "<4sQIIIIQ",
        _MAGIC,
        b.n_symbols,
        b.dict_size,
        b.block_size,
        len(lens_z),
        len(cb_z),
        b.words.shape[0],
    )
    return head + lens_z + cb_z + b.words.astype("<u4").tobytes()


def deserialize_blob(data: bytes, offset: int = 0) -> tuple[HuffmanBlob, int]:
    magic, n_symbols, dict_size, block_size, lens_z_len, cb_z_len, n_words = (
        struct.unpack_from("<4sQIIIIQ", data, offset)
    )
    if magic != _MAGIC:
        raise ValueError("bad Huffman blob")
    p = offset + struct.calcsize("<4sQIIIIQ")
    lens = np.frombuffer(zlib.decompress(data[p : p + lens_z_len]), dtype=np.uint8)
    p += lens_z_len
    chunk_bits = np.frombuffer(zlib.decompress(data[p : p + cb_z_len]), dtype="<u4").astype(
        np.int32
    )
    p += cb_z_len
    words = np.frombuffer(data, dtype="<u4", count=n_words, offset=p).copy()
    p += 4 * n_words
    return (
        HuffmanBlob(n_symbols, dict_size, block_size, lens, chunk_bits, words),
        p,
    )


# ----------------------------------------------------------------------
# Top level
# ----------------------------------------------------------------------
def _bucket(n: int) -> int:
    """Round up to a coarse bucket to bound the number of slice recompiles."""
    if n <= 4096:
        return 4096
    b = 1 << (int(n - 1).bit_length() - 2)
    return ((n + b - 1) // b) * b


@partial(jax.jit, static_argnums=(1,))
def _slice_prefix(arr, n: int):
    return jax.lax.slice_in_dim(arr, 0, n, axis=0)


def device_get_prefix(arr, n: int) -> np.ndarray:
    """Transfer only ~n leading elements of a device array to host."""
    nb = min(_bucket(n), arr.shape[0])
    return np.asarray(_slice_prefix(arr, nb))[:n]


def encode(symbols, dict_size: int, block_size: int = 1024) -> bytes:
    """Huffman-encode a device int32 symbol array (values in [0, dict_size))."""
    n = int(symbols.shape[0])
    if n == 0:
        return serialize_blob(
            HuffmanBlob(0, dict_size, block_size, np.zeros(dict_size, np.uint8),
                        np.zeros(0, np.int32), np.zeros(0, np.uint32))
        )
    hist = np.array(histogram(symbols, dict_size))
    pad_sym = int(np.argmax(hist))
    K = block_size
    C = (n + K - 1) // K
    npad = C * K - n
    if npad:
        hist[pad_sym] += npad
    lens_np = package_merge_lengths(hist)
    codes_np = canonical_codes(lens_np)

    sym_padded = jnp.concatenate(
        [symbols.astype(jnp.int32).ravel(),
         jnp.full((npad,), pad_sym, jnp.int32)]
    ) if npad else symbols.astype(jnp.int32).ravel()
    words, chunk_bits, total = encode_kernel(
        sym_padded, jnp.asarray(lens_np.astype(np.int32)),
        jnp.asarray(codes_np), K
    )
    total = int(total)
    words_h = device_get_prefix(words, total).astype(np.uint32)
    chunk_bits_h = np.asarray(chunk_bits)
    return serialize_blob(
        HuffmanBlob(n, dict_size, K, lens_np, chunk_bits_h, words_h)
    )


def decode(data: bytes, offset: int = 0):
    """Decode a Huffman blob; returns (device int32 symbols, bytes consumed)."""
    blob, end = deserialize_blob(data, offset)
    n, K = blob.n_symbols, blob.block_size
    if n == 0:
        return jnp.zeros((0,), jnp.int32), end - offset
    C = (n + K - 1) // K
    codes = canonical_codes(blob.lens)
    lut = decode_lut(blob.lens, codes)
    wcount = (blob.chunk_bits.astype(np.int64) + 31) >> 5
    starts = (np.cumsum(wcount) - wcount).astype(np.int32)
    # pad words so the +1 peek never reads past the end
    words = jnp.asarray(np.concatenate([blob.words, np.zeros(2, np.uint32)]))
    syms = decode_kernel(words, jnp.asarray(starts), K, C, lut=jnp.asarray(lut))
    return syms[:n], end - offset
