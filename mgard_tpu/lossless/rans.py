"""Device rANS codec (range asymmetric numeral system).

A re-design of the reference's rANS backends
(reference: include/mgard-x/Lossless/rANS/Rans*.hpp and
SymbolRans/SymbolRans.hpp:384): 32-bit-state, 16-bit-renormalization rANS
with a quantized frequency table (2^SCALE_BITS total). Chunks of
`block_size` symbols are coded with independent interleaved states —
encode is a lax.scan over in-chunk positions (reverse order) vectorized
across all chunks, emissions are compacted scatter-free; decode mirrors it
forward. Fractional-bit coding: always <= Huffman size for the same model.
"""

from __future__ import annotations

import struct
import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SCALE_BITS = 14
M = 1 << SCALE_BITS
RANS_L = 1 << 16  # state lower bound


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Quantize a histogram to sum exactly 2^SCALE_BITS, every present
    symbol >= 1 (reference rANS uses the same normalization)."""
    counts = np.asarray(counts, np.int64)
    total = counts.sum()
    if total == 0:
        raise ValueError("empty histogram")
    present = counts > 0
    n_present = int(present.sum())
    if n_present > M:
        raise ValueError(f"{n_present} symbols > table size {M}")
    f = np.zeros_like(counts)
    f[present] = np.maximum(1, (counts[present].astype(np.float64) * M / total).astype(np.int64))
    # fix the sum by walking the largest entries
    diff = int(f.sum() - M)
    if diff != 0:
        order = np.argsort(-f)
        i = 0
        while diff != 0:
            s = order[i % n_present]
            if diff > 0 and f[s] > 1:
                f[s] -= 1
                diff -= 1
            elif diff < 0:
                f[s] += 1
                diff += 1
            i += 1
    assert f.sum() == M
    return f.astype(np.int64)


def slot_to_symbol(freqs: np.ndarray) -> np.ndarray:
    """(M,) int32 table mapping a state slot to its symbol."""
    ends = np.cumsum(freqs)
    table = np.zeros(M, np.int32)
    start = 0
    for s in np.nonzero(freqs)[0]:
        table[start : ends[s]] = s
        start = ends[s]
    return table


@partial(jax.jit, static_argnums=(3,))
def encode_kernel(symbols, freq_t, cum_t, K: int):
    """symbols: (C*K,) int32. Returns (emissions (K, C) uint32[u16 values],
    emit_mask (K, C) bool, final states (C,) uint32)."""
    N = symbols.shape[0]
    C = N // K
    sym = symbols.reshape(C, K)

    def step(x, k):
        # reverse order: symbol at position K-1-k
        s = sym[:, K - 1 - k]
        f = freq_t[s].astype(jnp.uint32)
        cf = cum_t[s].astype(jnp.uint32)
        # renorm when x >= f << (16 + 16 - SCALE_BITS); compare shifted to
        # avoid uint32 overflow at f == 2^SCALE_BITS
        emit = (x >> jnp.uint32(32 - SCALE_BITS)) >= f
        val = (x & jnp.uint32(0xFFFF)).astype(jnp.uint32)
        x = jnp.where(emit, x >> jnp.uint32(16), x)
        x = ((x // f) << jnp.uint32(SCALE_BITS)) + (x % f) + cf
        return x, (val, emit)

    x0 = jnp.full((C,), RANS_L, jnp.uint32)
    xf, (vals, masks) = jax.lax.scan(step, x0, jnp.arange(K))
    return vals, masks, xf


@partial(jax.jit, static_argnums=(3, 4))
def decode_kernel(stream, starts, states, K: int, C: int, slot_t=None, freq_t=None, cum_t=None):
    """stream: (total,) uint32 (u16 values); starts: (C,) int32 per-chunk
    read offsets; states: (C,) uint32. Returns (C*K,) int32 symbols."""

    def step(carry, _):
        x, pos = carry
        slot = (x & jnp.uint32(M - 1)).astype(jnp.int32)
        s = slot_t[slot]
        f = freq_t[s].astype(jnp.uint32)
        cf = cum_t[s].astype(jnp.uint32)
        x = f * (x >> jnp.uint32(SCALE_BITS)) + slot.astype(jnp.uint32) - cf
        need = x < jnp.uint32(RANS_L)
        nw = stream.shape[0]
        nxt = stream[jnp.clip(pos, 0, nw - 1)].astype(jnp.uint32)
        x = jnp.where(need, (x << jnp.uint32(16)) | nxt, x)
        pos = pos + need.astype(jnp.int32)
        return (x, pos), s

    (xf, posf), syms = jax.lax.scan(step, (states, starts), None, length=K)
    return syms.T.reshape(C * K)


_MAGIC = b"RAN1"


@partial(jax.jit, static_argnums=(1,))
def _bincount_jit(s, length):
    # module-level (not a per-call closure) so the compiled program is reused
    return jnp.bincount(s, length=length)


def encode(symbols, dict_size: int, block_size: int = 1024) -> bytes:
    n = int(symbols.shape[0])
    if n == 0:
        return struct.pack("<4sQII", _MAGIC, 0, dict_size, block_size)
    K = block_size
    C = (n + K - 1) // K
    npad = C * K - n
    hist = np.array(_bincount_jit(symbols.ravel(), dict_size))
    pad_sym = int(np.argmax(hist))
    if npad:
        hist[pad_sym] += npad
    freqs = quantize_freqs(hist)
    cums = np.concatenate([[0], np.cumsum(freqs)[:-1]])

    symp = symbols.astype(jnp.int32).ravel()
    if npad:
        symp = jnp.concatenate([symp, jnp.full((npad,), pad_sym, jnp.int32)])
    vals, masks, states = encode_kernel(
        symp, jnp.asarray(freqs.astype(np.int32)), jnp.asarray(cums.astype(np.int32)), K
    )
    # host-side compaction of emissions (u16 stream per chunk, reversed so the
    # decoder reads forward)
    vals_h = np.asarray(vals)  # (K, C)
    masks_h = np.asarray(masks)
    chunks = []
    counts = np.zeros(C, np.int32)
    for c in range(C):
        e = vals_h[masks_h[:, c], c][::-1].astype(np.uint16)
        counts[c] = e.size
        chunks.append(e.tobytes())
    stream = b"".join(chunks)
    states_h = np.asarray(states).astype("<u4")
    freq_z = zlib.compress(freqs.astype("<u2").tobytes(), 6)
    counts_z = zlib.compress(counts.astype("<u4").tobytes(), 1)
    head = struct.pack(
        "<4sQIIIIQ", _MAGIC, n, dict_size, K, len(freq_z), len(counts_z), len(stream)
    )
    return head + freq_z + counts_z + states_h.tobytes() + stream


def decode(data: bytes):
    # empty blobs carry only the short header encode() writes for n == 0
    magic_s, n_s, _d, _b = struct.unpack_from("<4sQII", data, 0)
    if magic_s != _MAGIC:
        raise ValueError("bad rANS blob")
    if n_s == 0:
        return np.zeros(0, np.int32)
    magic, n, dict_size, K, freq_z_len, counts_z_len, stream_len = struct.unpack_from(
        "<4sQIIIIQ", data, 0
    )
    p = struct.calcsize("<4sQIIIIQ")
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    freqs = np.frombuffer(zlib.decompress(data[p : p + freq_z_len]), "<u2").astype(np.int64)
    p += freq_z_len
    C = (n + K - 1) // K
    counts = np.frombuffer(zlib.decompress(data[p : p + counts_z_len]), "<u4").astype(np.int32)
    p += counts_z_len
    states = np.frombuffer(data, "<u4", count=C, offset=p).copy()
    p += 4 * C
    stream = np.frombuffer(data, "<u2", count=stream_len // 2, offset=p).astype(np.uint32)

    cums = np.concatenate([[0], np.cumsum(freqs)[:-1]])
    slot_t = slot_to_symbol(freqs)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    syms = decode_kernel(
        jnp.asarray(np.concatenate([stream, np.zeros(1, np.uint32)])),
        jnp.asarray(starts),
        jnp.asarray(states),
        K,
        C,
        slot_t=jnp.asarray(slot_t),
        freq_t=jnp.asarray(freqs.astype(np.int32)),
        cum_t=jnp.asarray(cums.astype(np.int32)),
    )
    return syms[:n]
