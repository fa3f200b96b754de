"""Monotone canonical Huffman — the device entropy coder.

A re-design of the Huffman stage around the cost of data-dependent
gathers/scatters, which run far below memory bandwidth on some devices,
while elementwise, cumsum and associative-scan ops run at it:

  * The alphabet is zigzag-ranked: quantized MGARD coefficients are unimodal
    around the dictionary origin, so frequency rank ~= zigzag distance
    `zz = zigzag(q - dict/2)`. Code lengths over ranks are nondecreasing, so
    both the code length and the code word are *arithmetic* in zz — a chain
    of <= 16 vector compares replaces every per-symbol table gather
    (the reference gathers from device codebooks, Huffman.hpp EncodeFixedLen).
  * Codebook: package-merge over a strided sampled histogram (+1 smoothing
    guarantees every symbol a code), 16-entry length tables in the blob —
    no 8K codebook to serialize or rebuild.
  * Packing: per-word sums of the (at most two) word contributions of each
    code are computed with one segmented associative scan; the word stream is
    emitted with a single unique-index scatter directly into its condensed
    global position (chunk word bases via cumsum).
  * Decode: canonical length detection by compare-chain against 16 left-
    aligned thresholds; the symbol is reconstructed arithmetically — the only
    memory-indirect op left is the per-step word fetch.

Blob format "HUF2"; selected via Config (default for lossless_type.Huffman).
"""

from __future__ import annotations

import struct
import zlib
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.compact import masked_indices  # noqa: F401  (re-export convenience)
from .huffman import device_get_prefix, package_merge_lengths

MAX_LEN = 16


# ----------------------------------------------------------------------
# Host: rank codebook
# ----------------------------------------------------------------------
class RankCodebook(NamedTuple):
    # per length L in 1..MAX_LEN (index L-1):
    first_rank: np.ndarray  # (17,) int32: first rank with len >= L (cumulative)
    base_code: np.ndarray  # (16,) uint32: canonical code of first rank of len L
    thresholds16: np.ndarray  # (16,) uint32: left-aligned decode boundaries
    len_of_rank_bp: np.ndarray  # (16,) int32 breakpoints: len(zz) = sum(zz >= bp)


def build_rank_codebook(freqs_desc: np.ndarray) -> RankCodebook:
    """freqs_desc: per-rank frequencies, nonincreasing, all > 0."""
    lens = package_merge_lengths(freqs_desc, MAX_LEN).astype(np.int32)
    # ties in package-merge can permute equal-frequency ranks; sorting the
    # length multiset ascending against the descending frequencies is the
    # optimal assignment (rearrangement inequality) and restores monotonicity
    lens = np.sort(lens)
    A = len(freqs_desc)
    assert np.all(np.diff(lens) >= 0)
    # counts per length
    cnt = np.bincount(lens, minlength=MAX_LEN + 1)  # cnt[L]
    first_rank = np.zeros(MAX_LEN + 1, np.int32)
    for L in range(1, MAX_LEN + 1):
        first_rank[L] = first_rank[L - 1] + cnt[L - 1] if L > 1 else 0
    # canonical codes: code of first rank of each length
    base_code = np.zeros(MAX_LEN, np.uint32)
    code = 0
    prev_len = 0
    for L in range(1, MAX_LEN + 1):
        if cnt[L] == 0:
            continue
        code <<= L - prev_len
        base_code[L - 1] = code
        code += cnt[L]
        prev_len = L
    # decode thresholds: left-aligned 16-bit boundary marking the end of the
    # codes of length <= L: thr[L-1] = (code after last len<=L code) << (16-L)
    thresholds = np.zeros(MAX_LEN, np.uint64)
    code = 0
    prev_len = 0
    for L in range(1, MAX_LEN + 1):
        if cnt[L]:
            code <<= L - prev_len
            code += cnt[L]
            prev_len = L
        thresholds[L - 1] = (
            np.uint64(code) << np.uint64(MAX_LEN - prev_len) if prev_len else 0
        )
    # length breakpoints over zz: len(zz) = sum_L (zz >= first_rank[L]) over
    # lengths that exist; represent as 16 rank thresholds (A for absent)
    bp = np.full(MAX_LEN, A, np.int32)
    # len(zz) = number of L in 1..16 with zz >= first_rank_of_len_(L+1)?  Use:
    # len = minimal L with zz < first_rank[L] + cnt[L] cumulative...
    # simpler: len(zz) = 1 + sum over L=1..15 of (zz >= end_rank[L]) where
    # end_rank[L] = first_rank[L] + cnt[L] = ranks with len <= L
    end_rank = np.zeros(MAX_LEN, np.int32)
    acc = 0
    for L in range(1, MAX_LEN + 1):
        acc += cnt[L]
        end_rank[L - 1] = acc
    bp = end_rank  # len(zz) = 1 + sum_{L=1..15} (zz >= end_rank[L-1]) .. see kernel
    return RankCodebook(
        first_rank=first_rank,
        base_code=base_code,
        thresholds16=thresholds.astype(np.uint32),
        len_of_rank_bp=bp,
    )


def rank_codebook_from_hist(hist_zz: np.ndarray) -> tuple[RankCodebook, np.ndarray]:
    """Build the codebook assuming freq is monotone nonincreasing in zz.

    Sorting descending guarantees valid (complete, length-limited) codes even
    when the true distribution is not perfectly monotone — then the code is
    merely slightly suboptimal, never wrong."""
    freqs_desc = np.sort(hist_zz)[::-1].astype(np.int64)
    assert freqs_desc[-1] > 0, "histogram must be smoothed (+1) first"
    return build_rank_codebook(freqs_desc), freqs_desc


# ----------------------------------------------------------------------
# Device kernels
# ----------------------------------------------------------------------
def _zigzag(d):
    return ((d << 1) ^ (d >> 31)).astype(jnp.int32)


@partial(jax.jit, static_argnums=(1, 2))
def _zz_hist_jit(s, stride, dict_size):
    """Strided zigzag histogram (module-level jit: a per-call closure would
    retrace on every encode)."""
    return jnp.bincount(
        _zigzag(s[::stride].astype(jnp.int32) - dict_size // 2),
        length=dict_size,
    )


def _unzigzag(z):
    return (z >> 1) ^ -(z & 1)


def _len_of_zz(zz, end_rank):
    """len(zz) = 1 + #(L in 1..15 : zz >= end_rank[L-1]) — compare chain."""
    ln = jnp.ones_like(zz)
    for L in range(MAX_LEN - 1):
        ln = ln + (zz >= int(end_rank[L])).astype(jnp.int32)
    return ln


def _code_of_zz(zz, ln, first_rank, base_code):
    """code = base_code[len] + (zz - first_rank[len]) via compare-select."""
    adj = jnp.zeros_like(zz)
    for L in range(1, MAX_LEN + 1):
        a = int(base_code[L - 1]) - int(first_rank[L])
        adj = jnp.where(ln == L, a, adj)
    return (zz + adj).astype(jnp.uint32)


@partial(jax.jit, static_argnums=(3, 4))
def encode_kernel(symbols_padded, end_rank, fr_base, K: int, dict_size: int):
    """symbols (C*K,) int32 in [0, dict); fr_base = (first_rank (17,),
    base_code (16,)) packed as one (33,) int64 array for a single constant.

    Returns (words (C*K,) uint32 condensed, chunk_bits (C,) int32,
    total_words int32)."""
    N = symbols_padded.shape[0]
    C = N // K
    first_rank = fr_base[:17]
    base_code = fr_base[17:33]

    d = symbols_padded.astype(jnp.int32) - dict_size // 2
    zz = _zigzag(d).reshape(C, K)
    ln = jnp.ones_like(zz)
    for L in range(MAX_LEN - 1):
        ln = ln + (zz >= end_rank[L].astype(jnp.int32)).astype(jnp.int32)
    adj = jnp.zeros_like(zz)
    for L in range(1, MAX_LEN + 1):
        a = (base_code[L - 1] - first_rank[L]).astype(jnp.int32)
        adj = jnp.where(ln == L, a, adj)
    codes = (zz + adj).astype(jnp.uint32)

    offs = jnp.cumsum(ln, axis=1, dtype=jnp.int32) - ln
    chunk_bits = offs[:, -1] + ln[:, -1]
    w0 = (offs >> 5).astype(jnp.int32)
    bitpos = (offs & 31).astype(jnp.int32)

    sh0 = 32 - bitpos - ln
    pos = sh0 >= 0
    sh_l = jnp.where(pos, sh0, 0).astype(jnp.uint32)
    sh_r = jnp.where(pos, 0, -sh0).astype(jnp.uint32)
    sh_c1 = jnp.where(pos, 0, 32 + sh0).astype(jnp.uint32)
    c0 = jnp.where(pos, codes << sh_l, codes >> sh_r).astype(jnp.uint32)
    c1 = jnp.where(pos, jnp.uint32(0), codes << sh_c1).astype(jnp.uint32)

    # segmented inclusive sums over word groups (segment starts where w0
    # increments); the value at each group's last element is the word sum
    start = jnp.concatenate(
        [jnp.ones((C, 1), jnp.uint32), (w0[:, 1:] > w0[:, :-1]).astype(jnp.uint32)],
        axis=1,
    )

    def comb(a, b):
        fa, va0, va1 = a
        fb, vb0, vb1 = b
        keep = (1 - fb).astype(jnp.uint32)
        return fa | fb, vb0 + va0 * keep, vb1 + va1 * keep

    _, A, B = jax.lax.associative_scan(comb, (start, c0, c1), axis=1)
    is_last = jnp.concatenate(
        [(w0[:, 1:] > w0[:, :-1]), jnp.ones((C, 1), bool)], axis=1
    )

    # chunk word bases -> global word positions; single scatter-add with
    # near-unique indices (word w gets A at w and B at w+1)
    wcount = (chunk_bits + 31) >> 5
    bases = jnp.cumsum(wcount) - wcount  # (C,)
    total = bases[-1] + wcount[-1]
    gw = bases[:, None] + w0  # (C, K) global word index of each symbol
    NW = N  # static upper bound on total words
    out = jnp.zeros(NW + 2, jnp.uint32)
    idxA = jnp.where(is_last, gw, NW + 1)
    idxB = jnp.where(is_last, gw + 1, NW + 1)
    # B of the last word of a chunk must not bleed into the next chunk's
    # first word: it would be past chunk_bits only when the final code ends
    # exactly at a word boundary with no spill -> c1 sum is 0 there, safe.
    out = out.at[idxA.ravel()].add(A.ravel(), mode="drop")
    out = out.at[idxB.ravel()].add(B.ravel(), mode="drop")
    return out[:NW], chunk_bits.astype(jnp.int32), total.astype(jnp.int32)


@partial(jax.jit, static_argnums=(4, 5, 6))
def decode_kernel(words, chunk_starts, thresholds16, fr_base, K: int, C: int, dict_size: int):
    """Gather-free canonical decode (one word fetch per step)."""
    first_rank = fr_base[:17]
    base_code = fr_base[17:33]
    thr = thresholds16.astype(jnp.uint32)

    def step(bitpos, _):
        widx = chunk_starts + (bitpos >> 5)
        nw = words.shape[0]
        wa = words[jnp.clip(widx, 0, nw - 1)].astype(jnp.uint32)
        wb = words[jnp.clip(widx + 1, 0, nw - 1)].astype(jnp.uint32)
        b = (bitpos & 31).astype(jnp.uint32)
        window = jnp.where(
            b > 0,
            (wa << b) | (wb >> (jnp.uint32(32) - jnp.maximum(b, jnp.uint32(1)))),
            wa,
        ).astype(jnp.uint32)
        peek = (window >> jnp.uint32(32 - MAX_LEN)).astype(jnp.uint32)
        ln = jnp.ones(peek.shape, jnp.int32)
        for L in range(MAX_LEN - 1):
            ln = ln + (peek >= thr[L]).astype(jnp.int32)
        # rank = first_rank[len] + (peek >> (16-len)) - base_code[len],
        # with the len-dependent constants resolved by compare-select
        fr_sel = jnp.zeros(peek.shape, jnp.int32)
        bc_sel = jnp.zeros(peek.shape, jnp.uint32)
        for L in range(1, MAX_LEN + 1):
            # first_rank[L] = first rank of length L (same table as encode)
            fr_sel = jnp.where(ln == L, first_rank[L].astype(jnp.int32), fr_sel)
            bc_sel = jnp.where(ln == L, base_code[L - 1].astype(jnp.uint32), bc_sel)
        code = peek >> (jnp.uint32(MAX_LEN) - ln.astype(jnp.uint32))
        zz = (fr_sel + (code - bc_sel).astype(jnp.int32)).astype(jnp.int32)
        d = _unzigzag(zz)
        sym = d + dict_size // 2
        return bitpos + ln, sym

    bp0 = jnp.zeros((C,), jnp.int32)
    _, syms = jax.lax.scan(step, bp0, None, length=K)
    return syms.T.reshape(C * K)


# ----------------------------------------------------------------------
# Blob
# ----------------------------------------------------------------------
_MAGIC = b"HUF2"


def encode(symbols, dict_size: int, block_size: int = 1024, sample_cap: int = 1 << 18) -> bytes:
    n = int(symbols.shape[0])
    if n == 0:
        return struct.pack("<4sQII", _MAGIC, 0, dict_size, block_size)
    K = block_size
    C = (n + K - 1) // K
    npad = C * K - n

    # bincount is gather-bound; a 256K-sample histogram keeps the codebook
    # estimate at a fraction of the full pass
    stride = max(1, n // sample_cap)
    hist = np.array(
        _zz_hist_jit(symbols.ravel(), stride, dict_size)
    ) + 1  # smoothing: every code exists
    cb, freqs_desc = rank_codebook_from_hist(hist)

    fr_base = np.concatenate(
        [cb.first_rank.astype(np.int64), cb.base_code.astype(np.int64)]
    )
    symp = symbols.astype(jnp.int32).ravel()
    if npad:
        symp = jnp.concatenate([symp, jnp.full((npad,), dict_size // 2, jnp.int32)])
    words, chunk_bits, total = encode_kernel(
        symp, jnp.asarray(cb.len_of_rank_bp.astype(np.int64)), jnp.asarray(fr_base), K, dict_size
    )
    total_i = int(total)
    words_h = device_get_prefix(words, total_i).astype("<u4")
    cb_z = zlib.compress(np.asarray(chunk_bits).astype("<u4").tobytes(), 1)
    head = struct.pack(
        "<4sQIIIQ", _MAGIC, n, dict_size, K, len(cb_z), total_i
    )
    tables = (
        cb.first_rank.astype("<i4").tobytes()
        + cb.base_code.astype("<u4").tobytes()
        + cb.thresholds16.astype("<u4").tobytes()
        + cb.len_of_rank_bp.astype("<i4").tobytes()
    )
    return head + tables + cb_z + words_h.tobytes()


def decode(data: bytes, offset: int = 0):
    magic, n, dict_size, K, cb_z_len, total = struct.unpack_from("<4sQIIIQ", data, offset)
    if magic != _MAGIC:
        raise ValueError("bad HUF2 blob")
    p = offset + struct.calcsize("<4sQIIIQ")
    if n == 0:
        return jnp.zeros((0,), jnp.int32), p - offset
    first_rank = np.frombuffer(data, "<i4", 17, p).copy(); p += 68
    base_code = np.frombuffer(data, "<u4", 16, p).copy(); p += 64
    thresholds = np.frombuffer(data, "<u4", 16, p).copy(); p += 64
    end_rank = np.frombuffer(data, "<i4", 16, p).copy(); p += 64
    chunk_bits = np.frombuffer(zlib.decompress(data[p : p + cb_z_len]), "<u4").astype(np.int64)
    p += cb_z_len
    words = np.frombuffer(data, "<u4", count=total, offset=p).copy()
    p += 4 * total

    C = (n + K - 1) // K
    wc = (chunk_bits + 31) >> 5
    starts = (np.cumsum(wc) - wc).astype(np.int32)
    fr_base = np.concatenate([first_rank.astype(np.int64), base_code.astype(np.int64)])
    syms = decode_kernel(
        jnp.asarray(np.concatenate([words, np.zeros(2, np.uint32)])),
        jnp.asarray(starts),
        jnp.asarray(thresholds.astype(np.int64)),
        jnp.asarray(fr_base),
        K,
        C,
        dict_size,
    )
    return syms[:n], p - offset
