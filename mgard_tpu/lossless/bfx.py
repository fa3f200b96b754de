"""BFX — block fixed-width bitplane codec.

A re-design of the reference's BlockDelta/cuSZp-style fixed-length backend
(reference: include/mgard-x/Lossless/BlockDelta/*.hpp, modes Fixed/Delta/
Outlier) built from dense operations only — it contains **no
data-dependent gathers or scatters**:

  * symbols are zigzag-mapped and grouped into blocks of 32;
  * each block stores its 32 values bit-transposed (32x32 butterfly network,
    5 dense masked-shift steps) as `width` 32-bit plane words, where
    width = bit-length of the block's max value;
  * within a superblock the variable-length block streams are condensed by
    a log-depth merge tree. Streams are paired (i, i+S/2); placing the
    right stream after the left is a bit-decomposed sequence of *static*
    circular rolls with a per-stream select — wrapped elements are the
    stream's own zero padding, so the shift needs no masking. The resulting
    word order interleaves blocks in bit-reversed index order (documented
    format property; encode and decode share the schedule).
  * across superblocks the condensed streams are placed at their
    exclusive-scan offsets, each rounded up to the stream's recorded
    alignment (1 for every stream this build writes; older streams may
    record 1024), with the gap words zero.

Arbitrary int32 magnitudes are representable (width <= 32), so the MGARD
outlier side-channel (reference: OutlierSeparatorKernel, Huffman.hpp:571)
is unnecessary for this backend.

Blob format "BFX2":
  header: <4sQQII magic, n, total_words, sb_blocks, align_words>
  widths: NB bytes (one per 32-symbol block, natural block order)
  words:  total_words * u32 little-endian (per superblock: merge-schedule
          order = blocks by bit-reversed in-superblock index; each
          superblock starts at an align_words-aligned offset, gap words
          are 0)
"""

from __future__ import annotations

import struct
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

BS = 32  # symbols per block
# Superblock sizes in blocks (format parameters recorded in each blob):
# streams of at least SB_BLOCKS * 32 symbols use SB_BLOCKS, smaller ones
# SB_BLOCKS_SMALL (less padding).
SB_BLOCKS = 4096
SB_BLOCKS_SMALL = 256

_MAGIC = b"BFX2"
_HDR = "<4sQQII"

_BF_MASKS = (
    np.uint32(0x0000FFFF),
    np.uint32(0x00FF00FF),
    np.uint32(0x0F0F0F0F),
    np.uint32(0x33333333),
    np.uint32(0x55555555),
)
_BF_SHIFTS = (16, 8, 4, 2, 1)


def _zigzag(d):
    return ((d.astype(jnp.int32) << 1) ^ (d.astype(jnp.int32) >> 31)).astype(jnp.uint32)


def _unzigzag(z):
    # the halving shift must be LOGICAL: an arithmetic int32 shift corrupts
    # codes >= 2^31 (symbols with |value| >= 2^30), found by the BFP
    # extreme-magnitude round-trip test
    u = z.astype(jnp.uint32)
    return ((u >> 1) ^ (jnp.uint32(0) - (u & jnp.uint32(1)))).astype(jnp.int32)


def _bit_transpose32(zt):
    """In-register 32x32 bit-matrix transpose of zt (32, M) uint32.

    Row k holds symbol k of every block; on return row j holds plane j
    (bit k of output row j == bit j of input row k). Standard 5-step
    butterfly; self-inverse; all dense sublane slicing."""
    for s, m in zip(_BF_SHIFTS, _BF_MASKS):
        g = 32 // (2 * s)
        x = zt.reshape((g, 2, s) + zt.shape[1:])
        a = x[:, 0]
        b = x[:, 1]
        t = ((a >> s) ^ b) & jnp.uint32(m)
        a = a ^ (t << s)
        b = b ^ t
        zt = jnp.stack([a, b], axis=1).reshape(zt.shape)
    return zt


def _widths_from_zt(zt):
    """Per-block bit widths: (M,) int32 from zt (32, M) symbol rows."""
    mx = jnp.max(zt, axis=0)
    w = jnp.zeros(mx.shape, jnp.int32)
    for j in range(32):
        w = w + (mx >= jnp.uint32(1) << jnp.uint32(j)).astype(jnp.int32)
    return w


# ----------------------------------------------------------------------
# Merge / split trees.
# Streams-as-rows: x (S, cap) uint32, lens (S, 1) int32. Pairing (i, i+S/2).
# ----------------------------------------------------------------------
def _merge_level(x, lens):
    """One merge level: (S, cap) -> (S/2, 2*cap)."""
    S, cap = x.shape
    half = S // 2
    left = x[:half]
    right = x[half:]
    llen = lens[:half]
    rlen = lens[half:]
    cap2 = 2 * cap
    left = jnp.concatenate([left, jnp.zeros_like(left)], axis=1)
    right = jnp.concatenate([right, jnp.zeros_like(right)], axis=1)
    nbits = cap2.bit_length() - 1
    for b in range(nbits):
        sh = 1 << b
        rolled = jnp.roll(right, sh, axis=1)
        right = jnp.where((llen & sh) > 0, rolled, right)
    return left | right, llen + rlen


def _split_level(x, llen, rlen):
    """Inverse of _merge_level: (S, cap) -> (2S, cap/2)."""
    S, cap = x.shape
    caph = cap // 2
    nbits = cap.bit_length() - 1
    right = x
    for b in range(nbits):
        sh = 1 << b
        rolled = jnp.roll(right, -sh, axis=1)
        right = jnp.where((llen & sh) > 0, rolled, right)
    col = jax.lax.broadcasted_iota(jnp.int32, (1, caph), 1)
    zero = jnp.zeros((), x.dtype)
    left = jnp.where(col < llen, x[:, :caph], zero)
    right = jnp.where(col < rlen, right[:, :caph], zero)
    return jnp.concatenate([left, right], axis=0)


def _lens_chain(w_rows):
    """Per-level stream lengths for the split tree, bottom-up.

    w_rows: (S, 1) int32 block widths. Returns [ (S,1), (S/2,1), ..., (1,1) ]
    with halves pairing."""
    chain = [w_rows]
    while chain[-1].shape[0] > 1:
        cur = chain[-1]
        half = cur.shape[0] // 2
        chain.append(cur[:half] + cur[half:])
    return chain


def _pack_superblock(zt_cols, w_cols):
    """Full per-superblock pack: zt (32, S) symbol rows + (1, S) widths ->
    (condensed (1, S*32) stream, total words (1,1))."""
    S = zt_cols.shape[1]
    planes = _bit_transpose32(zt_cols)  # (32, S) plane rows
    # to streams-as-rows: stream b = column b of planes -> row b
    x = planes.T  # (S, 32)
    lens = w_cols.reshape(S, 1)
    while x.shape[0] > 1:
        x, lens = _merge_level(x, lens)
    return x, lens


def _unpack_superblock(stream, w_cols):
    """Inverse of _pack_superblock: (1, S*32) stream + (1, S) widths ->
    zt (32, S)."""
    S = w_cols.shape[1]
    chain = _lens_chain(w_cols.reshape(S, 1))
    x = stream
    for level in range(len(chain) - 2, -1, -1):
        lens = chain[level]
        llen = lens[: x.shape[0]]
        rlen = lens[x.shape[0] :]
        x = _split_level(x, llen, rlen)
    planes = x.T  # (32, S)
    return _bit_transpose32(planes)


# ----------------------------------------------------------------------
# Superblock pack / unpack, vmapped over superblocks
# ----------------------------------------------------------------------
def _encode_xla(zt, w, sb_offs, sb_blocks: int, out_rows: int):
    NB = zt.shape[1]
    NSB = NB // sb_blocks
    cap = sb_blocks * 32

    def pack_one(zt_sb, w_sb):
        stream, _ = _pack_superblock(zt_sb, w_sb.reshape(1, -1))
        return stream.reshape(cap)

    zts = zt.reshape(32, NSB, sb_blocks).transpose(1, 0, 2)
    streams = jax.vmap(pack_one)(zts, w.reshape(NSB, sb_blocks))
    out = jnp.zeros((out_rows * 128,), jnp.uint32)

    def body(out, xs):
        row, off = xs
        return jax.lax.dynamic_update_slice(out, row, (off,)), None

    out, _ = jax.lax.scan(body, out, (streams, sb_offs))
    return out.reshape(out_rows, 128)


def _decode_xla(flat2d, w, sb_offs, sb_blocks: int):
    NB = w.shape[0]
    NSB = NB // sb_blocks
    cap = sb_blocks * 32
    flat = flat2d.reshape(-1)

    def unpack_one(off, w_sb):
        stream = jax.lax.dynamic_slice(flat, (off,), (cap,)).reshape(1, cap)
        return _unpack_superblock(stream, w_sb.reshape(1, -1))

    zts = jax.vmap(unpack_one)(sb_offs, w.reshape(NSB, sb_blocks))
    return zts.transpose(1, 0, 2).reshape(32, NB)


# ----------------------------------------------------------------------
# Device cores
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnums=(1,))
def encode_core(sym_padded, sb_blocks: int):
    """sym_padded: (N,) int32, N a multiple of sb_blocks*32. Superblocks
    are packed back to back (alignment 1).

    Returns (words2d (rows,128) uint32, widths (NB,) int32, total_words
    scalar int32). Rows beyond the total are deterministic zeros except the
    final slack region."""
    N = sym_padded.shape[0]
    NB = N // BS
    NSB = NB // sb_blocks
    cap = sb_blocks * 32
    zz = _zigzag(sym_padded)
    zt = zz.reshape(NB, BS).T  # (32, NB)
    w = _widths_from_zt(zt)  # (NB,)
    sb_lens = jnp.sum(w.reshape(NSB, sb_blocks), axis=1, dtype=jnp.int32)
    sb_offs = (jnp.cumsum(sb_lens) - sb_lens).astype(jnp.int32)
    total = (sb_offs[-1] + sb_lens[-1]).astype(jnp.int32)
    out_rows = (NSB + 1) * cap // 128  # + one superblock of slack
    flat2d = _encode_xla(zt, w, sb_offs, sb_blocks, out_rows)
    return flat2d, w, total


@partial(jax.jit, static_argnums=(2, 3))
def decode_core(flat2d, widths, sb_blocks: int, align: int = 1):
    """Inverse of encode_core (flat2d needs >= cap words of slack beyond the
    real total; encode_core's buffer satisfies this)."""
    NB = widths.shape[0]
    NSB = NB // sb_blocks
    sb_lens = jnp.sum(widths.reshape(NSB, sb_blocks), axis=1, dtype=jnp.int32)
    sb_alens = (sb_lens + (align - 1)) // align * align
    sb_offs = (jnp.cumsum(sb_alens) - sb_alens).astype(jnp.int32)
    zt = _decode_xla(flat2d, widths, sb_offs, sb_blocks)
    zz = zt.T.reshape(NB * BS)
    return _unzigzag(zz)


# ----------------------------------------------------------------------
# Bytes-level API (registry backend)
# ----------------------------------------------------------------------
def _choose_sb(n: int, override=None) -> int:
    if override and n >= override * BS:
        return int(override)
    return SB_BLOCKS if n >= SB_BLOCKS * BS else SB_BLOCKS_SMALL


def _pad_to(n: int, sb_blocks: int) -> int:
    q = sb_blocks * BS
    return (n + q - 1) // q * q


def encode_device(symbols, sb_blocks=None):
    """Device phase of encode(): dispatches the jitted pack with NO host
    synchronization; returns an opaque state for serialize_device()."""
    n = int(symbols.shape[0])
    if n == 0:
        return ("empty", n)
    sb_blocks = _choose_sb(n, sb_blocks)
    npad = _pad_to(n, sb_blocks)
    sym = jnp.asarray(symbols).astype(jnp.int32).ravel()
    if npad != n:
        sym = jnp.concatenate([sym, jnp.zeros(npad - n, jnp.int32)])
    flat2d, w, total = encode_core(sym, sb_blocks)
    return ("bfx", n, sb_blocks, 1, flat2d, w, total)


def serialize_device(state) -> bytes:
    """Host phase of encode(): sync + serialize a dispatched state."""
    if state[0] == "empty":
        return struct.pack(_HDR, _MAGIC, 0, 0, SB_BLOCKS_SMALL, 0)
    _, n, sb_blocks, align, flat2d, w, total = state
    total_i = int(total)
    from .huffman import device_get_prefix

    words_h = device_get_prefix(flat2d.reshape(-1), total_i).astype("<u4")
    widths_h = np.asarray(w).astype(np.uint8)
    head = struct.pack(_HDR, _MAGIC, n, total_i, sb_blocks, align)
    return head + widths_h.tobytes() + words_h.tobytes()


def encode(symbols, config=None) -> bytes:
    sb = getattr(config, "bfx_sb_blocks", None) if config is not None else None
    return serialize_device(encode_device(symbols, sb))


def decode(data: bytes, offset: int = 0):
    magic, n, total, sb_blocks, align = struct.unpack_from(_HDR, data, offset)
    p = offset + struct.calcsize(_HDR)
    if magic != _MAGIC:
        raise ValueError("bad BFX blob")
    if n == 0:
        return jnp.zeros((0,), jnp.int32), p - offset
    npad = _pad_to(n, sb_blocks)
    nb = npad // BS
    widths = np.frombuffer(data, np.uint8, nb, p).astype(np.int32)
    p += nb
    words = np.frombuffer(data, "<u4", total, p)
    p += 4 * total
    cap = sb_blocks * 32
    rows = (total + cap + 127) // 128 + 1  # slack for the padded expand
    wbuf = np.zeros(rows * 128, np.uint32)
    wbuf[:total] = words
    sym = decode_core(
        jnp.asarray(wbuf.reshape(rows, 128)), jnp.asarray(widths),
        sb_blocks, align,
    )
    return sym[:n], p - offset


# ----------------------------------------------------------------------
# NumPy reference (format oracle for tests)
# ----------------------------------------------------------------------
def _bitrev_order(s: int):
    bits = s.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(s)]


def np_encode(symbols: np.ndarray, sb_blocks: int = SB_BLOCKS_SMALL, align: int = 1):
    """Slow host reference returning (widths u8, words u32) for validation.

    Within each superblock, block streams appear in bit-reversed index
    order (the merge schedule's interleaving)."""
    n = symbols.shape[0]
    npad = _pad_to(n, sb_blocks)
    s = np.zeros(npad, np.int64)
    s[:n] = symbols.astype(np.int64)
    zz = ((s << 1) ^ (s >> 63)).astype(np.uint64).astype(np.uint32)
    Z = zz.reshape(-1, BS)
    widths = np.array([int(m).bit_length() for m in Z.max(axis=1)], np.int32)
    order = _bitrev_order(sb_blocks)
    out = []
    for sb in range(Z.shape[0] // sb_blocks):
        sb_words = []
        for local in order:
            b = sb * sb_blocks + local
            for j in range(widths[b]):
                word = np.uint32(0)
                for k in range(BS):
                    word |= np.uint32((int(Z[b, k]) >> j) & 1) << np.uint32(k)
                sb_words.append(word)
        pad = (-len(sb_words)) % align
        sb_words.extend([np.uint32(0)] * pad)
        out.extend(sb_words)
    return widths.astype(np.uint8), np.array(out, np.uint32)
