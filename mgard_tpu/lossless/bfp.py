"""BFP — width-sorted prefix bitplane codec (the default lossless stage).

Successor to BFX (lossless/bfx.py), whose log-depth variable-length merge
tree spends most of its encode time condensing variable-width block
streams. BFP removes condensation entirely:

  1. Blocks are STABLY SORTED by residual width within each superblock
     (rank from E+1 masked cumsums — a counting sort, no jnp.sort). After
     sorting, the valid words of every residual plane j form a PREFIX of
     the superblock (exactly the blocks with rl > j), so "condensing"
     plane j is a contiguous slice of cnt_j words — zero shuffle work.
  2. Each plane is ORed into a per-superblock buffer at its row offset
     (plane tails are all-zero words of narrower blocks, so overlapping
     windows merge losslessly), and each superblock's buffer is placed at
     a content-based row offset of the output; a later superblock's
     window overwrites an earlier one's zero spill.
  3. The permutation is never stored: decode recomputes the identical
     counting sort from the nibble sidecar and un-sorts with one row
     gather by rank.

Stream layout per block stays BFP2's three-way split: K dense base planes
(stream-level K from the width histogram), E residual planes holding
exactly rl = clip(width-K, 0, E) words per block, and rare exception
blocks (width > K+E, ~0.1% on smooth data) shipped verbatim with ids.
Reference counterpart: the fixed-length+outlier design of BlockDelta/cuSZp
(reference: include/mgard-x/Lossless/BlockDelta/*.hpp); the sorted-prefix
placement is this framework's own.

Blob format "BFP5" (little-endian) — the BANDED layout: the whole device
pipeline stays in the natural (NC, C*32) chunk-row layout. Within a
superblock each residual plane j is C BANDS (one per block slot
b in the chunk), band b holding the plane-j words of the first ccnt_j
sorted chunks' b-th blocks, each band zero-padded to a 128-word row:

  header:  <4sQQBBIBQ  magic, n, resid_rows (128-word rows), K, E,
           sb_blocks, chunk_blocks C, exc_count>
  nibbles: ceil(NC/2) bytes — per-CHUNK residual lengths (chunk = C
           blocks, C in the header, max of the blocks' rl) in NATURAL
           chunk order, low nibble first
  base:    NB*K u32 (per superblock: plane-major, then band-major
           (block slot b), then sbc = sb/C chunks in SORTED order)
  resid:   resid_words u32 — the COMPACTED band payload: per superblock,
           per plane j = K..K+E-1, per band b = 0..C-1, exactly ccnt_j
           valid words (no padding on the wire; the 128-word row padding
           of the device layout is stripped by serialize and re-created
           by deserialize, both driven by the nibble sidecar alone).
           The header's third field holds resid_words.
  exc ids: exc_count u32 (ascending NATURAL chunk indices)
  exc chunks: exc_count * 128 i32 raw symbols (chunk-major)
"""

from __future__ import annotations

import struct
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.compact import masked_indices
from .bfx import BS, _bit_transpose32, _unzigzag, _zigzag

# Superblock sizes in 32-symbol blocks (format parameters recorded in each
# blob, so any value decodes everywhere). Streams of at least
# SB_BLOCKS * 32 symbols use SB_BLOCKS; smaller ones SB_BLOCKS_SMALL.
SB_BLOCKS = 16384
# Smallest large-stream superblock: streams under SB_LARGE_MIN * 32
# symbols go to BFX instead (highlevel._effective_raw_lt), and a tuned
# Config.bfp_sb_blocks below it is not admitted for the hybrid v2 stream.
SB_LARGE_MIN = 8192
SB_BLOCKS_SMALL = 256
E_DEFAULT = 8
LANES = 128
# Blocks per sort chunk (a format parameter carried in the header).
# Bigger chunks -> fewer, wider sort-gather rows at the price of a coarser
# chunk-max width.
CHUNK = 8

_MAGIC = b"BFP5"
_HDR = "<4sQQBBIBQ"


def _widths_from_max(mx):
    """Bit widths (32 - clz) from per-block max zigzag values."""
    return 32 - jax.lax.clz(mx.astype(jnp.uint32)).astype(jnp.int32)


# ----------------------------------------------------------------------
# Counting sort (shared by encode and decode; MUST be bit-identical)
# ----------------------------------------------------------------------
def _sort_plan(rl2, E: int):
    """Stable descending counting sort of rl2 (NSB, sb) in [0, E].

    Returns (rank (NSB, sb) int32 — destination position of each natural
    block, cnt (NSB, E) int32 — per-plane valid-word counts
    cnt[:, j] = #(rl > j))."""
    NSB, sb = rl2.shape
    rank = jnp.zeros((NSB, sb), jnp.int32)
    cnt_gt = jnp.zeros((NSB, 1), jnp.int32)  # blocks with rl > k
    cnts = []
    for k in range(E, -1, -1):
        eq = (rl2 == k).astype(jnp.int32)
        # dtype= pins i32: under jax_enable_x64 sum/cumsum promote to i64,
        # which doubles scatter/gather index traffic
        prefix = jnp.cumsum(eq, axis=1, dtype=jnp.int32) - eq
        rank = rank + eq * (cnt_gt + prefix)
        cnts.append(cnt_gt)  # before adding bucket k: #(rl > k)
        cnt_gt = cnt_gt + jnp.sum(eq, axis=1, keepdims=True, dtype=jnp.int32)
    # cnts[i] corresponds to k = E-i; plane j needs #(rl > j), j in 0..E-1
    cnt = jnp.concatenate([cnts[E - j] for j in range(E)], axis=1)
    return rank.astype(jnp.int32), cnt.astype(jnp.int32)


def _plan_offsets(cnt_c, C: int):
    """From per-plane CHUNK counts (NSB, E): per-band row counts rband,
    plane row offsets within each superblock, global SB row offsets, and
    the total row count. Each plane stores C bands of rband rows."""
    rband = (cnt_c + (LANES - 1)) // LANES  # (NSB, E)
    rows = rband * C
    woff = jnp.cumsum(rows, axis=1, dtype=jnp.int32) - rows
    tot = jnp.sum(rows, axis=1, dtype=jnp.int32)  # (NSB,)
    sb_off = (jnp.cumsum(tot) - tot).astype(jnp.int32)
    resid_rows = (sb_off[-1] + tot[-1]).astype(jnp.int32)
    return rband.astype(jnp.int32), woff.astype(jnp.int32), sb_off, resid_rows


# ----------------------------------------------------------------------
# Bitplane split / merge of banded (sbc, C*32) chunk-row tiles
# ----------------------------------------------------------------------
def _plane_split(tile_u32, C):
    """(sbc, C*32) u32 chunk rows -> (32, C, sbc) bitplane words: index
    [j, b, c'] = plane-j word of block slot b of (sorted) chunk c'."""
    sbc = tile_u32.shape[0]
    zi = tile_u32.T.reshape(C, BS, sbc).transpose(1, 0, 2)  # (32, C, sbc)
    return _bit_transpose32(zi)


def _plane_merge(zt, C):
    """Inverse of _plane_split: (32, C, sbc) plane words -> (sbc, C*32)."""
    sbc = zt.shape[2]
    zi = _bit_transpose32(zt)  # (32, C, sbc) element words
    return zi.transpose(1, 0, 2).reshape(C * BS, sbc).T


# ----------------------------------------------------------------------
# Band pack / unpack, vmapped over superblocks
# ----------------------------------------------------------------------
def _encode_xla(sym_sorted, woff, rband, sb_off, K, E, sb, C, alloc_rows):
    NC = sym_sorted.shape[0]
    sbc = sb // C
    NSB = NC // sbc
    PR = sb // LANES
    BPR = sbc // LANES
    CAP = E * PR

    def one(tile, woff_row, rb_row):
        zt = _plane_split(tile.astype(jnp.uint32), C)  # (32, C, sbc)
        base = (zt[:K] if K else jnp.zeros((0, C, sbc), jnp.uint32))
        base = jnp.concatenate(
            [base, jnp.zeros((max(K, 1) - K, C, sbc), jnp.uint32)], axis=0
        )
        buf = jnp.zeros((CAP, LANES), jnp.uint32)
        for j in range(E):
            for b in range(C):
                ob = woff_row[j] + b * rb_row[j]
                win = jax.lax.dynamic_slice(
                    buf, (ob, jnp.int32(0)), (BPR, LANES)
                )
                buf = jax.lax.dynamic_update_slice(
                    buf, win | zt[K + j, b].reshape(BPR, LANES),
                    (ob, jnp.int32(0)),
                )
        return base, buf

    bases, bufs = jax.vmap(one)(
        sym_sorted.reshape(NSB, sbc, C * BS), woff, rband
    )
    out = jnp.zeros((alloc_rows, LANES), jnp.uint32)

    def body(out, xs):
        buf, off = xs
        # capacity window write; later (higher-offset) windows overwrite
        # earlier zero spill
        return jax.lax.dynamic_update_slice(out, buf, (off, jnp.int32(0))), None

    out, _ = jax.lax.scan(body, out, (bufs, sb_off))
    return bases, out


def _decode_xla(base4d, flat2d, woff, rband, sb_off, cnt_c, K, E, sb, C,
                out_dtype):
    NSB = base4d.shape[0]
    sbc = sb // C
    PR = sb // LANES
    BPR = sbc // LANES
    CAP = E * PR

    def one(base, woff_row, rb_row, off, cnt_row):
        buf = jax.lax.dynamic_slice(flat2d, (off, jnp.int32(0)), (CAP, LANES))
        rows = [base.reshape(max(K, 1), C, sbc)[:K]] if K else []
        col = jax.lax.broadcasted_iota(jnp.int32, (1, 1, sbc), 2)
        for j in range(E):
            bands = []
            for b in range(C):
                pj = jax.lax.dynamic_slice(
                    buf, (woff_row[j] + b * rb_row[j], jnp.int32(0)),
                    (BPR, LANES),
                )
                bands.append(pj.reshape(1, 1, sbc))
            pj = jnp.concatenate(bands, axis=1)
            rows.append(jnp.where(col < cnt_row[j], pj, jnp.uint32(0)))
        hi = 32 - K - E
        if hi > 0:
            rows.append(jnp.zeros((hi, C, sbc), jnp.uint32))
        zt = jnp.concatenate(rows, axis=0)
        return _plane_merge(zt, C).astype(out_dtype)

    tiles = jax.vmap(one)(base4d, woff, rband, sb_off, cnt_c)
    return tiles.reshape(NSB * sbc, C * BS)


# ----------------------------------------------------------------------
# Device cores
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def encode_core(sym_padded, K: int, E: int, sb: int, exc_cap: int,
                C: int = CHUNK):
    """sym_padded (N,) int32, N % (sb*32) == 0.

    Returns (base (NSB, max(K,1), sb) u32 [sorted order], crl (NC,) i32
    [chunk residual lengths, natural order], resid2d (alloc_rows, 128)
    u32, resid_rows i32, exc_ids (exc_cap,) i32, exc_blocks (exc_cap, 32)
    i32, exc_count i32).

    The sort unit is a CHUNK of C blocks: the width sort is one row gather
    of NC = NB / C rows, so larger chunks mean fewer, wider rows at the
    price of a coarser chunk-max width."""
    N = sym_padded.shape[0]
    NB = N // BS
    NC = NB // C
    NSB = NB // sb
    sbc = sb // C
    PR = sb // LANES
    CAP = E * PR
    # chunk widths: zigzag + max on the natural (NC, C*32) chunk-row layout
    sym_rows = sym_padded.reshape(NC, C * BS)
    zz_rows = _zigzag(sym_rows)
    cmx = jnp.max(zz_rows, axis=1)
    cw = _widths_from_max(cmx)
    # exception chunks carry their payload verbatim in the side stream;
    # their sorted-stream content is ZEROED (crl = 0, zero planes) so the
    # u16 narrow path never truncates live data
    mask = cw > (K + E)
    exc_count = jnp.sum(mask.astype(jnp.int32))
    exc_ids = masked_indices(mask, exc_cap, NC)
    exc_blocks = jnp.take(sym_rows, jnp.clip(exc_ids, 0, NC - 1), axis=0)
    crl = jnp.where(mask, 0, jnp.clip(cw - K, 0, E))
    zz_rows = jnp.where(mask[:, None], jnp.uint32(0), zz_rows)
    # narrow payload: with K+E <= 16 every surviving zigzag value fits 16
    # bits — halves the gather and the relayout traffic
    narrow = (K + E) <= 16
    payload = zz_rows.astype(jnp.uint16) if narrow else zz_rows
    rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sbc), E)
    rband, woff, sb_off, resid_rows = _plan_offsets(cnt_c, C)
    # invert the chunk-rank permutation (scatter of unique indices) and
    # gather chunk rows into sorted order
    rank_g = (rank_c + jnp.arange(NSB, dtype=jnp.int32)[:, None] * sbc).reshape(-1)
    perm = (
        jnp.zeros((NC,), jnp.int32)
        .at[rank_g]
        .set(jnp.arange(NC, dtype=jnp.int32), unique_indices=True)
    )
    zz_sorted = jnp.take(payload, perm, axis=0)
    alloc_rows = (NSB + 1) * CAP
    base, resid2d = _encode_xla(
        zz_sorted, woff, rband, sb_off, K, E, sb, C, alloc_rows
    )
    return base, crl, resid2d, resid_rows, exc_ids, exc_blocks, exc_count


@partial(jax.jit, static_argnums=(5, 6, 7, 8, 9))
def decode_core(base4d, crl, resid2d, exc_ids, exc_blocks, K: int, E: int,
                sb: int, NB: int, C: int = CHUNK):
    """Inverse of encode_core -> (N,) int32 symbols."""
    NC = NB // C
    NSB = NB // sb
    sbc = sb // C
    rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sbc), E)
    rband, woff, sb_off, _ = _plan_offsets(cnt_c, C)
    narrow = (K + E) <= 16
    out_dtype = jnp.uint16 if narrow else jnp.uint32
    zz_sorted = _decode_xla(base4d, resid2d, woff, rband, sb_off,
                            cnt_c, K, E, sb, C, out_dtype)
    # un-sort: natural[c] = sorted[rank[c]] — one row gather (half width
    # on the narrow path), then widen + un-zigzag elementwise
    rank_g = (rank_c + jnp.arange(NSB, dtype=jnp.int32)[:, None] * sbc).reshape(-1)
    zz_rows = jnp.take(zz_sorted, rank_g, axis=0)
    sym_rows = _unzigzag(zz_rows.astype(jnp.uint32))
    # patch exception chunks with their verbatim symbols (row scatter)
    sym_rows = sym_rows.at[exc_ids].set(exc_blocks, mode="drop")
    return sym_rows.reshape(NB * BS)


# ----------------------------------------------------------------------
# Prepared-payload cores (hybrid v2 front-end): the transform already
# emitted the u16 zigzag payload and the true u32 chunk widths, so
# encode skips the zigzag/width/exception passes entirely. The caller
# guarantees no chunk exceeds K+E planes (it falls back to the generic
# path otherwise), so the serialized blob is plain BFP5 with exc_count=0.
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def encode_core_zz(payload_rows, crl, K: int, E: int, sb: int, C: int):
    """payload_rows: (NC, C*32) u16 zigzag, already grouped, exception-free.
    crl: (NC,) i32 residual lengths. Returns (base, resid2d, resid_rows)."""
    NC = payload_rows.shape[0]
    NB = NC * C
    NSB = NB // sb
    sbc = sb // C
    PR = sb // LANES
    rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sbc), E)
    rband, woff, sb_off, resid_rows = _plan_offsets(cnt_c, C)
    alloc_rows = (NSB + 1) * E * PR
    rank_g = (rank_c + jnp.arange(NSB, dtype=jnp.int32)[:, None] * sbc).reshape(-1)
    perm = (
        jnp.zeros((NC,), jnp.int32)
        .at[rank_g]
        .set(jnp.arange(NC, dtype=jnp.int32), unique_indices=True)
    )
    zz_sorted = jnp.take(payload_rows, perm, axis=0)
    base, resid2d = _encode_xla(zz_sorted, woff, rband, sb_off,
                                K, E, sb, C, alloc_rows)
    return base, resid2d, resid_rows


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7, 8))
def decode_core_zz(base4d, crl, resid2d, K: int, E: int, sb: int, NB: int,
                   C: int, static_cap: bool = False):
    """Inverse of encode_core_zz -> (NC, C*32) u16 zigzag rows in natural
    order (the hybrid-v2 inverse consumes them directly). static_cap: the
    residual buffer is in the v3 fixed-slot layout."""
    NC = NB // C
    NSB = NB // sb
    sbc = sb // C
    rank_c, cnt_c = _sort_plan(crl.reshape(NSB, sbc), E)
    rband, woff, sb_off, _ = _plan_offsets(cnt_c, C)
    if static_cap:
        CAP = E * (sb // LANES)
        BPR = sbc // LANES
        sb_off = (jnp.arange(NSB, dtype=jnp.int32) * CAP)
        rband = jnp.full_like(rband, BPR)
        rows = rband * C
        woff = jnp.cumsum(rows, axis=1, dtype=jnp.int32) - rows
    zz_sorted = _decode_xla(base4d, resid2d, woff, rband, sb_off,
                            cnt_c, K, E, sb, C, jnp.uint16)
    rank_g = (rank_c + jnp.arange(NSB, dtype=jnp.int32)[:, None] * sbc).reshape(-1)
    return jnp.take(zz_sorted, rank_g, axis=0)


def serialize_prepared_parts(n: int, K: int, E: int, sb: int, C: int, crl,
                             base, resid2d, resid_rows) -> list:
    """encode_core_zz result as bytesink parts (exception-free blob).
    The residual payload is written by Fills: band compaction targets the
    final blob region directly (single copy after the device fetch)."""
    return _blob_parts(n, K, E, sb, C, crl, base, resid2d, resid_rows, 0)


def deserialize_prepared(data: bytes, offset: int = 0,
                         static_cap: bool = False):
    """Parse a BFP5 blob into device arrays for decode_core_zz. Returns
    (base3d, crl, resid2d, (n, K, E, sb, C), consumed). Requires an
    exception-free blob (the hybrid-v2 writer's invariant). static_cap
    expands the residual payload into the v3 fixed-slot layout."""
    magic, n, resid_rows, K, E, sb, C, cnt = struct.unpack_from(_HDR, data, offset)
    if magic != _MAGIC:
        raise ValueError("bad BFP blob")
    if cnt:
        raise ValueError("prepared-payload decode requires an exception-free blob")
    p = offset + struct.calcsize(_HDR)
    npad = _pad_to(n, sb)
    NB = npad // BS
    NSB = NB // sb
    sbc = sb // C
    PR = sb // LANES
    CAP = E * PR
    NC = NB // C
    nnib = (NC + 1) // 2
    nib = np.frombuffer(data, np.uint8, nnib, p)
    p += nnib
    rl = np.empty(nnib * 2, np.int32)
    rl[0::2] = nib & 0xF
    rl[1::2] = nib >> 4
    rl = rl[:NC]
    base = np.zeros((NSB, max(K, 1), C, sbc), np.uint32)
    if K:
        base[:, :K] = np.frombuffer(data, "<u4", K * NB, p).reshape(
            NSB, K, C, sbc
        )
        p += 4 * K * NB
    resid = np.frombuffer(data, "<u4", resid_rows, p)
    p += 4 * resid_rows
    rbuf, _ = _expand_resid(resid, rl, E, C, sb, static_cap=static_cap)
    return (jnp.asarray(base), jnp.asarray(rl), jnp.asarray(rbuf),
            (n, K, E, sb, C), p - offset)


# ----------------------------------------------------------------------
# Wire compaction (host side): map between the device row-padded band
# layout and the compact valid-words wire layout, from the sidecar alone
# ----------------------------------------------------------------------
def _band_src_indices(crl_h: np.ndarray, E: int, C: int, sb: int):
    """From host chunk residual lengths (NC,): flat word indices of every
    VALID band word inside the device (rows, 128) buffer, in wire order.
    Returns (src (resid_words,) int64, padded_rows int)."""
    NC = crl_h.shape[0]
    sbc = sb // C
    NSB = (NC * C) // sb
    crl2 = crl_h.reshape(NSB, sbc)
    cnt = (crl2[:, None, :] > np.arange(E)[None, :, None]).sum(2)  # (NSB,E)
    rband = -(-cnt // LANES)
    rows_p = rband * C  # rows per (SB, plane)
    sb_rows = rows_p.sum(1)
    sb_off = np.concatenate([[0], np.cumsum(sb_rows)])[:-1]
    woff = np.cumsum(rows_p, axis=1) - rows_p
    seg_start = (
        sb_off[:, None, None] + woff[:, :, None]
        + np.arange(C)[None, None, :] * rband[:, :, None]
    ).astype(np.int64) * LANES  # (NSB, E, C) word offsets
    lens = np.broadcast_to(cnt[:, :, None], (NSB, E, C)).reshape(-1)
    starts = seg_start.reshape(-1)
    total = int(lens.sum())
    cl = np.concatenate([[0], np.cumsum(lens)])[:-1]
    src = np.repeat(starts - cl, lens) + np.arange(total, dtype=np.int64)
    return src, int(sb_rows.sum())


def _as_le_u4(a: np.ndarray) -> np.ndarray:
    """Little-endian uint32, zero-copy when the array already is one."""
    if a.dtype == np.dtype("<u4") and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a).astype("<u4", copy=False)


def _band_geometry(crl_h: np.ndarray, E: int, C: int, sb: int,
                   static_cap: bool = False):
    """Small-array band geometry shared by compaction and expansion:
    per-(superblock, plane) valid word count (cnt), band row count per
    channel (rband), global band start row, and total padded rows. Counts
    are permutation-invariant, so the sidecar alone determines them even
    though the device rows are width-sorted.

    static_cap=True describes the v3 (hybrid flag-2) DEVICE layout: every
    superblock owns a fixed CAP = E*(sb/LANES)-row slot (offset i*CAP)
    with its bands at static per-SB offsets. The WIRE bytes are identical
    either way (compaction strips the padding); only the device
    intermediate differs."""
    sbc = sb // C
    NSB = (crl_h.shape[0] * C) // sb
    crl2 = crl_h.reshape(NSB, sbc)
    cnt = (crl2[:, None, :] > np.arange(E)[None, :, None]).sum(2)  # (NSB,E)
    rband = -(-cnt // LANES)
    if static_cap:
        # v3 layout: band (j, b) owns the FULL BPR = sbc/LANES rows at the
        # STATIC offset (j*C + b)*BPR inside the superblock's CAP slot.
        # Rows past ceil(cnt/LANES) hold zero words (sorted-prefix
        # invariant), which the wire compaction strips via cnt.
        CAP = E * (sb // LANES)
        BPR = sbc // LANES
        rband = np.full_like(cnt, BPR)
        rows_p = rband * C  # (NSB, E) == C*BPR everywhere
        woff = np.cumsum(rows_p, axis=1) - rows_p
        band_start = np.arange(NSB)[:, None] * CAP + woff
        return cnt, rband, band_start, NSB * CAP
    rows_p = (rband * C).reshape(-1)
    ends = np.cumsum(rows_p)
    band_start = (ends - rows_p).reshape(NSB, E)
    rows = int(ends[-1]) if ends.size else 0
    return cnt, rband, band_start, rows


def resid_wire_words(crl_h: np.ndarray, E: int, C: int, sb: int) -> int:
    """Valid residual word count on the wire, from the sidecar alone."""
    cnt = _band_geometry(crl_h, E, C, sb)[0]
    return int(cnt.sum()) * C


def _compact_resid(resid_flat: np.ndarray, crl_h: np.ndarray, E: int,
                   C: int, sb: int) -> np.ndarray:
    out = np.empty(resid_wire_words(crl_h, E, C, sb), resid_flat.dtype)
    _compact_resid_into(out, resid_flat, crl_h, E, C, sb)
    return out


def _compact_sb(out: np.ndarray, resid_flat: np.ndarray, cnt, rband,
                band_start, C: int, s: int) -> int:
    """Write superblock ``s``'s compact residual words into ``out``;
    returns the word count written."""
    o = 0
    for p in range(cnt.shape[1]):
        c = int(cnt[s, p])
        if not c:
            continue
        r = int(rband[s, p])
        st = int(band_start[s, p]) * LANES
        band = resid_flat[st : st + C * r * LANES].reshape(C, r * LANES)
        m = C * c
        out[o : o + m].reshape(C, c)[:] = band[:, :c]
        o += m
    return o


def _compact_resid_into(out: np.ndarray, resid_flat: np.ndarray,
                        crl_h: np.ndarray, E: int, C: int, sb: int) -> None:
    """Band-sliced prefix compaction (wire order = (superblock, plane,
    channel) segments of cnt words each), written into ``out`` — which the
    serializer points at the final blob region, so the payload is copied
    exactly once. A per-word gather index would be tens of MB of int64
    traffic; slicing per band (NSB*E iterations, each a contiguous 2-D
    prefix copy) moves only the payload bytes."""
    cnt, rband, band_start, _ = _band_geometry(crl_h, E, C, sb)
    o = 0
    for s in range(cnt.shape[0]):
        o += _compact_sb(out[o:], resid_flat, cnt, rband, band_start, C, s)


def _blob_parts(n: int, K: int, E: int, sb: int, C: int, crl, base,
                resid2d, resid_rows, exc_cnt: int) -> list:
    """Common BFP blob assembly shared by serialize_prepared_parts and
    serialize_device_parts: header (with exc_cnt), nibble-packed sidecar,
    base planes (the non-contiguous [:, :K] slice rides as-is — bytesink
    strided-copies it into the blob with no staging buffer), and the
    residual payload as one bytesink Fill PER superblock (disjoint
    destination ranges, so multi-core hosts assemble them in parallel).
    Band geometry is computed once for the word count and the fills."""
    from .huffman import device_get_prefix
    from ..utils.bytesink import Fill

    rows_i = int(resid_rows)
    NB = _pad_to(n, sb) // BS
    NC = NB // C
    crl_h = np.asarray(crl)
    rl_h = crl_h.astype(np.uint8)
    if NC % 2:
        rl_h = np.concatenate([rl_h, np.zeros(1, np.uint8)])
    nib = rl_h[0::2] | (rl_h[1::2] << 4)
    base_h = np.asarray(base)[:, :K] if K else np.zeros(0, "<u4")
    resid_flat = device_get_prefix(
        resid2d.reshape(-1), rows_i * LANES
    ).astype(np.uint32)
    cnt, rband, band_start, _ = _band_geometry(crl_h, E, C, sb)
    words = int(cnt.sum()) * C
    head = struct.pack(_HDR, _MAGIC, n, words, K, E, sb, C, exc_cnt)
    parts = [head, nib.astype(np.uint8), base_h]
    words_sb = cnt.sum(1) * C
    for s in range(cnt.shape[0]):
        w = int(words_sb[s])
        if not w:
            continue
        parts.append(Fill(4 * w, lambda d, s=s: _compact_sb(
            d.view("<u4"), resid_flat, cnt, rband, band_start, C, s)))
    return parts


def _expand_resid(compact: np.ndarray, crl_h: np.ndarray, E: int, C: int,
                  sb: int, static_cap: bool = False):
    """Inverse of _compact_resid -> ((rows+CAP, LANES) uint32, padded_rows)."""
    cnt, rband, band_start, rows = _band_geometry(crl_h, E, C, sb,
                                                  static_cap=static_cap)
    total = int(cnt.sum()) * C
    if compact.shape[0] != total:
        raise ValueError(
            f"BFP resid stream has {compact.shape[0]} words, sidecar "
            f"implies {total}"
        )
    NSB, Ep = cnt.shape
    CAP = E * (sb // LANES)
    buf = np.zeros(((rows + CAP) * LANES,), np.uint32)
    o = 0
    for s in range(NSB):
        for p in range(Ep):
            c = int(cnt[s, p])
            if not c:
                continue
            r = int(rband[s, p])
            st = int(band_start[s, p]) * LANES
            band = buf[st : st + C * r * LANES].reshape(C, r * LANES)
            m = C * c
            band[:, :c] = compact[o : o + m].reshape(C, c)
            o += m
    return buf.reshape(-1, LANES), rows


# ----------------------------------------------------------------------
# Parameter selection (sticky per stream size; autotuner-persistable)
# ----------------------------------------------------------------------
_K_CACHE: dict = {}


def choose_K(hist_cw: np.ndarray, E: int, C: int = CHUNK) -> int:
    """Pick the base plane count minimizing expected words/block:
    cost(K) = K + E_cw[clip(cw-K,0,E)] + P_cw(cw>K+E) * 129/4, where cw is
    the chunk-max width (each block pays its chunk's residual planes) and
    an exception chunk ships 1 id + C*32 raw words."""
    totc = int(hist_cw.sum())
    if totc == 0:
        return 0
    w = np.arange(33)
    best_k, best_c = 0, 1e18
    for K in range(0, 33 - E):
        rlv = np.clip(w - K, 0, E)
        p_exc = hist_cw[K + E + 1 :].sum() / totc
        c = K + float((hist_cw * rlv).sum()) / totc + p_exc * (1 + C * BS) / C
        if c < best_c:
            best_k, best_c = K, c
    return best_k


@partial(jax.jit, static_argnums=(1,))
def _width_hist(sym, C: int = CHUNK):
    """Chunk-max width histogram (33,)."""
    cmx = jnp.max(_zigzag(sym.reshape(-1, C * BS)), axis=1)
    return jnp.bincount(_widths_from_max(cmx), length=33)


def _choose_sb(n: int) -> int:
    return SB_BLOCKS if n >= SB_BLOCKS * BS else SB_BLOCKS_SMALL


def _pad_to(n: int, sb: int) -> int:
    q = sb * BS
    return (n + q - 1) // q * q


def _exc_bucket(count: int, NB: int) -> int:
    cap = max(256, 1 << max(int(count) - 1, 1).bit_length())
    return min(cap, NB)


def encode_device(symbols, config=None):
    """Device phase: dispatch the jitted pack, return opaque state for
    serialize_device(). K is sticky per (padded size): measured from the
    first stream's width histogram, cached, and refined only when the
    exception list overflows its bucket."""
    n = int(symbols.shape[0])
    if n == 0:
        return ("empty",)
    sb = int(getattr(config, "bfp_sb_blocks", 0) or 0) or _choose_sb(n)
    if sb % LANES or sb < LANES:
        raise ValueError(f"bfp_sb_blocks must be a multiple of {LANES}, got {sb}")
    if n < sb * BS:
        sb = _choose_sb(n)  # stream smaller than one tuned superblock
    npad = _pad_to(n, sb)
    sym = jnp.asarray(symbols).astype(jnp.int32).ravel()
    if npad != n:
        sym = jnp.concatenate([sym, jnp.zeros(npad - n, jnp.int32)])
    NB = npad // BS
    E = int(getattr(config, "bfp_resid_planes", 0) or E_DEFAULT)
    if not 1 <= E <= 15:
        # residual lengths are serialized as 4-bit nibbles; E >= 16 would
        # silently overflow into the neighbouring nibble and corrupt decode
        raise ValueError(f"bfp_resid_planes must be in [1, 15], got {E}")
    C = int(getattr(config, "bfp_chunk", 0) or CHUNK)
    if C < 1 or C > 255 or (sb % C):
        raise ValueError(f"bfp_chunk must divide sb, got {C}")
    # the banded layout needs whole 128-word rows per band (sbc % LANES
    # == 0); halve C until it fits (C=1 always does since sb % LANES == 0)
    while C > 1 and sb % (C * LANES):
        C //= 2
    K = int(getattr(config, "bfp_base_planes", 0) or 0)
    key = (npad, E, C)
    if not K:
        if key in _K_CACHE:
            K = _K_CACHE[key][0]
        else:
            hcw = np.asarray(_width_hist(sym, C))
            K = choose_K(hcw, E, C)
            exc0 = int(hcw[K + E + 1 :].sum())
            _K_CACHE[key] = (K, _exc_bucket(exc0, NB // C))
    exc_cap = _K_CACHE.get(key, (K, max(256, (NB // C) >> 8)))[1]
    out = encode_core(sym, K, E, sb, exc_cap, C)
    # sym rides along so serialize_device can re-dispatch on the rare
    # exception-bucket overflow without the caller keeping state
    return ("bfp", n, K, E, sb, exc_cap, sym, out, C)


def serialize_device_parts(state) -> list:
    if state[0] == "empty":
        return [struct.pack(_HDR, _MAGIC, 0, 0, 0, 0, SB_BLOCKS_SMALL,
                            CHUNK, 0)]
    from .huffman import device_get_prefix

    _, n, K, E, sb, exc_cap, sym, out, C = state
    base, rl, resid2d, resid_rows, exc_ids, exc_blocks, exc_count = out
    cnt = int(exc_count)
    npad = _pad_to(n, sb)
    NB = npad // BS
    if cnt > exc_cap:
        # capacity ladder: re-dispatch once at the exact count's bucket
        # (bounded recompiles, mirrors the outlier-capture ladder)
        exc_cap = _exc_bucket(cnt, NB // C)
        _K_CACHE[(npad, E, C)] = (K, exc_cap)
        out = encode_core(sym, K, E, sb, exc_cap, C)
        base, rl, resid2d, resid_rows, exc_ids, exc_blocks, exc_count = out
        cnt = int(exc_count)
    ids_h = device_get_prefix(exc_ids, cnt).astype("<u4")
    blk_h = np.asarray(exc_blocks[:cnt]) if cnt else np.zeros(
        (0, C * BS), "<i4"
    )
    return (_blob_parts(n, K, E, sb, C, rl, base, resid2d, resid_rows, cnt)
            + [ids_h, blk_h])


def serialize_device(state) -> bytes:
    from ..utils.bytesink import join

    return join(serialize_device_parts(state))


def encode(symbols, config=None) -> bytes:
    return serialize_device(encode_device(symbols, config))


def decode(data: bytes, offset: int = 0):
    magic, n, resid_rows, K, E, sb, C, cnt = struct.unpack_from(_HDR, data, offset)
    p = offset + struct.calcsize(_HDR)
    if magic != _MAGIC:
        raise ValueError("bad BFP blob")
    if n == 0:
        return jnp.zeros((0,), jnp.int32), p - offset
    npad = _pad_to(n, sb)
    NB = npad // BS
    NSB = NB // sb
    sbc = sb // C
    PR = sb // LANES
    CAP = E * PR
    NC = NB // C
    nnib = (NC + 1) // 2
    nib = np.frombuffer(data, np.uint8, nnib, p)
    p += nnib
    rl = np.empty(nnib * 2, np.int32)
    rl[0::2] = nib & 0xF
    rl[1::2] = nib >> 4
    rl = rl[:NC]
    base = np.zeros((NSB, max(K, 1), C, sbc), np.uint32)
    if K:
        base[:, :K] = np.frombuffer(data, "<u4", K * NB, p).reshape(
            NSB, K, C, sbc
        )
        p += 4 * K * NB
    resid = np.frombuffer(data, "<u4", resid_rows, p)
    p += 4 * resid_rows
    ids = np.frombuffer(data, "<u4", cnt, p).astype(np.int32)
    p += 4 * cnt
    blocks = np.frombuffer(data, "<i4", cnt * C * BS, p).reshape(
        cnt, C * BS
    )
    p += 4 * cnt * C * BS
    # re-create the device row-padded band layout (incl. the CAP slack the
    # last superblock's capacity window reads)
    rbuf, _ = _expand_resid(resid, rl, E, C, sb)
    exc_cap = _exc_bucket(cnt, NC) if cnt else 256
    ids_pad = np.full(exc_cap, NC, np.int32)
    ids_pad[:cnt] = ids
    blk_pad = np.zeros((exc_cap, C * BS), np.int32)
    blk_pad[:cnt] = blocks
    sym = decode_core(
        jnp.asarray(base), jnp.asarray(rl), jnp.asarray(rbuf),
        jnp.asarray(ids_pad), jnp.asarray(blk_pad),
        K, E, sb, NB, C,
    )
    return sym[:n], p - offset


# ----------------------------------------------------------------------
# NumPy reference (format oracle for tests)
# ----------------------------------------------------------------------
def np_encode(symbols: np.ndarray, K: int, E: int, sb: int = SB_BLOCKS_SMALL,
              C: int = CHUNK):
    """Slow host reference: returns (crl u8 (NC,) natural chunk order,
    base u32 (chunk-sorted, plane-major then band-major per superblock),
    resid u32 (COMPACTED banded sorted-prefix planes — exactly ccnt_j
    words per band, the wire layout), exc_ids, exc_blocks)."""
    n = symbols.shape[0]
    npad = _pad_to(n, sb)
    s = np.zeros(npad, np.int64)
    s[:n] = symbols.astype(np.int64)
    zz = ((s << 1) ^ (s >> 63)).astype(np.uint64).astype(np.uint32)
    Z = zz.reshape(-1, BS)
    NB = Z.shape[0]
    widths = np.array([int(m).bit_length() for m in Z.max(axis=1)], np.int32)
    planes = np.zeros((32, NB), np.uint32)
    for b in range(NB):
        for j in range(32):
            word = 0
            for k in range(BS):
                word |= ((int(Z[b, k]) >> j) & 1) << k
            planes[j, b] = word
    rl = np.clip(widths - K, 0, E).astype(np.uint8)
    crl = rl.reshape(-1, C).max(axis=1)  # (NC,) natural chunk order
    cw = widths.reshape(-1, C).max(axis=1)
    exc_mask = cw > K + E
    # exception chunks: crl = 0 and zeroed plane content (their payload
    # ships verbatim in the exception side stream)
    crl = np.where(exc_mask, 0, crl).astype(np.uint8)
    exc_blk = np.repeat(exc_mask, C)
    planes[:, exc_blk] = 0
    sbc = sb // C
    bases, resid = [], []
    for sbi in range(NB // sb):
        lo, hi = sbi * sb, (sbi + 1) * sb
        crl_sb = crl[sbi * sbc : (sbi + 1) * sbc].astype(np.int32)
        # stable descending sort of CHUNKS; banded layout: plane words
        # grouped by block slot b within the chunk (C bands per plane)
        order_c = np.argsort(-crl_sb, kind="stable")
        # plane_sb[j, b, c'] = plane-j word of block slot b of sorted chunk c'
        plane_sb = (
            planes[:, lo:hi].reshape(-1, sbc, C).transpose(0, 2, 1)[:, :, order_c]
        )
        if K:
            bases.append(plane_sb[:K].reshape(-1))
        for j in range(E):
            ccnt_j = int((crl_sb > j).sum())
            for b in range(C):
                resid.append(plane_sb[K + j, b, :ccnt_j])
    base = np.concatenate(bases) if bases else np.zeros(0, np.uint32)
    resid = np.concatenate(resid) if resid else np.zeros(0, np.uint32)
    exc_ids = np.nonzero(exc_mask)[0].astype(np.uint32)
    exc_blocks = s.reshape(-1, C * BS)[exc_ids].astype(np.int32)
    return crl, base, resid, exc_ids, exc_blocks
