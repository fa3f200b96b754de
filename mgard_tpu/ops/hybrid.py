"""Hybrid hierarchy refactoring: blockwise 8^3 local decomposition + global
refactor of the coarse remainder.

A re-design of the reference's InCacheBlock/Hybrid stack
(reference: include/mgard-x/DataRefactoring/InCacheBlock/
Decompose8x8x8.hpp:44-452 - a shared-memory-resident full local
decomposition with 8->5->3->2 index tables - and
CompressionLowLevel/HybridHierarchyCompressor.h:31 /
HybridHierarchyDataRefactor.hpp:21-58, which runs
`num_local_refactoring_level` local passes and a global refactor on the
remainder, with shapes padded to x8).

Instead of per-block shared-memory kernels, the local levels are whole-array
periodic operations: each level's interpolation pass is 1-2 static rolls +
a select with period-8 weight/mask tables, so XLA fuses each level-axis into
~one memory pass and there is no 8^3 blocking structure in the data path at
all. The local chain per axis is 8 -> 5 -> 3 -> 2 over positions
{0..7} -> {0,2,4,6,7} -> {0,4,7} -> {0,7} (the reference's index tables),
with geometric lerp weights. The per-block 2^d corner remainder is gathered
into a compact array (static column slices) and decomposed with the regular
MultiDim transform.

For s=inf the hierarchical quantizer step is level-independent
(reference: LinearQuantization.hpp s=inf rule), so the local coefficient
field quantizes with one scalar and needs no level-reorder at all - the
coefficients stay in physical (interleaved) positions, which is exactly the
layout the BFX codec wants.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..hierarchy import Hierarchy, get_hierarchy

# local coarse position chains within an 8-block (reference: IndexTable8x8x8
# / 5x5x5 / 3x3x3, DataRefactoring/InCacheBlock/)
_CHAINS = [
    (0, 1, 2, 3, 4, 5, 6, 7),
    (0, 2, 4, 6, 7),
    (0, 4, 7),
    (0, 7),
]

# per local level: list of (coeff position, left nbr, right nbr, t)
# where value = (1-t)*v[left] + t*v[right]
_LEVEL_CLASSES: List[List[Tuple[int, int, int, float]]] = []
for _lvl in range(3):
    fine = _CHAINS[_lvl]
    coarse = set(_CHAINS[_lvl + 1])
    classes = []
    for i, p in enumerate(fine):
        if p in coarse:
            continue
        # nearest coarse neighbors within the chain
        li = i - 1
        while fine[li] not in coarse:
            li -= 1
        ri = i + 1
        while fine[ri] not in coarse:
            ri += 1
        lp, rp = fine[li], fine[ri]
        t = (p - lp) / (rp - lp)
        classes.append((p, lp, rp, t))
    _LEVEL_CLASSES.append(classes)

# group positions sharing (offsets, weight) into one roll-pair class
_LEVEL_GROUPS: List[List[Tuple[int, int, float, Tuple[int, ...]]]] = []
for _classes in _LEVEL_CLASSES:
    groups: dict = {}
    for p, lp, rp, t in _classes:
        key = (p - lp, rp - p, t)
        groups.setdefault(key, []).append(p)
    _LEVEL_GROUPS.append(
        [(k[0], k[1], k[2], tuple(ps)) for k, ps in groups.items()]
    )


def _bshape(ndim, axis, n):
    s = [1] * ndim
    s[axis] = n
    return tuple(s)


def _pos_mask(shape, axis, positions):
    """Periodic position mask computed in-graph from an iota (no captured
    array constants)."""
    import jax
    import jax.numpy as jnp

    idx = jax.lax.broadcasted_iota(
        jnp.int32, _bshape(len(shape), axis, shape[axis]), axis
    )
    # keep everything int32: a python-int operand would promote to i64
    # under jax_enable_x64
    r = jax.lax.rem(idx, jnp.int32(8))
    m = r == jnp.int32(positions[0])
    for p in positions[1:]:
        m = m | (r == jnp.int32(p))
    return m


def _interp_pass(x, axis, lvl, dtype):
    import jax.numpy as jnp

    npdt = np.dtype(x.dtype).type
    for off_l, off_r, t, positions in _LEVEL_GROUPS[lvl]:
        # typed numpy scalars: under jax_enable_x64 a python float would
        # trace as f64 and promote the f32 field
        wl = npdt(1.0 - t)
        wr = npdt(t)
        cand = wl * jnp.roll(x, off_l, axis) + wr * jnp.roll(x, -off_r, axis)
        x = jnp.where(_pos_mask(x.shape, axis, positions), cand, x)
    return x


def _coeff_mask3d(shape, lvl):
    """Level-lvl coefficient mask: in the level grid on every axis and fine
    on at least one axis."""
    D = len(shape)
    fine_pos = tuple(p for p, _, _, _ in _LEVEL_CLASSES[lvl])
    in_grid = None
    any_fine = None
    for d in range(D):
        gb = _pos_mask(shape, d, _CHAINS[lvl])
        fb = _pos_mask(shape, d, fine_pos)
        in_grid = gb if in_grid is None else (in_grid & gb)
        any_fine = fb if any_fine is None else (any_fine | fb)
    return in_grid & any_fine


def local_decompose(v, num_levels: int = 3):
    """In-place-style local decomposition: after level l, the level-l fine
    positions hold multilinear-interpolation coefficients; the level-l
    coarse positions keep their original values. All dims must be
    multiples of 8."""
    D = v.ndim
    for lvl in range(num_levels):
        w = v
        for d in range(D):
            w = _interp_pass(w, d, lvl, v.dtype)
        v = jnp_where_sub(v, w, _coeff_mask3d(v.shape, lvl))
    return v


def jnp_where_sub(v, w, mask):
    import jax.numpy as jnp

    return jnp.where(mask, v - w, v)


def local_recompose(x, num_levels: int = 3):
    """Inverse of local_decompose (coarsest local level first)."""
    import jax.numpy as jnp

    D = x.ndim
    for lvl in range(num_levels - 1, -1, -1):
        mask = _coeff_mask3d(x.shape, lvl)
        y = jnp.where(mask, jnp.zeros((), x.dtype), x)
        for d in range(D):
            y = _interp_pass(y, d, lvl, x.dtype)
        x = jnp.where(mask, x + y, x)
    return x


def _rem_cols(num_levels: int):
    return _CHAINS[num_levels]


def extract_remainder(v, num_levels: int = 3):
    """Gather each 8-block's local-coarse corner grid into a compact array
    (static column slices, no gathers)."""
    import jax.numpy as jnp

    cols = _rem_cols(num_levels)
    D = v.ndim
    x = v
    for d in range(D):
        n = x.shape[d]
        g = n // 8
        shp = x.shape[:d] + (g, 8) + x.shape[d + 1 :]
        xr = x.reshape(shp)
        sel = jnp.stack(
            [xr[(slice(None),) * (d + 1) + (c,)] for c in cols], axis=d + 1
        )
        x = sel.reshape(x.shape[:d] + (g * len(cols),) + x.shape[d + 1 :])
    return x


def insert_remainder(coeff_field, rem, num_levels: int = 3):
    """Place remainder values back at their corner positions (zeros
    elsewhere are preserved from coeff_field)."""
    import jax.numpy as jnp

    cols = _rem_cols(num_levels)
    D = coeff_field.ndim
    x = rem
    for d in range(D):
        m = x.shape[d]
        g = m // len(cols)
        shp = x.shape[:d] + (g, len(cols)) + x.shape[d + 1 :]
        xr = x.reshape(shp)
        pieces = []
        prev = -1
        for i, c in enumerate(cols):
            gap = c - prev - 1
            if gap > 0:
                zshp = xr.shape[: d + 1] + (gap,) + xr.shape[d + 2 :]
                pieces.append(jnp.zeros(zshp, xr.dtype))
            pieces.append(
                xr[(slice(None),) * (d + 1) + (slice(i, i + 1),)]
            )
            prev = c
        tail = 7 - cols[-1]
        if tail > 0:
            zshp = xr.shape[: d + 1] + (tail,) + xr.shape[d + 2 :]
            pieces.append(jnp.zeros(zshp, xr.dtype))
        full = jnp.concatenate(pieces, axis=d + 1)
        x = full.reshape(x.shape[:d] + (g * 8,) + x.shape[d + 1 :])
    mask = corner_mask(coeff_field.shape, num_levels)
    return jnp.where(mask, x, coeff_field)


def corner_mask(shape, num_levels: int = 3):
    """Boolean mask of the remainder (local-coarse-in-all-axes) positions."""
    cols = _rem_cols(num_levels)
    D = len(shape)
    m = None
    for d in range(D):
        mb = _pos_mask(shape, d, cols)
        m = mb if m is None else (m & mb)
    return m


# ----------------------------------------------------------------------
# v2 front-end (hybrid front-end flag 1): the whole cf-side compress
# front-end as one XLA program — local transform + corner split +
# quantize + zigzag + z-class grouping + per-chunk width — emitting the
# u16 BFP payload directly (reference precedent: the fused
# LevelwiseLinearQuantizerND kernel, LinearQuantization.hpp:21-146).
# The grouping and the remainder split are index operations that XLA
# fuses into the surrounding elementwise work.
# ----------------------------------------------------------------------
def local_transform_v2_xla(v, inv_q, nl: int, C: int):
    """One-pass cf front-end. Returns (payload u16 shape(v) [z-class
    grouped zigzag symbols], cw (NC,) i32 [true u32 chunk widths — a width
    over 16 means the u16 payload truncated that chunk and the caller
    must fall back to the flag-0 layout], rem [compact corner remainder])."""
    import jax
    import jax.numpy as jnp

    Z = v.shape[-1]
    CL = C * 32
    H = Z // CL
    dec = local_decompose(v, nl)
    rem = extract_remainder(dec, nl)
    cf = jnp.where(corner_mask(dec.shape, nl), jnp.zeros((), dec.dtype), dec)
    t = cf * inv_q
    half = jnp.asarray(0.5, t.dtype)
    sym = jnp.trunc(jnp.where(t < 0, t - half, t + half)).astype(jnp.int32)
    zz = (sym << 1) ^ (sym >> 31)
    grouped = zclass_group(zz)
    g3 = grouped.reshape(v.shape[:-1] + (H, CL))
    mx = jnp.max(g3, axis=-1)
    mn = jnp.min(g3, axis=-1)
    w = 32 - jax.lax.clz(mx)
    cw = jnp.where(
        mn < 0, jnp.int32(32), jnp.where(mx == 0, jnp.int32(0), w)
    ).reshape(-1)
    pay = (grouped & jnp.int32(0xFFFF)).astype(jnp.uint16)
    return pay, cw, rem


def local_inverse_v2_xla(zz_u16, rem, q, nl: int, dtype):
    """Inverse of local_transform_v2_xla: u16 grouped zigzag payload +
    compact remainder -> field. Every device decodes every stream, as the
    reference's CPU/GPU decoders are interchangeable per stream
    (compress_internal.cpp:5-13 header dispatch)."""
    import jax.numpy as jnp

    nat = zclass_ungroup(zz_u16.astype(jnp.int32))
    sym = (nat >> 1) ^ -(nat & jnp.int32(1))
    cf = sym.astype(dtype) * q
    full = insert_remainder(cf, rem, nl)
    return local_recompose(full, nl)


def hybrid_l_total(shape, num_levels: int, rem_hier: Hierarchy) -> int:
    """Total number of coarsening levels of the hybrid hierarchy."""
    return num_levels + rem_hier.l_target


def remainder_shape(shape, num_levels: int):
    k = len(_rem_cols(num_levels))
    return tuple(s // 8 * k for s in shape)


def pad_to8(shape):
    return tuple((s + 7) // 8 * 8 for s in shape)


def zclass_group(sym):
    """Group the minor axis by position class (z mod 8): after the local
    transform every 32-symbol lane run then holds a single (x,y,z)-class
    triple, so BFX block widths are level-homogeneous (pure corner-zero
    blocks cost nothing). One minor-dim relayout each way."""
    import jax.numpy as jnp

    n = sym.shape[-1]
    g = n // 8
    x = sym.reshape(sym.shape[:-1] + (g, 8))
    perm = tuple(range(sym.ndim - 1)) + (sym.ndim, sym.ndim - 1)
    return jnp.transpose(x, perm).reshape(sym.shape)


def zclass_ungroup(sym):
    """Inverse of zclass_group."""
    import jax.numpy as jnp

    n = sym.shape[-1]
    g = n // 8
    x = sym.reshape(sym.shape[:-1] + (8, g))
    perm = tuple(range(sym.ndim - 1)) + (sym.ndim, sym.ndim - 1)
    return jnp.transpose(x, perm).reshape(sym.shape)


# ----------------------------------------------------------------------
# v3 streams (hybrid front-end flag 2, decode only): each (8, 128, Z) tile
# of the field is one BFP superblock (sb = 32*Z blocks, sbc = 1024 chunks
# of C = Z/32 blocks) with every residual band in a static CAP-row slot
# (bfp._band_geometry static_cap layout); the chunk order is tile-major.
# Wire bytes otherwise match the flag-1 cf stream.
# ----------------------------------------------------------------------
def v3_ok_shape(shape) -> bool:
    """Shape gate for the v3 scheme: 3D, (8, 128, Z) tiles with
    128 | Z <= 1024 so one tile is exactly one superblock of 1024 chunks
    (C = Z/32 blocks each)."""
    if len(shape) != 3:
        return False
    X, Y, Z = shape
    return (X % 8 == 0 and Y % 128 == 0 and Z % 128 == 0 and Z <= 1024
            and Z >= 128)


def rows_tilemajor_field(rows, shape):
    """(NC, Z) rows in tile-major chunk order (the v3 stream order: tiles
    of (8, 128) leading positions, row-major within the tile, tiles in
    (gx, gy) row-major order) -> (X, Y, Z) field."""
    X, Y, Z = shape
    GX, GY = X // 8, Y // 128
    return (rows.reshape(GX, GY, 8, 128, Z).transpose(0, 2, 1, 3, 4)
            .reshape(X, Y, Z))


def unpack_inverse_v3_xla(base, crl, resid, rem, q, nl: int, K: int,
                          E: int, dtype, shape):
    """Inverse of the v3 payload: decode_core_zz(static_cap=True) ->
    tile-major rows -> row-major field -> v2 inverse."""
    from ..lossless import bfp as _bfp

    C, sb = shape[-1] // 32, 32 * shape[-1]
    NB = int(np.prod(shape)) // 32
    rows = _bfp.decode_core_zz(base, crl.reshape(-1), resid, K, E, sb,
                               NB, C, static_cap=True)
    pay = rows_tilemajor_field(rows, shape)
    return local_inverse_v2_xla(pay, rem, q, nl, dtype)

