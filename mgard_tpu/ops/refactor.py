"""Multilevel decompose / recompose (the MGARD multigrid transform).

A re-design of the reference MultiDimension DataRefactoring driver
(reference: include/mgard-x/DataRefactoring/MultiDimension/
DataRefactoring.hpp:24-300 — decompose: per level CopyND ->
CalcCoefficients -> CalcCorrection -> AddND; recompose reverses) and of the
legacy CPU decompose (reference: include/mgard/decompose.tpp:128-221).

Output layout is the reference's nested-box ("reo") layout: after the full
decomposition, the level-l data occupies the leading box level_shape[l] of
the array, with level 0's coarse grid in the very corner — this is what makes
the levelwise quantizer a single fused elementwise kernel with a per-node
level lookup (reference: Hierarchy level_ranges/level_marks).

Round-trip exactness is structural: recompose recomputes the identical
interpolant and correction from the stored coefficients, so
recompose(decompose(v)) == v up to float roundoff of the shared ops.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..hierarchy import Hierarchy
from . import _be
from .axis import mass_restrict_axis, merge_axis, prolong_axis, split_axis, tridiag_solve_axis


def _box(v, shape: Sequence[int]):
    return v[tuple(slice(0, s) for s in shape)]


def _rot(v):
    """Move axis 0 to the end: (0,1,...,D-1) -> (1,...,D-1,0).

    All per-axis work below runs on axis 0 (slicing the minor axis is the
    slow case on vector hardware); a full transpose between axes costs ~1
    pass of memory traffic and XLA often fuses it into
    the adjacent elementwise work. This replaces the reference's
    per-dimension kernel specializations (Lpk1/2/3, Ipk1/2/3)."""
    if v.ndim <= 1:
        return v
    perm = tuple(range(1, v.ndim)) + (0,)
    return v.transpose(perm)


def _rot_inv(v):
    """Move the last axis to the front (inverse of _rot)."""
    if v.ndim <= 1:
        return v
    perm = (v.ndim - 1,) + tuple(range(0, v.ndim - 1))
    return v.transpose(perm)


def _correction(resid, axes):
    """L2 projection of the residual field onto the coarse grid:
    per-axis mass+restriction, then per-axis tridiagonal solve
    (reference: CalcCorrection3D.hpp:27-185 — Lpk1..3 then Ipk1..3).
    Axis-d work is done on axis 0 of the rotated array."""
    corr = resid
    for al in axes:
        corr = _rot(mass_restrict_axis(corr, 0, al))
    for al in axes:
        corr = _rot(tridiag_solve_axis(corr, 0, al))
    return corr


def _corr_matrix(hier: Hierarchy, l: int, d: int):
    """Dense per-(level, axis) correction operator A = M_c^-1 R M_f
    (nc x nf), built in f64 by probing the NumPy-oracle mass/restrict and
    tridiagonal-solve with identity columns — so the ghost-node and
    non-uniform-spacing logic is inherited exactly.

    The fast path applies A as ONE dense matmul per axis instead of slice
    chains + O(log n) associative-scan sweeps: the multigrid correction IS
    a banded linear operator per axis, and a matmul unit is the native way
    to apply it (reference equivalent: the Lpk/Ipk kernel pair)."""
    cache = getattr(hier, "_corr_mats", None)
    if cache is None:
        cache = {}
        hier._corr_mats = cache
    key = (l, d)
    if key in cache:
        return cache[key]
    al = hier.axis[l - 1][d]
    eye = np.eye(al.n_fine, dtype=np.float64)
    rm = mass_restrict_axis(eye, 0, al)  # (nc, nf) columns = responses
    A = tridiag_solve_axis(rm, 0, al)
    out = A.astype(hier.dtype)
    cache[key] = out
    return out


def _interp_matrix(hier: Hierarchy, l: int, d: int):
    """Per-(level, axis) interpolation-pass matrix P (nf x nf): identity at
    coarse rows, (wl, wr) lerp rows at coefficient positions. Applied as a
    matmul it replaces the roll+select pass."""
    cache = getattr(hier, "_interp_mats", None)
    if cache is None:
        cache = {}
        hier._interp_mats = cache
    key = (l, d)
    if key in cache:
        return cache[key]
    wl, wr, mask = _fast_axis_tables(hier, l, d)
    nf = len(mask)
    P = np.eye(nf, dtype=np.float64)
    idx = np.nonzero(mask)[0]
    P[idx] = 0.0
    P[idx, idx - 1] = wl[idx]
    P[idx, idx + 1] = wr[idx]
    out = P.astype(hier.dtype)
    cache[key] = out
    return out


def _reorder_matrix(hier: Hierarchy, l: int, d: int, inverse: bool = False):
    """Per-(level, axis) split/merge permutation S (nf x nf): rows =
    [evens (+ last node when nf even), odds] — the per-axis piece of the
    nested-box reorder. As a 0/1 matmul at HIGHEST precision it is exact
    (one unit term per row) and avoids stride-2 minor-axis slicing."""
    cache = getattr(hier, "_reorder_mats", None)
    if cache is None:
        cache = {}
        hier._reorder_mats = cache
    key = (l, d, inverse)
    if key in cache:
        return cache[key]
    nf = hier.axis[l - 1][d].n_fine
    if nf % 2 == 1:
        order = list(range(0, nf, 2)) + list(range(1, nf, 2))
    else:
        order = list(range(0, nf - 1, 2)) + [nf - 1] + list(range(1, nf - 2, 2))
    S = np.zeros((nf, nf), hier.dtype)
    S[np.arange(nf), order] = 1.0
    if inverse:
        S = S.T.copy()
    cache[key] = S
    return S


def _apply_axis0_mm(A, x):
    """y = A @ x along axis 0, result axis rotated to the end (the _rot
    convention): composing D of these cycles back to the original order.

    Every operator runs at Precision.HIGHEST: a 3-pass (bf16x3) setting
    was found NOT exact even for 0/1 permutation rows (reorder-only
    roundtrip Linf 1.6e-4 vs ~1e-6 all-HIGHEST, a sixth of a 1e-3 budget),
    and on a GPU HIGHEST keeps float32 matmuls out of TF32."""
    import jax
    import jax.numpy as jnp

    return _rot(
        jnp.tensordot(
            jnp.asarray(A), x, axes=([1], [0]),
            precision=jax.lax.Precision.HIGHEST,
        )
    )


def _correction_mm(resid, hier: Hierarchy, l: int):
    """Fast-path correction: per-axis dense matmuls (HIGHEST precision;
    the roundtrip stays exact because recompose applies the identical
    operator)."""
    import jax
    import jax.numpy as jnp

    corr = resid
    for d in range(hier.D):
        corr = _apply_axis0_mm(_corr_matrix(hier, l, d), corr)
    return corr


def _extract_coarse(v, axes):
    coarse = v
    for al in axes:
        c, _ = split_axis(coarse, 0, al.n_fine)
        coarse = _rot(c)
    return coarse


def decompose_level(v, hier: Hierarchy, l: int, orthogonal: bool = True):
    """One coarsening step on the compact level-l box.

    Returns the fine box in reordered layout: coarse values (+ correction if
    orthogonal) in the leading coarse box, multilinear-interpolation
    coefficients in the complementary slabs.
    """
    axes = hier.axis[l - 1]
    D = hier.D

    # Multilinear interpolant at every non-coarse node (coarse positions keep
    # their original values, so v - interp is exactly 0 there). The per-axis
    # interpolation passes commute, so rotating through the axes is exact.
    interp = v
    for al in axes:
        interp = _rot(prolong_axis(interp, 0, al))
    resid = v - interp

    coarse = _extract_coarse(v, axes)
    if orthogonal:
        coarse = coarse + _correction(resid, axes)

    # Reorder each axis into [coarse | coefficients]; composed over axes this
    # produces the nested-box layout. The all-even class lands in the leading
    # box holding zeros (resid is 0 there) and is overwritten by the coarse
    # values.
    reo = resid
    for al in axes:
        c_part, x_part = split_axis(reo, 0, al.n_fine)
        reo = _rot(_be.concat([c_part, x_part], 0))
    return _be.update_box(reo, coarse, D)


def recompose_level(reo, hier: Hierarchy, l: int, orthogonal: bool = True):
    """Inverse of decompose_level."""
    axes = hier.axis[l - 1]
    D = hier.D
    coarse_shape = hier.level_shape[l - 1]

    coarse_box = _box(reo, coarse_shape)
    resid_reo = _be.update_box(reo, _be.zeros(coarse_shape, reo.dtype, reo), D)
    # Un-reorder back to physical (interleaved) positions.
    resid = resid_reo
    for d in reversed(range(D)):
        al = axes[d]
        resid = _rot_inv(resid)
        c_part = _be.sl(resid, 0, 0, al.n_coarse)
        x_part = _be.sl(resid, 0, al.n_coarse, al.n_fine)
        resid = merge_axis(c_part, x_part, 0, al.n_fine)

    coarse_vals = coarse_box
    if orthogonal:
        coarse_vals = coarse_vals - _correction(resid, axes)

    # Scatter coarse values back to their physical positions (zeros at the
    # coefficient positions), then re-run the interpolation passes; they read
    # only already-final values, reproducing decompose's interpolant exactly.
    field = coarse_vals
    for al in axes:
        coeff_shape = list(field.shape)
        coeff_shape[0] = al.n_fine - al.n_coarse
        field = _rot(
            merge_axis(
                field, _be.zeros(tuple(coeff_shape), field.dtype, field), 0, al.n_fine
            )
        )
    interp = field
    for al in axes:
        interp = _rot(prolong_axis(interp, 0, al))
    return interp + resid


# ----------------------------------------------------------------------
# Fast level kernels (JAX float32): roll-based interpolation passes
# (2 static rolls + fma + select per axis instead of split/lerp/merge
# slice chains) with direct per-axis split/concat reordering — no
# transposes. The whole-array counterpart of the reference's fused
# GpkReo3D kernel (GridProcessingKernel3D.hpp:1181).
# ----------------------------------------------------------------------
def _fast_axis_tables(hier: Hierarchy, l: int, d: int):
    """Per-(level, axis) host tables for the fast path: lerp weights at odd
    positions (wl, wr) and the odd-position mask."""
    cache = getattr(hier, "_fast_tables", None)
    if cache is None:
        cache = {}
        hier._fast_tables = cache
    key = (l, d)
    if key in cache:
        return cache[key]
    al = hier.axis[l - 1][d]
    nf, nc = al.n_fine, al.n_coarse
    ncoef = nf - nc
    t = al.lerp_t.astype(np.float64)
    wl = np.zeros(nf)
    wr = np.zeros(nf)
    mask = np.zeros(nf, bool)
    idx = 2 * np.arange(ncoef) + 1
    wl[idx] = 1.0 - t
    wr[idx] = t
    mask[idx] = True
    dt = hier.dtype
    out = (wl.astype(dt), wr.astype(dt), mask)
    cache[key] = out
    return out


def decompose_level_fast(v, hier: Hierarchy, l: int, orthogonal: bool):
    axes = hier.axis[l - 1]
    D = hier.D
    # interp stays at HIGHEST: measured 384^3 roundtrip 2.6e-4 under HIGH
    # (the 2-term lerp products' bf16x3 noise compounds across levels) vs
    # ~1e-6 at HIGHEST — transform noise eats the certified budget
    interp = v
    for d in range(D):
        interp = _apply_axis0_mm(_interp_matrix(hier, l, d), interp)
    resid = v - interp

    coarse = v
    for d, al in enumerate(axes):
        coarse, _ = split_axis(coarse, d, al.n_fine)
    if orthogonal:
        coarse = coarse + _correction_mm(resid, hier, l)

    reo = resid
    for d in range(D):
        reo = _apply_axis0_mm(_reorder_matrix(hier, l, d), reo)
    return _be.update_box(reo, coarse, D)


def recompose_level_fast(reo, hier: Hierarchy, l: int, orthogonal: bool):
    axes = hier.axis[l - 1]
    D = hier.D
    coarse_shape = hier.level_shape[l - 1]
    coarse_box = _box(reo, coarse_shape)
    resid_reo = _be.update_box(reo, _be.zeros(coarse_shape, reo.dtype, reo), D)

    resid = resid_reo
    for d in range(D):
        resid = _apply_axis0_mm(_reorder_matrix(hier, l, d, inverse=True),
                                resid)

    coarse_vals = coarse_box
    if orthogonal:
        coarse_vals = coarse_vals - _correction_mm(resid, hier, l)

    # scatter coarse values to their physical (even) positions: the
    # (nf x nc) left block of the inverse reorder permutation
    field = coarse_vals
    for d in range(D):
        al = axes[d]
        E = _reorder_matrix(hier, l, d, inverse=True)[:, : al.n_coarse]
        field = _apply_axis0_mm(E, field)
    interp = field
    for d in range(D):
        interp = _apply_axis0_mm(_interp_matrix(hier, l, d), interp)
    return interp + resid


# Largest finest-level axis the dense operators are allowed to build.
# Each per-(level, axis) operator is an (nf x nf) matrix: 4096^2 f32 = 64 MB
# and an O(nf) work blow-up vs the O(1)-depth slice path, both acceptable;
# a 131073-sample 1D axis would be a ~68 GB matrix. Long axes (1D signals,
# anisotropic grids) use the split/lerp/merge path instead.
_FAST_MAX_AXIS = 4096


def _use_fast(v, hier: Hierarchy) -> bool:
    return (
        not _be.is_np(v)
        and hier.dtype == np.float32
        and v.dtype == np.float32
        and hier.D >= 1
        and max(hier.level_shape[hier.l_target]) <= _FAST_MAX_AXIS
    )


def decompose(v, hier: Hierarchy, orthogonal: bool = True):
    """Full multilevel decomposition, finest to coarsest, nested-box output."""
    D = hier.D
    fast = _use_fast(v, hier)
    for l in range(hier.l_target, 0, -1):
        fine_shape = hier.level_shape[l]
        if l == hier.l_target:
            fine = v
        else:
            fine = _box(v, fine_shape)
        if fast:
            reo = decompose_level_fast(fine, hier, l, orthogonal)
        else:
            reo = decompose_level(fine, hier, l, orthogonal)
        if l == hier.l_target:
            v = reo
        else:
            v = _be.update_box(v, reo, D)
    return v


def recompose(v, hier: Hierarchy, orthogonal: bool = True):
    """Full multilevel recomposition, coarsest to finest."""
    D = hier.D
    fast = _use_fast(v, hier)
    for l in range(1, hier.l_target + 1):
        fine_shape = hier.level_shape[l]
        if l == hier.l_target:
            reo = v
        else:
            reo = _box(v, fine_shape)
        if fast:
            rec = recompose_level_fast(reo, hier, l, orthogonal)
        else:
            rec = recompose_level(reo, hier, l, orthogonal)
        if l == hier.l_target:
            v = rec
        else:
            v = _be.update_box(v, rec, D)
    return v


# ----------------------------------------------------------------------
# SingleDim decomposition (reference: DataRefactoring/SingleDimension/
# DataRefactoring.hpp:23-120 — one dimension coarsened at a time per level;
# lower memory, different error constant in the quantizer)
# ----------------------------------------------------------------------
def _correction_axis(resid, d, al):
    return tridiag_solve_axis(mass_restrict_axis(resid, d, al), d, al)


def decompose_level_single(v, hier: Hierarchy, l: int, orthogonal: bool = True):
    """One level, coarsening each axis in sequence with per-axis 1D
    coefficients and corrections (axis-d work on axis 0 of the rotated
    array, see _rot)."""
    axes = hier.axis[l - 1]
    for al in axes:
        coarse, odd = split_axis(v, 0, al.n_fine)
        n_coeff = al.n_fine - al.n_coarse
        left = _be.sl(coarse, 0, 0, n_coeff)
        right = _be.sl(coarse, 0, 1, n_coeff + 1)
        t = _be.asarray_like(al.lerp_t, v, _sd_bshape(v.ndim, 0, n_coeff))
        coeff = odd - ((left - left * t) + t * right)
        if orthogonal:
            resid = merge_axis(_be.zeros(coarse.shape, v.dtype, v), coeff, 0, al.n_fine)
            coarse = coarse + _correction_axis(resid, 0, al)
        v = _rot(_be.concat([coarse, coeff], 0))
    return v


def recompose_level_single(reo, hier: Hierarchy, l: int, orthogonal: bool = True):
    axes = hier.axis[l - 1]
    for d in reversed(range(hier.D)):
        al = axes[d]
        nc = al.n_coarse
        reo = _rot_inv(reo)
        coarse = _be.sl(reo, 0, 0, nc)
        coeff = _be.sl(reo, 0, nc, al.n_fine)
        if orthogonal:
            resid = merge_axis(_be.zeros(coarse.shape, reo.dtype, reo), coeff, 0, al.n_fine)
            coarse = coarse - _correction_axis(resid, 0, al)
        n_coeff = al.n_fine - nc
        left = _be.sl(coarse, 0, 0, n_coeff)
        right = _be.sl(coarse, 0, 1, n_coeff + 1)
        t = _be.asarray_like(al.lerp_t, reo, _sd_bshape(reo.ndim, 0, n_coeff))
        odd = coeff + ((left - left * t) + t * right)
        reo = merge_axis(coarse, odd, 0, al.n_fine)
    return reo


def _sd_bshape(ndim, axis, n):
    s = [1] * ndim
    s[axis] = n
    return tuple(s)


def decompose_single(v, hier: Hierarchy, orthogonal: bool = True):
    D = hier.D
    for l in range(hier.l_target, 0, -1):
        fine = v if l == hier.l_target else _box(v, hier.level_shape[l])
        reo = decompose_level_single(fine, hier, l, orthogonal)
        v = reo if l == hier.l_target else _be.update_box(v, reo, D)
    return v


def _mass_trans_single_x(coeff, d, al):
    """The REFERENCE SingleDim mass-transfer along axis d (reference:
    SingleDimension/Correction/MassTransKernel.hpp:66-112 + the LPK
    mass_trans formula with a=c=e=0). Differs from our mass_restrict_axis
    in its boundary guards: the last coarse node takes NO contribution
    (b requires j < n_coeff, and the h windows stop at n_coeff+nc-1) —
    a reference quirk that is self-consistent between its decompose and
    recompose, so the cross-decoder must reproduce it exactly."""
    nf, nc = al.n_fine, al.n_coarse
    ncf = nf - nc
    h = np.zeros(2 * nc + 2, np.float64)
    hsrc = np.asarray(al.h_ext, np.float64)
    h[: hsrc.size] = hsrc
    j = np.arange(nc)
    lim = ncf + nc - 1
    c1 = (j > 0) & (2 * j < lim)
    c2 = 2 * j < lim
    h1 = np.where(c1, h[np.maximum(2 * j - 2, 0)], 0.0)
    h2 = np.where(c1, h[np.maximum(2 * j - 1, 0)], 0.0)
    h3 = np.where(c2, h[2 * j], 0.0)
    h4 = np.where(c2, h[2 * j + 1], 0.0)

    cm = np.moveaxis(np.asarray(coeff, np.float64), d, -1)
    bsel = (j > 0) & (j < ncf)
    dsel = j < ncf
    b = np.zeros(cm.shape[:-1] + (nc,), np.float64)
    dd = np.zeros_like(b)
    b[..., bsel] = cm[..., (j[bsel] - 1)]
    dd[..., dsel] = cm[..., j[dsel]]
    out = 2 * b * (h1 / 6) + (b * h2 + dd * h3) / 6 + 2 * dd * (h4 / 6)
    return np.moveaxis(out, -1, d)


def recompose_single_x(u, hier: Hierarchy):
    """Inverse of the REFERENCE library's SingleDim decomposition in its
    own nested-box layout (reference: DataRefactoring/SingleDimension/
    DataRefactoring.hpp:110-185 — per (level, dim) step the fine box has
    dims > curr_dim still at the coarse level; coefficients sit at offset
    level_shape(l, curr_dim) along curr_dim; the correction/lerp are the
    same per-axis 1D operators as ours). Used by the cross-decoder for
    reference-written SingleDim streams; our own SingleDim serialization
    keeps the rotated-concat layout of decompose_single."""
    v = np.asarray(u).copy()
    D = hier.D
    for l in range(hier.l_target):
        for d in range(D):
            fine_shape = tuple(
                hier.level_shape[l][dd] if dd > d else hier.level_shape[l + 1][dd]
                for dd in range(D)
            )
            al = hier.axis[l][d]
            nf, nc = al.n_fine, al.n_coarse
            box = v[tuple(slice(0, s) for s in fine_shape)].copy()
            coarse = _be.sl(box, d, 0, nc)
            coeff = _be.sl(box, d, nc, nf)
            corr = tridiag_solve_axis(
                _mass_trans_single_x(coeff, d, al), d, al
            )
            coarse = coarse - corr
            n_coeff = nf - nc
            left = _be.sl(coarse, d, 0, n_coeff)
            right = _be.sl(coarse, d, 1, n_coeff + 1)
            t = _be.asarray_like(al.lerp_t, box, _sd_bshape(box.ndim, d, n_coeff))
            odd = coeff + ((left - left * t) + t * right)
            fine = merge_axis(coarse, odd, d, nf)
            v[tuple(slice(0, s) for s in fine_shape)] = fine
    return v


def recompose_single(v, hier: Hierarchy, orthogonal: bool = True):
    D = hier.D
    for l in range(1, hier.l_target + 1):
        reo = v if l == hier.l_target else _box(v, hier.level_shape[l])
        rec = recompose_level_single(reo, hier, l, orthogonal)
        v = rec if l == hier.l_target else _be.update_box(v, rec, D)
    return v
