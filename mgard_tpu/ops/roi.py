"""Region-of-interest adaptive error bounds.

Re-design of the reference's adaptive ROI machinery (reference:
include/mgard/adaptive_roi.hpp:14-76 and compress_roi in
include/compress.tpp:34-130): regions of interest are quantized with a
finer step (tol/roi_factor) while the background keeps the global bound.

The ROI is an explicit node mask; a multilevel "refinement map" marks every
coefficient whose basis support intersects the (dilated) ROI, level by
level, in the same nested-box layout as the decomposed data — so the
quantizer applies it as one fused per-node multiplier.

detect_roi() below derives the mask automatically: the whole-array
counterpart of the reference's histogram-driven block selection
(reference: adaptive_roi.hpp:30-56 hist_blc_coord/filter_hist_blc/amr_gb,
adaptive_roi.tpp:97-160) — blocks are scored by the mean |multilevel
coefficient| over non-coarsest nodes, the top ceil(thresh * nbins) blocks
are kept per depth and recursively re-binned, and the final selection is
dilated by a buffer zone. The per-block triple loop becomes one padded
reshape-reduce; the per-node date_of_birth table becomes the nested-box
index walk already used by roi_map_nested.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

from ..hierarchy import Hierarchy
from .axis import split_axis


def _dilate1(m: np.ndarray, axis: int) -> np.ndarray:
    """Max of each node and its +-1 neighbors along axis."""
    a = m
    lo = np.concatenate([a.take([0], axis), np.moveaxis(np.moveaxis(a, axis, 0)[:-1], 0, axis)], axis)
    hi = np.concatenate([np.moveaxis(np.moveaxis(a, axis, 0)[1:], 0, axis), a.take([-1], axis)], axis)
    return np.maximum(a, np.maximum(lo, hi))


def roi_map_nested(mask: np.ndarray, hier: Hierarchy) -> np.ndarray:
    """Multilevel refinement map in nested-box layout (uint8, 1 = refine).

    A level-l coefficient is refined iff the dilated ROI reaches its node:
    the coarse carry-down is max over {2j-1, 2j, 2j+1}, exactly covering the
    interpolation dependence of the removed nodes."""
    assert mask.shape == hier.shape
    out = np.zeros(hier.shape, np.uint8)
    m = np.ascontiguousarray(mask.astype(np.uint8))
    for l in range(hier.l_target, 0, -1):
        for d in range(hier.D):
            m = _dilate1(m, d)
        # reorder the current level's mask and write its coefficient slabs
        reo = m
        for d, al in enumerate(hier.axis[l - 1]):
            c_part, x_part = split_axis(reo, d, al.n_fine)
            reo = np.concatenate([c_part, x_part], axis=d)
        box = tuple(slice(0, s) for s in hier.level_shape[l])
        out[box] = reo
        # coarse carry-down
        coarse = m
        for d, al in enumerate(hier.axis[l - 1]):
            coarse, _ = split_axis(coarse, d, al.n_fine)
        m = np.ascontiguousarray(coarse)
    out[tuple(slice(0, s) for s in hier.level_shape[0])] = m
    return out


# ----------------------------------------------------------------------
# Automatic ROI detection (reference: adaptive_roi.tpp amr_gb pipeline)
# ----------------------------------------------------------------------
def _nested_to_physical(hier: Hierarchy) -> np.ndarray:
    """nested-box slot -> physical flat index (int64, hier.shape).

    Running the decomposition's per-axis reorder on an index field gives,
    for every nested-box coefficient slot, the physical node it came from
    (the role of the reference's per-node date_of_birth walk,
    compress.tpp:146-178)."""
    idx = np.arange(int(np.prod(hier.shape)), dtype=np.int64).reshape(hier.shape)
    out = np.zeros(hier.shape, np.int64)
    m = idx
    for l in range(hier.l_target, 0, -1):
        reo = m
        for d, al in enumerate(hier.axis[l - 1]):
            c_part, x_part = split_axis(reo, d, al.n_fine)
            reo = np.concatenate([c_part, x_part], axis=d)
        out[tuple(slice(0, s) for s in hier.level_shape[l])] = reo
        coarse = m
        for d, al in enumerate(hier.axis[l - 1]):
            coarse, _ = split_axis(coarse, d, al.n_fine)
        m = np.ascontiguousarray(coarse)
    out[tuple(slice(0, s) for s in hier.level_shape[0])] = m
    return out


def coefficient_magnitude_map(data, hier: Hierarchy) -> np.ndarray:
    """|multilevel coefficient| of every node at its PHYSICAL position,
    with the coarsest-grid nodes zeroed (the reference's filter scores only
    level > 0 nodes, adaptive_roi.tpp:135-140)."""
    from .refactor import decompose
    import jax.numpy as jnp

    dec = np.asarray(decompose(jnp.asarray(data), hier, orthogonal=False))
    phys = np.zeros(hier.total_num_elems, dec.dtype)
    phys[_nested_to_physical(hier).ravel()] = np.abs(dec).ravel()
    mag = phys.reshape(hier.shape)
    # zero the coarsest grid: those nodes carry field values, not details
    idx0 = _nested_to_physical(hier)[
        tuple(slice(0, s) for s in hier.level_shape[0])
    ]
    mag.ravel()[idx0.ravel()] = 0.0
    return mag


def _block_scores(mag: np.ndarray, bw):
    """Mean |coefficient| per block of shape bw (edge blocks use their true
    area, the reference's normalization, adaptive_roi.tpp:107-147).
    Returns (scores, nblocks_per_dim)."""
    shape = mag.shape
    nb = [int(-(-s // b)) for s, b in zip(shape, bw)]
    pad = [(0, n * b - s) for s, b, n in zip(shape, bw, nb)]
    m = np.pad(mag, pad)
    cnt = np.pad(np.ones_like(mag), pad)
    resh = []
    for n, b in zip(nb, bw):
        resh += [n, b]
    axes = tuple(range(1, 2 * len(nb), 2))
    tot = m.reshape(resh).sum(axis=axes)
    area = cnt.reshape(resh).sum(axis=axes)
    return tot / np.maximum(area, 1.0), nb


def detect_roi(
    data,
    hier: Hierarchy,
    init_bw: Optional[Sequence[int]] = None,
    bw_ratio: Sequence[int] = (2,),
    thresh: Sequence[float] = (0.25, 0.5),
    buffer_radius: Optional[int] = None,
) -> np.ndarray:
    """Derive a region-of-interest node mask from the data itself.

    The reference pipeline re-derived as whole-array ops
    (adaptive_roi.hpp:30-56):
      1. score first-depth blocks of shape init_bw by mean |coefficient|
         over non-coarsest nodes (filter_hist_blc's histogram weights),
      2. keep the top ceil(thresh[0] * nblocks) blocks,
      3. re-bin kept blocks by bw_ratio and repeat per depth (amr_gb),
      4. dilate the final selection by a buffer zone (set_buffer_zone).

    thresh has one entry per depth; bw_ratio one per depth after the
    first. Defaults: init_bw = shape/8 (capped >= 4 nodes), two depths
    keeping 25% then 50%, buffer radius = final block width.
    Returns a boolean mask of hier.shape (True = region of interest).
    """
    shape = tuple(hier.shape)
    D = len(shape)
    if init_bw is None:
        init_bw = [max(4, s // 8) for s in shape]
    init_bw = [min(int(b), s) for b, s in zip(init_bw, shape)]
    depth = len(thresh)
    if len(bw_ratio) < depth - 1:
        bw_ratio = tuple(bw_ratio) + (bw_ratio[-1] if bw_ratio else 2,) * (
            depth - 1 - len(bw_ratio)
        )

    mag = coefficient_magnitude_map(data, hier)

    keep = np.ones([1] * D, bool)  # depth-0: the whole domain
    bw = list(init_bw)
    prev_bw = list(shape)
    for d in range(depth):
        scores, nb = _block_scores(mag, bw)
        # a child block is a candidate only inside a kept parent block
        parent_idx = np.meshgrid(
            *[np.minimum(np.arange(n) * b // p, k - 1)
              for n, b, p, k in zip(nb, bw, prev_bw, keep.shape)],
            indexing="ij",
        )
        cand = keep[tuple(parent_idx)]
        scores = np.where(cand, scores, -np.inf)
        ncand = int(cand.sum())
        nkeep = max(1, int(math.ceil(float(thresh[d]) * ncand)))
        flat = scores.ravel()
        order = np.argsort(flat)[::-1][:nkeep]
        sel = np.zeros(flat.shape, bool)
        sel[order[flat[order] > -np.inf]] = True
        keep = sel.reshape(scores.shape)
        prev_bw = list(bw)
        if d + 1 < depth:
            bw = [max(1, int(-(-b // r))) for b, r in
                  zip(bw, [bw_ratio[d]] * D)]

    # expand kept blocks to a node mask
    mask = np.zeros([n * b for n, b in zip(keep.shape, prev_bw)], bool)
    mask_view = mask.reshape(
        [x for n, b in zip(keep.shape, prev_bw) for x in (n, b)]
    )
    mask_view[...] = keep.reshape(
        [x for n in keep.shape for x in (n, 1)]
    )
    mask = mask[tuple(slice(0, s) for s in shape)]

    # buffer zone: dilate by the final block width (reference BUFFER_ZONE
    # ring around each ROI block, set_buffer_zone)
    rad = int(buffer_radius) if buffer_radius is not None else max(prev_bw)
    for _ in range(rad):
        for d in range(D):
            mask = _dilate1(mask.astype(np.uint8), d).astype(bool)
    return mask
