"""Multigrid hierarchy precompute.

A re-design of the reference Hierarchy<D,T,DeviceType>
(reference: include/mgard-x/Hierarchy/Hierarchy.hpp:142-349 and
include/mgard-x/Hierarchy/Hierarchy.h:17-102): all per-level scalar tables
(level shapes, node spacing `dist`, interpolation ratios, pre-factored
tridiagonal mass-matrix coefficients am/bm, level volumes, level marks) are
computed once on host in NumPy float64 and handed to the JAX transform as
static constants, so every level's kernels compile with fully static shapes.

Level indexing matches the reference: l = 0 is the coarsest grid, l_target is
the input grid. Shape rule per level: n_{l-1} = n_l // 2 + 1
(reference: Hierarchy.hpp init(), `n = n / 2 + 1`), stopping at 2. Coarse
nodes of a size-n axis are the even indices plus, when n is even, the last
node; even axes are handled with a zero-valued virtual ghost node at the
midpoint of the last cell (reference: coord_to_dist "split the last cell in
half", Hierarchy.hpp:36-48).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np

from .config import Config
from .dtypes import data_structure_type, decomposition_type, error_bound_type

_UNLIMITED = 2**63 - 1


def level_shape_chain(n: int) -> list[int]:
    """Sizes of one axis from finest to coarsest: n, n//2+1, ..., 2."""
    if n < 2:
        raise ValueError(f"axis size must be >= 2 for hierarchy, got {n}")
    chain = []
    while n > 2:
        chain.append(n)
        n = n // 2 + 1
    chain.append(2)
    return chain


def num_coarse(n: int) -> int:
    """Number of coarse nodes of a size-n axis (= n//2 + 1)."""
    return n // 2 + 1


def _coord_to_dist(coord: np.ndarray, uniform: bool) -> np.ndarray:
    """Segment lengths of a node coordinate array.

    Returns the *extended* segment array: length n-1 for odd n, length n for
    even n (one extra segment for the virtual ghost node inserted before the
    last node). Mirrors reference coord_to_dist (Hierarchy.hpp:23-61)
    EXACTLY, including this fork's uniform/non-uniform asymmetry:
      * non-uniform: the last cell is split in half (ghost at its midpoint);
      * uniform: NO split — the dist array keeps uniform spacing and its
        trailing entry is 0, i.e. the ghost is collocated with the last
        node. In the LPK mass-trans this makes the last node's value drop
        out (all its terms multiply the zero segment) and the last coarse
        node receive exactly h/6 times its left neighbour's mass value —
        verified column-by-column against the reference SERIAL kernels
        (tests/golden/gen_golden_x.cpp probes).
    """
    n = coord.shape[0]
    h = np.diff(coord.astype(np.float64))
    if n % 2 == 0 and n != 2:
        if uniform:
            h = np.concatenate([h, [0.0]])
        else:
            last = h[-1]
            h = np.concatenate([h[:-1], [last / 2.0, last / 2.0]])
    return h


def _reduce_dist(h: np.ndarray, n_fine: int, uniform: bool) -> tuple[np.ndarray, int]:
    """Coarsen a segment array: merge fine segment pairs.

    `h` is the extended segment array of the fine grid (odd extended size).
    Returns the coarse grid's extended segment array and its physical size.
    Mirrors reference reduce_dist (Hierarchy.hpp:88-140): non-uniform merges
    true geometry then re-splits; uniform spreads the total extent evenly.
    """
    n_coarse_ = num_coarse(n_fine)
    # Physical extent: sum of segments covering the physical domain.
    # For even n the last two extended segments are the halves of the last
    # physical cell, so summing all extended segments double-counts nothing.
    phys_total = float(np.sum(h))
    if uniform:
        # even spread over the coarse cells, ghost segment 0 for even sizes
        # (reference reduce_dist uniform branch: h_dist2 zero-initialized
        # with only the first dof2-1 entries written)
        hc = np.full(n_coarse_ - 1, phys_total / (n_coarse_ - 1), dtype=np.float64)
        if n_coarse_ % 2 == 0 and n_coarse_ != 2:
            hc = np.concatenate([hc, [0.0]])
        return hc, n_coarse_
    # Non-uniform: coarse segment i spans fine segments 2i, 2i+1 of the
    # extended fine grid.
    hc = h[0::2][: n_coarse_ - 1] + h[1::2][: n_coarse_ - 1]
    if n_coarse_ % 2 == 0 and n_coarse_ != 2:
        last = hc[-1]
        hc = np.concatenate([hc[:-1], [last / 2.0, last / 2.0]])
    return hc, n_coarse_


def _calc_am_bm(n: int, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pre-factored Thomas coefficients of the 1D mass matrix h/6*[1 4 1].

    Mirrors reference calc_am_bm (Hierarchy.hpp:142-193): returns am (len n+1,
    am[0]=0=am[n]) and bm (len n+1, bm[0]=1) where bm[i+1] is the eliminated
    diagonal b'_i and am[i] the subdiagonal a_i = h[i-1]/6.
    """
    am = np.zeros(n + 1, dtype=np.float64)
    bm = np.zeros(n + 1, dtype=np.float64)
    bm[0] = 1.0
    bm[1] = 2.0 * h[0] / 6.0
    for i in range(1, n - 1):
        a_j = h[i - 1] / 6.0
        w = a_j / bm[i]
        bm[i + 1] = 2.0 * (h[i - 1] + h[i]) / 6.0 - w * a_j
        am[i] = a_j
    a_j = h[n - 2] / 6.0
    w = a_j / bm[n - 1]
    bm[n] = 2.0 * h[n - 2] / 6.0 - w * a_j
    am[n - 1] = a_j
    return am, bm


@dataclasses.dataclass(frozen=True)
class AxisLevel:
    """Per-(level, axis) tables for one coarsening step fine -> coarse.

    All arrays are host NumPy in the hierarchy's dtype; shapes are static.
    """

    n_fine: int
    n_coarse: int
    # lerp parameter t for coefficient k (fine odd node 2k+1 between coarse
    # neighbors at fine 2k, 2k+2): t = h[2k] / (h[2k] + h[2k+1]).
    lerp_t: np.ndarray  # (n_fine - n_coarse,)
    # Extended fine segment array used by mass apply / restriction.
    h_ext: np.ndarray  # (n_ext - 1,) where n_ext = n_fine (+1 if even)
    # Restriction weights onto coarse node j from fine mass values at
    # extended nodes 2j-1 / 2j+1 (0 at boundaries).
    rw_left: np.ndarray  # (n_coarse,)
    rw_right: np.ndarray  # (n_coarse,)
    # Tridiagonal solve coefficients on the coarse grid (length n_coarse):
    # forward:  y_i = d_i + fwd_f[i] * y_{i-1}
    # backward: x_i = y_i * bwd_binv[i] + bwd_g[i] * x_{i+1}
    fwd_f: np.ndarray
    bwd_binv: np.ndarray
    bwd_g: np.ndarray


class Hierarchy:
    """Precomputed multigrid hierarchy for one (shape, dtype, coords) triple."""

    def __init__(
        self,
        shape: Sequence[int],
        dtype=np.float32,
        coords: Optional[Sequence[np.ndarray]] = None,
        config: Optional[Config] = None,
    ):
        config = config or Config()
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        self.D = len(self.shape)
        if self.D < 1 or self.D > 5:
            raise ValueError(f"1..5 dimensions supported, got {self.D}")
        self.dtype = np.dtype(dtype)
        self.uniform = coords is None
        self.dstype = (
            data_structure_type.Cartesian_Grid_Uniform
            if self.uniform
            else data_structure_type.Cartesian_Grid_Non_Uniform
        )

        if coords is None:
            # Reference generates uniform coords in [0,1] when
            # normalize_coordinates (default), else 0..n-1.
            coords = []
            for n in self.shape:
                if config.normalize_coordinates:
                    coords.append(np.linspace(0.0, 1.0, n))
                else:
                    coords.append(np.arange(n, dtype=np.float64))
        self.coords = [np.asarray(c, dtype=np.float64) for c in coords]
        for d, c in enumerate(self.coords):
            if c.shape != (self.shape[d],):
                raise ValueError(
                    f"coords[{d}] has shape {c.shape}, expected ({self.shape[d]},)"
                )

        # Number of levels: all axes coarsen together; chain length is the
        # min over axes (reference: Hierarchy.hpp init()).
        chains = [level_shape_chain(n) for n in self.shape]
        nlevel = min(len(c) for c in chains)
        self.l_target = min(nlevel - 1, int(config.max_larget_level))
        L = self.l_target

        # level_shape[l][d], l = 0 (coarsest) .. L (input)
        self.level_shape: list[Tuple[int, ...]] = []
        shapes = [list(self.shape)]
        for _ in range(L):
            shapes.append([num_coarse(n) for n in shapes[-1]])
        shapes = shapes[::-1]  # index 0 = coarsest
        self.level_shape = [tuple(s) for s in shapes]

        # Per-axis segment arrays per level (extended), finest -> coarsest.
        dist_ext: list[list[np.ndarray]] = [[None] * self.D for _ in range(L + 1)]
        for d in range(self.D):
            h = _coord_to_dist(self.coords[d], self.uniform)
            n = self.shape[d]
            dist_ext[L][d] = h
            for l in range(L, 0, -1):
                h, n = _reduce_dist(h, n, self.uniform)
                dist_ext[l - 1][d] = h
        self.dist_ext = dist_ext

        # Per-level axis tables for the coarsening step l (fine) -> l-1.
        self.axis: list[list[AxisLevel]] = []  # axis[l-1][d] for step from level l
        for l in range(1, L + 1):
            row = []
            for d in range(self.D):
                row.append(self._make_axis_level(l, d))
            self.axis.append(row)

        # Level volumes: reference calc_volume spreads the physical extent
        # evenly per level (Hierarchy.hpp:196-270): vol[l][d] = extent/(n_l-1).
        self.level_volume = np.empty((L + 1, self.D), dtype=np.float64)
        for l in range(L + 1):
            for d in range(self.D):
                extent = float(np.sum(dist_ext[l][d]))
                self.level_volume[l, d] = extent / (self.level_shape[l][d] - 1)
        # sqrt of per-level node volume used by the s!=inf quantizer
        # (reference: LinearQuantization.hpp:80-92).
        self.vol_sqrt = np.sqrt(np.prod(self.level_volume, axis=1))

        # level_marks[d][i]: the level on which node index i (in the nested-box
        # layout) first exists (reference: Hierarchy.hpp level_marks block).
        self.level_marks = []
        for d in range(self.D):
            marks = np.empty(self.shape[d], dtype=np.int32)
            i = 0
            for l in range(L + 1):
                while i < self.level_shape[l][d]:
                    marks[i] = l
                    i += 1
            self.level_marks.append(marks)

        self.total_num_elems = int(np.prod(self.shape))

    def _make_axis_level(self, l: int, d: int) -> AxisLevel:
        nf = self.level_shape[l][d]
        nc = self.level_shape[l - 1][d]
        assert nc == num_coarse(nf)
        h = self.dist_ext[l][d]  # extended fine segments
        n_ext = nf + 1 if (nf % 2 == 0 and nf != 2) else nf
        assert h.shape[0] == n_ext - 1, (h.shape, nf, n_ext)

        n_coeff = nf - nc
        # lerp parameter: coefficient k lives at fine (physical==extended)
        # node 2k+1, between nodes 2k and 2k+2.
        with np.errstate(divide="ignore", invalid="ignore"):
            t = h[0 : 2 * n_coeff : 2] / (h[0 : 2 * n_coeff : 2] + h[1 : 2 * n_coeff + 1 : 2])
        t = np.nan_to_num(t, nan=0.5)

        # Restriction weights (reference LPKFunctor mass_trans r1/r4,
        # LPKFunctor.h:49-66): coarse j takes mass value at extended node
        # 2j-1 with weight h[2j-2]/(h[2j-2]+h[2j-1]) and at 2j+1 with weight
        # h[2j+1]/(h[2j]+h[2j+1]).
        rw_left = np.zeros(nc, dtype=np.float64)
        rw_right = np.zeros(nc, dtype=np.float64)
        for j in range(nc):
            if 2 * j - 1 >= 1:
                denom = h[2 * j - 2] + h[2 * j - 1]
                if denom != 0:
                    rw_left[j] = h[2 * j - 2] / denom
            if 2 * j + 1 <= n_ext - 2:
                denom = h[2 * j] + h[2 * j + 1]
                if denom != 0:
                    rw_right[j] = h[2 * j + 1] / denom

        # Tridiagonal solve coefficients on the coarse grid.
        hc = self.dist_ext[l - 1][d]
        am, bm = _calc_am_bm(nc, hc)
        fwd_f = np.zeros(nc, dtype=np.float64)
        fwd_f[1:] = -am[1:nc] / bm[1:nc]
        bwd_binv = 1.0 / bm[1 : nc + 1]
        bwd_g = -am[1 : nc + 1] / bm[1 : nc + 1]

        cast = lambda a: np.ascontiguousarray(a, dtype=self.dtype)
        return AxisLevel(
            n_fine=nf,
            n_coarse=nc,
            lerp_t=cast(t),
            h_ext=cast(h),
            rw_left=cast(rw_left),
            rw_right=cast(rw_right),
            fwd_f=cast(fwd_f),
            bwd_binv=cast(bwd_binv),
            bwd_g=cast(bwd_g),
        )

    # ------------------------------------------------------------------
    def quantizers(
        self,
        tol: float,
        s: float,
        norm: float,
        ebtype: error_bound_type,
        decomposition: decomposition_type = decomposition_type.MultiDim,
        orthogonal_projection: bool = True,
    ) -> np.ndarray:
        """Per-level quantization step sizes.

        Mirrors reference LinearQuantizer::CalcQuantizers
        (LinearQuantization.hpp:234-298) exactly: returns quantizers[l] for
        l = 0 (coarsest) .. l_target, computed in float64.
        """
        abs_tol = float(tol)
        if ebtype == error_bound_type.REL:
            abs_tol *= float(norm)
        abs_tol *= 2.0
        L = self.l_target
        q = np.empty(L + 1, dtype=np.float64)
        if math.isinf(s):
            if decomposition in (decomposition_type.MultiDim, decomposition_type.Hybrid):
                if not orthogonal_projection:
                    q[:] = abs_tol / (L + 1)
                else:
                    q[:] = abs_tol / ((L + 1) * (1 + 3.0**self.D))
            else:  # SingleDim
                q[:] = abs_tol / ((L + 1) * self.D * (1 + 3.0))
        else:
            dof = self.total_num_elems
            for l in range(L + 1):
                q[l] = abs_tol / (math.exp2(s * l) * math.sqrt(dof))
        return q

    def can_reuse(self, shape: Sequence[int]) -> bool:
        return tuple(shape) == self.shape

    def __repr__(self):
        return (
            f"Hierarchy(shape={self.shape}, dtype={self.dtype.name}, "
            f"l_target={self.l_target}, uniform={self.uniform})"
        )


@lru_cache(maxsize=64)
def _cached_uniform_hierarchy(shape: Tuple[int, ...], dtype_name: str, normalize: bool, max_level: int):
    cfg = Config()
    cfg.normalize_coordinates = normalize
    cfg.max_larget_level = max_level
    return Hierarchy(shape, np.dtype(dtype_name), None, cfg)


def get_hierarchy(
    shape: Sequence[int],
    dtype,
    coords: Optional[Sequence[np.ndarray]] = None,
    config: Optional[Config] = None,
) -> Hierarchy:
    """Hierarchy factory with a cache for uniform grids.

    Plays the role of the reference's CompressorCache hierarchy cache
    (CompressionLowLevel/CompressorCache.hpp:139): repeated compressions of
    the same shape are precompute-free.
    """
    config = config or Config()
    if coords is None:
        return _cached_uniform_hierarchy(
            tuple(int(s) for s in shape),
            np.dtype(dtype).name,
            config.normalize_coordinates,
            int(config.max_larget_level),
        )
    return Hierarchy(shape, dtype, coords, config)
