"""Quantity-of-interest preserving compression.

Re-design of the reference TensorQuantityOfInterest
(reference: include/mgard/TensorQuantityOfInterest.hpp:15-42 — the operator
norm of a linear functional bounds |Q(u) - Q(u~)| by ||Q|| * ||u - u~||_s,
so compressing at tol/||Q|| preserves the QoI to tol).

For a linear functional Q(u) = sum_i w_i u_i two bounds are available:
  * Hoelder duals of the closed-form certified norms (norm()):
      s = inf (L_inf bound):  ||Q|| = sum_i |w_i|
      s = 0   (RMS bound):    ||Q|| = sqrt(N) * ||w||_2
  * the multilevel quantizer-structure bound (multilevel_factor()) — the
    per-level Riesz-representative component norms of the reference
    (TensorQuantityOfInterest.hpp:15-42) computed EXACTLY via one
    reverse-mode pass of the recompose map. Works for ANY s (finite,
    zero, or inf), with non-uniform coords and decomposed domains, and is
    several times tighter than the Hoelder dual.
compress_qoi() defaults to the multilevel bound, so arbitrary finite s is
fully supported end-to-end.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .config import Config
from .dtypes import error_bound_type
from .highlevel import compress


class TensorQuantityOfInterest:
    """Operator norm of a linear functional over a grid."""

    def __init__(self, weights):
        self.weights = np.asarray(weights, np.float64)

    def norm(self, s: float) -> float:
        """||Q|| such that |Q(e)| <= ||Q|| * ||e||_s for the framework's
        certified s-norms (s=inf: pointwise max; s=0: RMS)."""
        w = self.weights
        if math.isinf(s):
            return float(np.sum(np.abs(w)))
        if s == 0.0:
            return float(math.sqrt(w.size) * np.sqrt(np.sum(w * w)))
        raise NotImplementedError("QoI operator norms support s in {inf, 0}")

    def __call__(self, u) -> float:
        return float(np.sum(self.weights * np.asarray(u, np.float64)))

    def multilevel_factor(self, shape, s: float, config: Optional[Config] = None,
                          coords=None, weights=None) -> float:
        """Per-unit-tolerance QoI error bound from the multilevel structure.

        Sharper counterpart of the reference's Riesz-representative
        component norms (TensorQuantityOfInterest.hpp:15-42): the
        compression error is not an arbitrary s-ball element - each
        multigrid coefficient is perturbed by at most half its level's
        quantizer step q_l. Writing the reconstruction as the linear map
        R: coefficients -> field,

            |Q(u - u~)| = |<w, R c_err>| = |<R^T w, c_err>|
                       <= sum_l (q_l / 2) * || (R^T w)|_level l ||_1.

        R^T w is computed exactly with one reverse-mode pass (jax.vjp of
        recompose), and q_l = tol * f_l with known per-level factors, so
        the bound is  tol * sum_l (f_l/2) ||W_l||_1  and

            data_tol = qoi_tol / multilevel_factor.

        Works for any s (including finite) and is typically several times
        tighter than the Hoelder dual bound of norm()."""
        import jax
        import jax.numpy as jnp

        from .hierarchy import get_hierarchy
        from .ops.quantize import node_levels
        from .ops.refactor import recompose

        config = config or Config()
        coords_list = (
            [np.asarray(c, np.float64) for c in coords] if coords is not None else None
        )
        # the factor depends only on (shape, s, coords, decomposition,
        # weights) — cache it: one jax.vjp through recompose in f64 is tens
        # of seconds on CPU and the decomposed path calls this per subdomain
        w_for_key = self.weights if weights is None else np.asarray(weights, np.float64)
        key = (
            tuple(int(x) for x in shape),
            float(s),
            config.decomposition,
            tuple(c.tobytes() for c in coords_list) if coords_list else None,
            hash(w_for_key.tobytes()),
        )
        cache = getattr(self, "_mlf_cache", None)
        if cache is None:
            cache = self._mlf_cache = {}
        if key in cache:
            return cache[key]
        hier = get_hierarchy(shape, np.float64, coords_list, config)
        orthogonal = not math.isinf(s)

        def rec(c):
            return recompose(c, hier, orthogonal=orthogonal)

        w_in = self.weights if weights is None else np.asarray(weights, np.float64)
        _, vjp = jax.vjp(rec, jnp.zeros(shape, jnp.float64))
        wt = np.asarray(vjp(jnp.asarray(w_in.reshape(shape)))[0])
        levels = np.asarray(node_levels(hier))
        # per-level step factors for tol=1 (reference CalcQuantizers); the
        # quantizer rounds to nearest -> per-coefficient error <= q_l / 2
        f = hier.quantizers(
            1.0, s, 0.0, error_bound_type.ABS,
            orthogonal_projection=orthogonal,
        )
        total = 0.0
        for l in range(hier.l_target + 1):
            # finite s scales coefficients by sqrt(level volume) before
            # quantizing (ops/quantize._scales), so the per-coefficient
            # value error is q_l / (2 * vol_sqrt_l)
            step = float(f[l])
            if not math.isinf(s):
                step /= float(hier.vol_sqrt[l])
            total += 0.5 * step * float(np.abs(wt[levels == l]).sum())
        out = total * 1.0001  # float-noise safety margin
        cache[key] = out
        return out


def compress_qoi(
    data,
    qoi: TensorQuantityOfInterest,
    qoi_tol: float,
    s: float = 0.0,
    config: Optional[Config] = None,
    coords=None,
    method: str = "multilevel",
):
    """Compress so that |Q(u) - Q(u~)| <= qoi_tol for the given linear QoI.

    method="multilevel" (default) derives the field tolerance from the
    per-level quantizer structure (much tighter); method="holder" uses the
    global dual-norm bound. Returns (blob, status, data_tol)."""
    arr = np.asarray(data)
    if method == "multilevel":
        import dataclasses as _dc

        from .decomposer import DomainDecomposer
        from .dtypes import decomposition_type
        from .highlevel import adjust_shape as _adj

        cfg0 = config or Config()
        if cfg0.decomposition == decomposition_type.Hybrid:
            # the multilevel certificate is derived from the MultiDim
            # per-level quantizer structure; the Hybrid path only bounds
            # pointwise L-inf, which would silently weaken the QoI bound
            # (same fallback rule as compress_roi / compress_sharded; the
            # effective choice lands in the header)
            config = _dc.replace(cfg0, decomposition=decomposition_type.MultiDim)

        work_shape = arr.shape
        w_full = qoi.weights.reshape(arr.shape)
        if config is not None and config.adjust_shape and coords is None:
            # compress() pads with edge values; the padded nodes carry zero
            # QoI weight, so the factor over the adjusted hierarchy with
            # zero-extended weights bounds the same functional
            work_shape = _adj(arr.shape)
            if tuple(work_shape) != tuple(arr.shape):
                wz = np.zeros(work_shape, np.float64)
                wz[tuple(slice(0, t) for t in arr.shape)] = w_full
                w_full = wz
        dd = DomainDecomposer(work_shape, arr.dtype, config)
        S = dd.num_subdomains
        if S == 1:
            factor = qoi.multilevel_factor(
                work_shape, s, config, coords=coords, weights=w_full
            )
            data_tol = qoi_tol / factor
        else:
            # decomposed domain: the QoI splits as Q = sum_d Q_d over the
            # independent subdomains; compress() applies the local
            # tolerance T = tol (s=inf) or tol/sqrt(S) (finite s), so
            # |Q(e)| <= T * sum_d factor_d bounds the QoI error.
            fsum = 0.0
            for i in range(S):
                sls = dd.subdomain_slices(i)
                sub_coords = (
                    [np.asarray(c)[sl] for c, sl in zip(coords, sls)]
                    if coords is not None else None
                )
                fsum += qoi.multilevel_factor(
                    dd.subdomain_shape(i), s, config, coords=sub_coords,
                    weights=w_full[sls],
                )
            scale = 1.0 if math.isinf(s) else math.sqrt(S)
            data_tol = qoi_tol * scale / fsum
    else:
        data_tol = qoi_tol / qoi.norm(s)
    blob, st = compress(
        arr, tol=data_tol, s=s, mode=error_bound_type.ABS, config=config, coords=coords
    )
    return blob, st, data_tol
