"""Error-bound-driven levelwise linear quantization.

A re-design of the reference LevelwiseLinearQuantizerNDFunctor
(reference: include/mgard-x/Quantization/LinearQuantization.hpp:21-146):
one fused elementwise pass over the nested-box decomposed array that
  * looks up each node's level (max over dims of the per-axis level marks),
  * multiplies by the reciprocal per-level step (x sqrt(volume) when s!=inf),
  * rounds half-away-from-zero to an int32 symbol,
  * folds in the Huffman dictionary shift, and
  * captures outliers (|q| outside the dictionary) into a fixed-capacity
    side list (indices + int64 values), replacing them with the zero symbol.

The reference appends outliers with device-wide atomics; here we use a
deterministic masked prefix-capture (jnp.nonzero with static size), which is
reproducible run-to-run (the reference's atomic order is not).

Per-level quantizer steps arrive as a dynamic (l_target+1,) array so that
changing the tolerance or norm never retraces the XLA program.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..dtypes import OUTLIER_DTYPE, QUANTIZED_DTYPE
from ..hierarchy import Hierarchy
from .compact import masked_indices


class QuantizedResult(NamedTuple):
    quantized: jnp.ndarray  # int32, shape of input, nested-box layout
    outlier_count: jnp.ndarray  # int32 scalar (true count; may exceed capacity)
    outlier_idx: jnp.ndarray  # int64 (capacity,) flat C-order indices
    outlier_val: jnp.ndarray  # int64 (capacity,) unshifted quantized values


def node_levels(hier: Hierarchy):
    """Per-node level in the nested-box layout: max over dims of the per-axis
    level marks (reference: LinearQuantization.hpp:78-82)."""
    lvl = None
    for d in range(hier.D):
        shape = [1] * hier.D
        shape[d] = hier.shape[d]
        marks = jnp.asarray(hier.level_marks[d]).reshape(shape)
        lvl = marks if lvl is None else jnp.maximum(lvl, marks)
    return jnp.broadcast_to(lvl, hier.shape)


def _scales(hier: Hierarchy, quantizers, s_inf: bool, reciprocal: bool, dtype):
    """Per-level multiplicative factors, computed in-graph.

    quantize factor = sqrt(level volume)/q_l (volume only when s != inf);
    dequantize factor is the reciprocal (reference: LinearQuantization.hpp
    quantize `t * quantizer * volume` with reciprocal quantizers /
    dequantize `(quantizer * volume) * q` with reciprocal volumes)."""
    q = quantizers.astype(jnp.float64)
    if s_inf:
        scale = 1.0 / q if reciprocal else q
    else:
        vol = jnp.asarray(hier.vol_sqrt)
        scale = vol / q if reciprocal else q / vol
    return scale.astype(dtype)


def quantize_with_scales(
    dec,
    hier: Hierarchy,
    quantizers,
    s_inf: bool,
    prep_huffman: bool,
    dict_size: int,
    outlier_cap: int,
    step_mult=None,
) -> QuantizedResult:
    """Quantize a decomposed (nested-box) array (jit-friendly).

    step_mult: optional per-node reciprocal-step multiplier (>1 = finer
    quantization), used by ROI compression (ops/roi.py)."""
    levels = node_levels(hier)
    scale = _scales(hier, quantizers, s_inf, True, dec.dtype)[levels]
    if step_mult is not None:
        scale = scale * step_mult.astype(dec.dtype)
    t = dec * scale
    # round half away from zero, exactly as the reference:
    # copysign(0.5 + |t|, t) truncated (LinearQuantization.hpp:99-104).
    # Implemented via compare/select rather than jnp.copysign: copysign on
    # f64 lowers to a bitcast-convert s64 that XLA's x64-emulation pass
    # cannot rewrite on backends that emulate 64-bit types.
    half = jnp.asarray(0.5, dec.dtype)
    q = jnp.trunc(jnp.where(t < 0, t - half, t + half))

    shift = dict_size // 2 if prep_huffman else 0
    if prep_huffman:
        qs = q + shift
        in_range = (qs >= 0) & (qs < dict_size)
    else:
        qs = q
        in_range = jnp.abs(q) < 2**31 - 1

    flat_q = jnp.where(in_range, qs, float(shift)).ravel().astype(QUANTIZED_DTYPE)
    mask = ~in_range.ravel()
    count = mask.sum(dtype=jnp.int32)
    n = hier.total_num_elems
    # single-pass capture (jnp.nonzero's bisection lowering is slow on big
    # arrays; see ops/compact.py)
    idx = masked_indices(mask, outlier_cap, n)
    val = jnp.where(
        idx < n,
        q.ravel().astype(OUTLIER_DTYPE)[jnp.minimum(idx, n - 1)],
        0,
    )
    return QuantizedResult(
        quantized=flat_q.reshape(hier.shape),
        outlier_count=count,
        outlier_idx=idx.astype(OUTLIER_DTYPE),
        outlier_val=val,
    )


def dequantize_with_scales(
    quantized,
    hier: Hierarchy,
    quantizers,
    s_inf: bool,
    prep_huffman: bool,
    dict_size: int,
    outlier_idx=None,
    outlier_val=None,
    step_mult=None,
):
    """Inverse of quantize: restore outliers, unshift, scale back."""
    shift = dict_size // 2 if prep_huffman else 0
    work_dtype = jnp.float64 if hier.dtype == np.float64 else jnp.float32
    qflat = quantized.ravel().astype(work_dtype) - shift
    if outlier_idx is not None:
        n = hier.total_num_elems
        safe_idx = jnp.minimum(outlier_idx, n)  # cap fill entries to drop them
        qflat = qflat.at[safe_idx].set(
            outlier_val.astype(work_dtype), mode="drop", indices_are_sorted=True
        )
    levels = node_levels(hier)
    scale = _scales(hier, quantizers, s_inf, False, work_dtype)[levels]
    if step_mult is not None:
        scale = scale / step_mult.astype(work_dtype)
    return qflat.reshape(hier.shape) * scale


# ----------------------------------------------------------------------
# Dense no-outlier path (for in-stream-escape backends like BFX)
# ----------------------------------------------------------------------
def _scales_dense(hier: Hierarchy, quantizers, s_inf: bool, reciprocal: bool, dtype):
    """Per-node scale factors with no data-dependent gather.

    s = inf: the per-level steps are all equal (reference CalcQuantizers,
    LinearQuantization.hpp:234-298), so the scale is one scalar. Finite s:
    a select chain over the <= l_target+1 levels replaces the table gather
    (data-dependent gathers run far below memory-bandwidth selects)."""
    scale_tab = _scales(hier, quantizers, s_inf, reciprocal, dtype)
    if s_inf:
        return scale_tab[0]
    levels = node_levels(hier)
    scale = jnp.broadcast_to(scale_tab[0], levels.shape)
    for l in range(1, hier.l_target + 1):
        scale = jnp.where(levels == l, scale_tab[l], scale)
    return scale


def quantize_symbols(dec, hier: Hierarchy, quantizers, s_inf: bool, step_mult=None):
    """Quantize a decomposed (nested-box) array to raw int32 symbols.

    No dictionary shift and no outlier side-list: backends with in-stream
    wide-value support (BFX; escape-coded Huffman) encode any int32
    magnitude directly, removing the reference's atomic outlier capture
    (OutlierSeparatorKernel) from the hot path entirely."""
    scale = _scales_dense(hier, quantizers, s_inf, True, dec.dtype)
    if step_mult is not None:
        scale = scale * step_mult.astype(dec.dtype)
    t = dec * scale
    half = jnp.asarray(0.5, dec.dtype)
    q = jnp.trunc(jnp.where(t < 0, t - half, t + half))
    return q.astype(QUANTIZED_DTYPE)


def dequantize_symbols(sym, hier: Hierarchy, quantizers, s_inf: bool, step_mult=None):
    """Inverse of quantize_symbols (symbols -> decomposed array)."""
    work_dtype = jnp.float64 if hier.dtype == np.float64 else jnp.float32
    scale = _scales_dense(hier, quantizers, s_inf, False, work_dtype)
    if step_mult is not None:
        scale = scale / step_mult.astype(work_dtype)
    return sym.reshape(hier.shape).astype(work_dtype) * scale


# Convenience non-jit entry points used by tests (numpy quantizers).
def quantize(dec, hier, quantizers, s, prep_huffman, dict_size, outlier_capacity):
    return quantize_with_scales(
        jnp.asarray(dec), hier, jnp.asarray(np.asarray(quantizers)),
        bool(np.isinf(s)), prep_huffman, dict_size, outlier_capacity,
    )


def dequantize(quantized, hier, quantizers, s, prep_huffman, dict_size,
               outlier_idx=None, outlier_val=None):
    return dequantize_with_scales(
        jnp.asarray(quantized), hier, jnp.asarray(np.asarray(quantizers)),
        bool(np.isinf(s)), prep_huffman, dict_size,
        None if outlier_idx is None else jnp.asarray(outlier_idx),
        None if outlier_val is None else jnp.asarray(outlier_val),
    )
