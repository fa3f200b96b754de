"""High-level compression API: mgard_tpu.compress / decompress.

Mirrors the reference's dynamic API surface and pipeline
(reference: include/compress_x.hpp:31-159, include/mgard-x/
CompressionHighLevel/CompressionHighLevel.hpp:47-667):
shape validation -> hierarchy (cached) -> norm for REL bounds ->
jitted [decompose -> quantize(+outlier capture)] -> lossless stage ->
self-describing blob (Metadata header + outliers + entropy payload).
Exceptions are translated to compress_status_type like the reference's
general_compress try/catch (CompressionHighLevel.hpp:291-309).

The device pipeline is one fused XLA program per (shape, dtype, config
signature); tolerance/norm enter as dynamic scalars so repeated calls with
different bounds never retrace.
"""

from __future__ import annotations

import math
import struct
import zlib
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .decomposer import DomainDecomposer, calc_local_abs_tol
from .dtypes import (
    MAX_DIM,
    compress_status_type,
    compressor_type,
    data_structure_type,
    data_type,
    decomposition_type,
    dtype_enum,
    error_bound_type,
    lossless_type,
    norm_type,
    np_dtype,
)
from .formats.metadata import FormatError, Metadata
from .hierarchy import Hierarchy, get_hierarchy
from .lossless import lossless_compress, lossless_decompress
from .lossless.huffman import device_get_prefix
from .ops import quantize as Q
from .ops.refactor import (
    decompose,
    decompose_single,
    recompose,
    recompose_single,
)


def adjust_shape(shape):
    """ShapeAdjustment (reference: CompressionHighLevel/
    ShapeAdjustment.hpp:43): pad each axis to a hierarchy-friendly size.
    Rule: the next 2^k+1 when that costs <= 12.5% growth (perfect dyadic
    chains), else the next multiple of 8 (keeps the hybrid/BFX tiling
    aligned). Padding uses edge values; the original shape is recorded in
    the header and restored on decompression."""
    out = []
    for n in shape:
        if n <= 3:
            out.append(n)
            continue
        k = (n - 2).bit_length()
        dyadic = (1 << k) + 1
        if dyadic >= n and dyadic <= int(n * 1.125) + 1:
            out.append(dyadic)
        else:
            out.append((n + 7) // 8 * 8)
    return tuple(out)


def _hybrid_worthwhile(shape) -> bool:
    """Hybrid (blockwise 8^3) refactoring pays off when the x8 padding is
    cheap and the array is large enough to amortize the remainder stage."""
    import numpy as _np

    padded = [(s + 7) // 8 * 8 for s in shape]
    pad_factor = float(_np.prod([p / s for p, s in zip(padded, shape)]))
    return pad_factor <= 1.25 and int(_np.prod(shape)) >= (1 << 18)


def infer_orthogonal_projection(s: float) -> bool:
    """Hierarchical fast path for L-infinity bounds (reference:
    Compressor.hpp:229-236): s == inf skips the mass-matrix correction and
    the quantizer widens accordingly."""
    return not math.isinf(s)


def _prep_huffman(config: Config) -> bool:
    # reference: LinearQuantization.hpp:321-327
    return config.lossless not in (
        lossless_type.CPU_Lossless,
        lossless_type.BlockDelta,
        lossless_type.LZ4,
        lossless_type.BFX,
        lossless_type.BFX_Zstd,
        lossless_type.BFP,
        lossless_type.BFP_Zstd,
    )


def _outlier_cap(n: int, config: Config) -> int:
    """Initial outlier-capture capacity: the configured capacity ratio
    scaled by the user's outlier-ratio estimate (reference:
    Config.estimate_outlier_ratio, used for buffer sizing)."""
    frac = config.outlier_capacity_ratio * max(config.estimate_outlier_ratio, 1e-3)
    return min(max(4096, int(n * frac)), n)


def _raw_symbol_backend(lt: lossless_type) -> bool:
    """Backends that take raw signed int32 symbols of any magnitude
    (in-stream wide-value support), so quantization needs neither the
    dictionary shift nor the outlier side-list."""
    return lt in (
        lossless_type.BFX,
        lossless_type.BFX_Zstd,
        lossless_type.BFP,
        lossless_type.BFP_Zstd,
    )


def _raw_codec(lt: lossless_type):
    """The device codec module + zstd-stage flag for a raw-symbol backend."""
    if lt in (lossless_type.BFP, lossless_type.BFP_Zstd):
        from .lossless import bfp as mod
    else:
        from .lossless import bfx as mod
    return mod, lt in (lossless_type.BFX_Zstd, lossless_type.BFP_Zstd)


def _effective_raw_lt(lt: lossless_type, n: int) -> lossless_type:
    """BFP pays its chunk-max width granularity for superblock-scale
    sorted-prefix packing; below SB_LARGE_MIN superblock blocks it loses
    ratio against BFX, so small streams fall back. The per-section backend
    id (lossless/registry.py) keeps every blob self-describing, so this is
    invisible to decompression."""
    from .lossless import bfp as _bfp

    if lt == lossless_type.BFP and n < _bfp.SB_LARGE_MIN * 32:
        return lossless_type.BFX
    if lt == lossless_type.BFP_Zstd and n < _bfp.SB_LARGE_MIN * 32:
        return lossless_type.BFX_Zstd
    return lt


# ----------------------------------------------------------------------
# Jitted cores
# ----------------------------------------------------------------------
@partial(jax.jit, static_argnames=("s_inf", "normalize"))
def _norm_kernel(v, s_inf: bool, normalize: bool):
    if s_inf:
        return jnp.max(jnp.abs(v))
    acc = jnp.sum(v.astype(jnp.float64) ** 2)
    if normalize:
        acc = acc / v.size
    return jnp.sqrt(acc).astype(v.dtype)


def calculate_norm(v, s: float, normalize: bool) -> float:
    n = float(_norm_kernel(v, math.isinf(s), normalize))
    if n == 0.0:
        n = float(np.finfo(np.asarray(v).dtype).eps)
    return n


@partial(
    jax.jit,
    static_argnames=(
        "hier", "orthogonal", "prep_huffman", "dict_size", "outlier_cap", "s_inf", "single_dim",
    ),
)
def _compress_core(
    v, quantizers, hier, orthogonal, prep_huffman, dict_size, outlier_cap, s_inf,
    single_dim=False,
):
    dec = (decompose_single if single_dim else decompose)(v, hier, orthogonal)
    return Q.quantize_with_scales(
        dec, hier, quantizers, s_inf, prep_huffman, dict_size, outlier_cap
    )


@partial(
    jax.jit,
    static_argnames=("hier", "orthogonal", "prep_huffman", "dict_size", "s_inf", "single_dim"),
)
def _decompress_core(
    qflat, quantizers, outlier_idx, outlier_val, hier, orthogonal, prep_huffman, dict_size, s_inf,
    single_dim=False,
):
    dec = Q.dequantize_with_scales(
        qflat, hier, quantizers, s_inf, prep_huffman, dict_size, outlier_idx, outlier_val
    )
    return (recompose_single if single_dim else recompose)(dec, hier, orthogonal)


@partial(
    jax.jit,
    static_argnames=("hier", "orthogonal", "s_inf", "single_dim"),
)
def _compress_core_sym(v, quantizers, hier, orthogonal, s_inf, single_dim=False,
                       step_mult=None):
    """Raw-symbol compress core (no outlier capture, no dictionary shift):
    the dense path for BFX-class backends."""
    dec = (decompose_single if single_dim else decompose)(v, hier, orthogonal)
    return Q.quantize_symbols(dec, hier, quantizers, s_inf, step_mult=step_mult)


@partial(
    jax.jit,
    static_argnames=("hier", "orthogonal", "s_inf", "single_dim"),
)
def _decompress_core_sym(sym, quantizers, hier, orthogonal, s_inf, single_dim=False,
                         step_mult=None):
    dec = Q.dequantize_symbols(sym, hier, quantizers, s_inf, step_mult=step_mult)
    return (recompose_single if single_dim else recompose)(dec, hier, orthogonal)


# ----------------------------------------------------------------------
# Hybrid (blockwise 8^3 local + global remainder) cores
# (reference: HybridHierarchyCompressor.hpp; see ops/hybrid.py)
# ----------------------------------------------------------------------
def _hybrid_quantizer(abs_tol: float, l_total: int) -> float:
    # hierarchical s=inf rule with the hybrid level count
    # (reference: LinearQuantization.hpp:234-298)
    return 2.0 * abs_tol / (l_total + 1)


def _pick_v2_chunk(padded, config: Config) -> int:
    """Sort-chunk size for the v2 front-end: an explicit Config.bfp_chunk
    wins; otherwise the largest C (up to 16) whose (C*32)-element chunk
    rows tile the last axis exactly: larger chunks mean fewer, wider
    sort-gather rows at a small ratio cost."""
    C = int(getattr(config, "bfp_chunk", 0) or 0)
    if C:
        return C
    from .lossless import bfp as _bfp

    for cand in (16, 8, 4, 2):
        if padded[-1] % (cand * 32) == 0 and _bfp.SB_BLOCKS % (cand * _bfp.LANES) == 0:
            return cand
    return 1


def _v2_sb(config: Config, n_cf: int, C: int) -> int:
    """Effective BFP superblock for the v2 cf stream: an explicitly-set /
    autotuned Config.bfp_sb_blocks wins when the stream admits it (the
    format records sb, so any choice decodes everywhere); otherwise the
    production default."""
    from .lossless import bfp as _bfp

    sb = int(getattr(config, "bfp_sb_blocks", 0) or 0)
    if (sb >= _bfp.SB_LARGE_MIN and n_cf % (sb * 32) == 0
            and sb % (C * _bfp.LANES) == 0):
        return sb
    return _bfp.SB_BLOCKS


def _hybrid_v2_ok(padded, dtype, config: Config) -> bool:
    """Gate for the one-pass cf front-end (ops/hybrid.py
    local_transform_v2_xla + lossless/bfp.py prepared-payload cores): the
    shapes the flag-1 stream format admits. An explicit Config.bfp_chunk
    that breaks the layout invariants fails the gate (clean flag-0
    fallback) instead of crashing inside the encoder."""
    from .lossless import bfp as _bfp

    C = _pick_v2_chunk(padded, config)
    n_cf = int(np.prod(padded))
    sb = _v2_sb(config, n_cf, C)
    return (
        len(padded) == 3
        and np.dtype(dtype) == np.float32
        and config.lossless == lossless_type.BFP
        and bool(config.hybrid_level_grouping)
        and C >= 1
        and padded[-1] % (C * 32) == 0
        and sb % (C * _bfp.LANES) == 0
        and n_cf % (sb * 32) == 0
    )


@partial(jax.jit, static_argnames=("shape", "padded", "nl", "rem_hier",
                                   "K", "E"))
def _decompress_core_hybrid_v3(base, crl, resid, rem_sym, q_scalar, shape,
                               padded, nl, rem_hier, K, E):
    """v3 (flag-2) inverse: static-slot banded payload + rem symbols ->
    field."""
    from .ops import hybrid as Hy

    work = jnp.float32
    q = q_scalar.astype(work)
    rem_dec = (rem_sym.astype(work) * q).reshape(rem_hier.shape)
    rem = recompose(rem_dec, rem_hier, orthogonal=False)
    out = Hy.unpack_inverse_v3_xla(base, crl, resid, rem, q, nl, K, E,
                                   work, padded)
    return out[tuple(slice(0, s) for s in shape)]


@partial(jax.jit, static_argnames=("padded", "nl", "rem_hier", "C"))
def _compress_core_hybrid_v2(v, q_scalar, padded, nl, rem_hier, C):
    """One-pass hybrid front-end: returns (payload u16 [grouped zigzag cf
    symbols], cw (NC,) i32 [true chunk widths], rem_sym (n_rem,) i32)."""
    from .ops import hybrid as Hy

    pad = [(0, p - s) for s, p in zip(v.shape, padded)]
    if any(p for _, p in pad):
        v = jnp.pad(v, pad, mode="edge")
    inv_q = (1.0 / q_scalar).astype(v.dtype)
    pay, cw, rem = Hy.local_transform_v2_xla(v, inv_q, nl, C)
    rem_dec = decompose(rem, rem_hier, orthogonal=False)
    half = jnp.asarray(0.5, v.dtype)
    t = rem_dec * inv_q
    rem_sym = jnp.trunc(jnp.where(t < 0, t - half, t + half)).astype(jnp.int32)
    return pay, cw, rem_sym.ravel()


@partial(jax.jit, static_argnames=("shape", "padded", "nl", "rem_hier", "C"))
def _decompress_core_hybrid_v2(zz_rows, rem_sym, q_scalar, shape, padded, nl,
                               rem_hier, C):
    """Inverse: u16 grouped zigzag rows + rem symbols -> field."""
    from .ops import hybrid as Hy

    work = jnp.float32
    q = q_scalar.astype(work)
    rem_dec = (rem_sym.astype(work) * q).reshape(rem_hier.shape)
    rem = recompose(rem_dec, rem_hier, orthogonal=False)
    pay = zz_rows.reshape(padded)
    out = Hy.local_inverse_v2_xla(pay, rem, q, nl, work)
    return out[tuple(slice(0, s) for s in shape)]


@partial(jax.jit, static_argnames=("padded", "nl", "rem_hier", "zgroup"))
def _compress_core_hybrid(v, q_scalar, padded, nl, rem_hier, zgroup=False):
    from .ops import hybrid as Hy

    pad = [(0, p - s) for s, p in zip(v.shape, padded)]
    if any(p for _, p in pad):
        v = jnp.pad(v, pad, mode="edge")
    inv_q = (1.0 / q_scalar).astype(v.dtype)
    half = jnp.asarray(0.5, v.dtype)

    def quant(x):
        t = x * inv_q
        return jnp.trunc(jnp.where(t < 0, t - half, t + half)).astype(jnp.int32)

    dec = Hy.local_decompose(v, nl)
    rem = Hy.extract_remainder(dec, nl)
    cf = jnp.where(Hy.corner_mask(dec.shape, nl), jnp.zeros((), dec.dtype), dec)
    rem_dec = decompose(rem, rem_hier, orthogonal=False)
    cf_sym = quant(cf)
    if zgroup:
        cf_sym = Hy.zclass_group(cf_sym)
    return jnp.concatenate([cf_sym.ravel(), quant(rem_dec).ravel()])


@partial(jax.jit, static_argnames=("shape", "padded", "nl", "rem_hier", "zgroup"))
def _decompress_core_hybrid(sym, q_scalar, shape, padded, nl, rem_hier,
                            zgroup=False):
    from .ops import hybrid as Hy

    work = jnp.float64 if rem_hier.dtype == np.float64 else jnp.float32
    n_cf = int(np.prod(padded))
    q = q_scalar.astype(work)
    rem_dec = (sym[n_cf:].astype(work) * q).reshape(rem_hier.shape)
    rem = recompose(rem_dec, rem_hier, orthogonal=False)
    cf_sym = sym[:n_cf].reshape(padded)
    if zgroup:
        cf_sym = Hy.zclass_ungroup(cf_sym)
    cf = cf_sym.astype(work) * q
    dec = Hy.insert_remainder(cf, rem.astype(work), nl)
    out = Hy.local_recompose(dec, nl)
    return out[tuple(slice(0, s) for s in shape)]


# ----------------------------------------------------------------------
# Payload helpers
# ----------------------------------------------------------------------
def _serialize_outliers(count: int, idx, val) -> bytes:
    idx_h = device_get_prefix(idx, count).astype("<i8")
    val_h = device_get_prefix(val, count).astype("<i8")
    # delta-encode sorted indices for compressibility
    if count:
        idx_d = np.diff(idx_h, prepend=np.int64(0))
    else:
        idx_d = idx_h
    iz = zlib.compress(idx_d.tobytes(), 3)
    vz = zlib.compress(val_h.tobytes(), 3)
    return struct.pack("<QQQ", count, len(iz), len(vz)) + iz + vz


def _deserialize_outliers(data: bytes, offset: int):
    count, ni, nv = struct.unpack_from("<QQQ", data, offset)
    p = offset + 24
    idx_d = np.frombuffer(zlib.decompress(data[p : p + ni]), dtype="<i8")
    p += ni
    val = np.frombuffer(zlib.decompress(data[p : p + nv]), dtype="<i8")
    p += nv
    idx = np.cumsum(idx_d).astype(np.int64) if count else idx_d.astype(np.int64)
    return idx, val.astype(np.int64), p - offset


# ----------------------------------------------------------------------
# Public API
# ----------------------------------------------------------------------
_EMPTY_OUTLIERS = None


def _empty_outliers() -> bytes:
    global _EMPTY_OUTLIERS
    if _EMPTY_OUTLIERS is None:
        _EMPTY_OUTLIERS = _serialize_outliers(
            0, np.zeros(0, np.int64), np.zeros(0, np.int64)
        )
    return _EMPTY_OUTLIERS


def _dispatch_subdomain(
    v,
    hier: Hierarchy,
    config: Config,
    abs_tol: float,
    s: float,
    orthogonal: bool,
    prep: bool,
):
    """Device phase: dispatch the subdomain's whole device pipeline with NO
    host synchronization, returning an opaque state for
    _serialize_subdomain. The caller overlaps subdomain i+1's dispatch with
    subdomain i's serialization - the role of the reference's
    double-buffered GPU pipeline (GPUPipelines.hpp:70-160), using XLA's
    async dispatch instead of explicit queues."""
    s_inf = math.isinf(s)
    quantizers = hier.quantizers(
        abs_tol, s, 0.0, error_bound_type.ABS, config.decomposition, orthogonal
    )
    single_dim = config.decomposition == decomposition_type.SingleDim
    raw = _raw_symbol_backend(config.lossless)
    if config.decomposition == decomposition_type.Hybrid and s_inf and raw:
        from .ops.hybrid import hybrid_l_total, pad_to8, remainder_shape

        nl = max(1, min(3, int(config.num_local_refactoring_level)))
        padded = pad_to8(hier.shape)
        rem_hier = get_hierarchy(
            remainder_shape(padded, nl), hier.dtype, None, config
        )
        q = _hybrid_quantizer(abs_tol, hybrid_l_total(padded, nl, rem_hier))
        if _hybrid_v2_ok(padded, hier.dtype, config):
            C = _pick_v2_chunk(padded, config)
            pay, cw, rem_sym = _compress_core_hybrid_v2(
                v, jnp.asarray(q, hier.dtype), padded, nl, rem_hier, C
            )
            rem_state = _raw_encode_device(rem_sym, config)
            return ("hybrid_v2",
                    (pay, cw, rem_state, v, hier, q, padded, nl, rem_hier, C))
        sym = _compress_core_hybrid(
            v, jnp.asarray(q, hier.dtype), padded, nl, rem_hier,
            zgroup=bool(config.hybrid_level_grouping),
        )
        return ("hybrid_raw", _raw_encode_device(sym, config))
    if raw:
        sym = _compress_core_sym(
            v, jnp.asarray(quantizers), hier, orthogonal, s_inf, single_dim
        )
        return ("raw", _raw_encode_device(sym.ravel(), config))
    return ("generic", v, hier, quantizers, single_dim)


def _raw_encode_device(sym, config: Config):
    """Returns (effective lossless id, opaque device state)."""
    lt = _effective_raw_lt(config.lossless, int(sym.shape[0]))
    mod, _ = _raw_codec(lt)
    from .lossless import bfp as _bfp

    if mod is _bfp:
        return lt, mod.encode_device(sym, config)
    return lt, mod.encode_device(sym, getattr(config, "bfx_sb_blocks", None))


def _raw_section_parts(lt_eff, dev_state, config: Config) -> list:
    from .lossless.registry import _HDR as _LHDR
    from .utils.bytesink import parts_size

    mod, zstd_stage = _raw_codec(lt_eff)
    if zstd_stage:
        from .lossless import host as _host

        inner = _host.zstd_compress(
            mod.serialize_device(dev_state), config.zstd_compress_level
        )
        return [struct.pack(_LHDR, int(lt_eff), len(inner)), inner]
    parts = (mod.serialize_device_parts(dev_state)
             if hasattr(mod, "serialize_device_parts")
             else [mod.serialize_device(dev_state)])
    return [struct.pack(_LHDR, int(lt_eff), parts_size(parts))] + parts


def _raw_section(lt_eff, dev_state, config: Config) -> bytes:
    from .utils.bytesink import join

    return join(_raw_section_parts(lt_eff, dev_state, config))


def _serialize_hybrid_v2(st, config: Config) -> list:
    """Serialize the one-pass hybrid front-end as bytesink parts: flag
    byte 1, cf stream as a prepared BFP5 blob, rem stream as a standard
    lossless section. Falls back to the legacy single-stream layout
    (flag 0) when the chunk widths exceed the u16 budget (K+E > 16 or an
    over-wide chunk)."""
    from .lossless import bfp as _bfp
    from .utils.bytesink import parts_size

    pay, cw, rem_state, v, hier, q, padded, nl, rem_hier, C = st
    E = int(getattr(config, "bfp_resid_planes", 0) or _bfp.E_DEFAULT)
    if not 1 <= E <= 15:
        # residual lengths are serialized as 4-bit nibbles (same contract
        # encode_device enforces); E=16 would silently corrupt the sidecar
        raise ValueError(f"bfp_resid_planes must be in [1, 15], got {E}")
    n_cf = int(np.prod(padded))
    K_cfg = int(getattr(config, "bfp_base_planes", 0) or 0)
    key = ("v2", n_cf, E, C, K_cfg)
    cw_h = None
    if K_cfg:
        # explicitly-set / autotuned base-plane count wins; an undersized K
        # falls back to the legacy path via the cw_max check below
        K = K_cfg
    elif key in _bfp._K_CACHE:
        K, cw_max_known = _bfp._K_CACHE[key]
    else:
        cw_h = np.asarray(cw)
        hist = np.bincount(np.clip(cw_h, 0, 32), minlength=33)
        K = _bfp.choose_K(hist, E, C)
        _bfp._K_CACHE[key] = (K, None)
    # cw are TRUE u32 widths: any chunk wider than K+E (or 16)
    # would have been truncated by the u16 payload -> legacy path
    cw_h = np.asarray(cw) if cw_h is None else cw_h
    cw_max = int(cw_h.max())
    if not K_cfg and (cw_max > K + E or K + E > 16) and cw_max <= 16:
        # a STALE sticky K (chosen for another tolerance or field of this
        # shape) undersizes the current stream's widths or overruns the
        # u16 budget; re-choose from the already-synced widths and refresh
        # the cache instead of dropping to the legacy path (tol changes on
        # one shape must not cost the fast format)
        hist = np.bincount(np.clip(cw_h, 0, 32), minlength=33)
        # clamp into [cw_max - E, 16 - E]: the lower end keeps the stream
        # exception-free, the upper end keeps the u16 payload budget
        K = min(max(_bfp.choose_K(hist, E, C), cw_max - E), 16 - E)
        _bfp._K_CACHE[key] = (K, None)
    if K + E > 16 or cw_max > K + E:
        sym = _compress_core_hybrid(
            v, jnp.asarray(q, hier.dtype), padded, nl, rem_hier,
            zgroup=bool(config.hybrid_level_grouping),
        )
        lt_eff, dev_state = _raw_encode_device(sym, config)
        return ([_empty_outliers() + struct.pack("<B", 0)]
                + _raw_section_parts(lt_eff, dev_state, config))
    crl = jnp.clip(cw - K, 0, E)
    # superblock for v2: an autotuned/explicit bfp_sb_blocks wins when the
    # stream admits it (the _hybrid_v2_ok gate re-checks the same rule, and
    # sb is recorded in the blob so any choice decodes everywhere)
    sb = _v2_sb(config, n_cf, C)
    out = _bfp.encode_core_zz(pay.reshape(-1, C * 32), crl, K, E, sb, C)
    cf_parts = _bfp.serialize_prepared_parts(n_cf, K, E, sb, C, crl, *out)
    rem_parts = _raw_section_parts(rem_state[0], rem_state[1], config)
    return ([_empty_outliers() + struct.pack("<B", 1)
             + struct.pack("<Q", parts_size(cf_parts))]
            + cf_parts + rem_parts)


def _serialize_subdomain(state, config: Config, abs_tol: float, s: float,
                         orthogonal: bool, prep: bool) -> list:
    """Host phase: sync the dispatched state and build the payload as
    bytesink parts (the top-level assembly writes each byte once)."""
    if state[0] == "hybrid_v2":
        return _serialize_hybrid_v2(state[1], config)
    if state[0] == "hybrid_raw":
        lt_eff, dev_state = state[1]
        return ([_empty_outliers() + struct.pack("<B", 0)]
                + _raw_section_parts(lt_eff, dev_state, config))
    if state[0] == "raw":
        lt_eff, dev_state = state[1]
        return [_empty_outliers()] + _raw_section_parts(
            lt_eff, dev_state, config
        )
    _, v, hier, quantizers, single_dim = state
    return [_compress_subdomain_generic(
        v, hier, config, quantizers, s, orthogonal, prep, single_dim
    )]


def _compress_subdomain(
    v,
    hier: Hierarchy,
    config: Config,
    abs_tol: float,
    s: float,
    orthogonal: bool,
    prep: bool,
) -> bytes:
    """Compress one device-resident subdomain to a payload section
    (outliers + lossless stage). Plays the role of Compressor::Compress
    (reference: Compressor.hpp:205-252) for one DomainDecomposer subdomain."""
    from .utils.bytesink import join

    state = _dispatch_subdomain(v, hier, config, abs_tol, s, orthogonal, prep)
    return join(
        _serialize_subdomain(state, config, abs_tol, s, orthogonal, prep)
    )


def _compress_subdomain_generic(
    v,
    hier: Hierarchy,
    config: Config,
    quantizers,
    s: float,
    orthogonal: bool,
    prep: bool,
    single_dim: bool,
) -> bytes:
    s_inf = math.isinf(s)
    n = hier.total_num_elems
    cap = _outlier_cap(n, config)
    qres = _compress_core(
        v, jnp.asarray(quantizers), hier, orthogonal, prep,
        int(config.huff_dict_size), cap, s_inf, single_dim,
    )
    count = int(qres.outlier_count)
    if count > cap:
        # Bucketed capacity ladder: re-trace once with the count rounded up
        # to the next power-of-two bucket (never a full-n capture buffer;
        # the true count is already known from the first pass). Replaces the
        # reference's dynamic atomic-append outlier list
        # (OutlierSeparatorKernel) without unbounded recompiles.
        cap2 = min(1 << (count - 1).bit_length(), n)
        qres = _compress_core(
            v, jnp.asarray(quantizers), hier, orthogonal, prep,
            int(config.huff_dict_size), cap2, s_inf, single_dim,
        )
        count = int(qres.outlier_count)
    section = _serialize_outliers(count, qres.outlier_idx, qres.outlier_val)
    section += lossless_compress(qres.quantized.ravel(), config)
    return section


def compress(
    data,
    tol: float,
    s: float = math.inf,
    mode: error_bound_type = error_bound_type.ABS,
    config: Optional[Config] = None,
    coords: Optional[Sequence[np.ndarray]] = None,
    _demote_src=None,
) -> Tuple[bytes, compress_status_type]:
    """Compress a 1D-5D float32/float64 array under an error bound.

    Returns (blob, status). Mirrors mgard_x::compress
    (reference: compress_x.hpp:31-107), including automatic domain
    decomposition for larger-than-memory inputs
    (reference: CompressionHighLevel.hpp:47-283).
    """
    config = config or Config()
    from .utils.log import Timer, log

    log.level = max(log.level, int(config.log_level)) if config.log_level else log.level
    t_total = Timer()
    t_total.start()
    try:
        arr = data if isinstance(data, jax.Array) else np.asarray(data)
        if arr.ndim < 1 or arr.ndim > MAX_DIM:
            return b"", compress_status_type.NotSupportHigherNumberOfDimensionsFailure
        try:
            dt = dtype_enum(arr.dtype)
        except TypeError:
            return b"", compress_status_type.NotSupportDataTypeFailure

        shape = tuple(int(x) for x in arr.shape)
        s_inf = math.isinf(s)
        orthogonal = infer_orthogonal_projection(s)
        prep = _prep_huffman(config)

        if (
            _demote_src is None
            and np.dtype(arr.dtype) == np.float64
            and s_inf
            and config.compressor == compressor_type.MGARD
            and bool(config.f64_demote)
        ):
            # f64 fast path (certified precision demotion): when the L-inf
            # budget covers the exact f64->f32 cast error, compress the f32
            # image through the flagship pipeline with the cast error
            # deducted from the tolerance. |out - u| <= (tol_abs - e_c) +
            # e_c = tol_abs, so the user's bound holds on the DOUBLE data.
            # The demotion was designed for a device whose f64 is an
            # emulated f32 pair; it halves the bytes every stage moves on
            # any device (the reference instantiates double natively:
            # compress_x.hpp:31-159).
            a64 = jnp.asarray(arr)
            u32 = a64.astype(jnp.float32)
            e_c = float(jnp.max(jnp.abs(a64 - u32.astype(jnp.float64))))
            if mode == error_bound_type.REL:
                abs_tol = float(tol) * float(jnp.max(jnp.abs(a64)))
            else:
                abs_tol = float(tol)
            if (
                math.isfinite(abs_tol)
                and math.isfinite(e_c)
                and abs_tol > 0.0
                and e_c <= 0.25 * abs_tol
            ):
                # 1e-9 relative cushion absorbs the (tiny) rounding of the
                # device e_c reduction itself
                rtol = abs_tol - e_c * (1.0 + 1e-9)
                return compress(
                    u32, rtol, s, error_bound_type.ABS, config, coords,
                    _demote_src=dt,
                )
            # budget too tight for demotion: native f64 transform below

        if config.autotune_lookup:
            # consult the persistent per-(platform, dtype, size) tuner table
            # (reference: AutoTuningTable lookup, AutoTuner.h:46-118) on a
            # copy so the caller's Config is never mutated
            import dataclasses as _dc

            config = _dc.replace(config).apply_autotune(shape, arr.dtype)

        if config.decomposition == decomposition_type.Hybrid and not _hybrid_worthwhile(shape):
            # Hybrid pads every axis to x8 (reference: shapes padded to x8,
            # HybridHierarchyDataRefactor.hpp:21-58); on small or awkward
            # shapes the padding eats the ratio, so fall back to the
            # MultiDim transform. The effective choice lands in the header,
            # so decompression needs no knowledge of this rule.
            import dataclasses as _dc

            config = _dc.replace(config, decomposition=decomposition_type.MultiDim)

        if config.compressor == compressor_type.ZFP:
            return _compress_zfp_path(arr, tol, s, mode, config, dt, shape)

        if coords is None and not s_inf and s < 0:
            # Negative-s bounds on uniform grids route through the
            # geometry-TRUE (non-uniform) dist chain. The uniform chain
            # re-spreads coarse spacing evenly on even axes (reference
            # reduce_dist uniform branch, Hierarchy.hpp:88-140) — a
            # transition-stencil approximation under which the achieved
            # error, measured in the true-mesh s-norm (ops/norms.py),
            # exceeds tol by up to ~3.8x at s=-1.5 on even shapes; with
            # true geometry the bound holds with margin (measured 0.73
            # worst over s in {-1.5,-1,-0.5} x tol {1e-1..1e-3}, 34^2).
            # Positive/zero s and L-inf are insensitive to the convention.
            coords = [
                np.linspace(0.0, 1.0, n) if config.normalize_coordinates
                else np.arange(n, dtype=np.float64)
                for n in shape
            ]

        adjusted = False
        if config.adjust_shape and coords is None:
            new_shape = adjust_shape(shape)
            if new_shape != shape:
                arr = np.pad(
                    np.asarray(arr),
                    [(0, a - b) for b, a in zip(shape, new_shape)],
                    mode="edge",
                )
                adjusted = True

        dd = DomainDecomposer(arr.shape, arr.dtype, config)
        S = dd.num_subdomains

        # Global norm (REL): max / sum-of-squares over subdomains
        # (reference: calc_norm_decomposed_w_prefetch).
        t_norm = Timer()
        t_norm.start()
        norm = 0.0
        if mode == error_bound_type.REL:
            if S == 1:
                norm = calculate_norm(jnp.asarray(arr), s, config.normalize_coordinates)
            else:
                acc = 0.0
                for i in range(S):
                    sub = jnp.asarray(arr[dd.subdomain_slices(i)])
                    if s_inf:
                        acc = max(acc, float(_norm_kernel(sub, True, False)))
                    else:
                        acc += float(_norm_kernel(sub, False, False)) ** 2
                if s_inf:
                    norm = acc
                elif config.normalize_coordinates:
                    norm = math.sqrt(acc / int(np.prod(shape)))
                else:
                    norm = math.sqrt(acc)
                if norm == 0.0:
                    norm = float(np.finfo(arr.dtype).eps)

        t_norm.end()
        t_norm.print("calc-norm", int(np.prod(shape)) * arr.dtype.itemsize
                     if mode == error_bound_type.REL else None)
        local_tol = calc_local_abs_tol(mode, norm, tol, s, S)

        t_comp = Timer()
        t_comp.start()
        sections = []
        coords_list = (
            [np.asarray(c, np.float64) for c in coords] if coords is not None else None
        )
        # Double-buffered subdomain overlap (reference: GPUPipelines.hpp
        # prefetch of subdomain i+1 while i compresses): dispatch the next
        # subdomain's device pipeline before serializing (syncing) the
        # current one. config.prefetch gates the overlap.
        depth = 2 if (config.prefetch and S > 1) else 1
        pending = []

        def dispatch(i):
            sls = dd.subdomain_slices(i)
            sub_coords = (
                [c[sl] for c, sl in zip(coords_list, sls)] if coords_list else None
            )
            hier = get_hierarchy(dd.subdomain_shape(i), arr.dtype, sub_coords, config)
            v = jnp.asarray(arr[sls]) if not isinstance(arr, jax.Array) else arr[sls]
            return _dispatch_subdomain(
                v, hier, config, local_tol, s, orthogonal, prep
            )

        for i in range(min(depth, S)):
            pending.append(dispatch(i))
        nxt = len(pending)
        for i in range(S):
            state = pending.pop(0)
            if nxt < S:
                pending.append(dispatch(nxt))
                nxt += 1
            sections.append(
                _serialize_subdomain(state, config, local_tol, s, orthogonal, prep)
            )
        t_comp.end()
        t_comp.print("decompose+quantize+lossless",
                     int(np.prod(shape)) * arr.dtype.itemsize)

        from .utils.bytesink import join as _join, parts_size as _psize

        payload_parts = []
        for sec in sections:
            payload_parts.append(struct.pack("<Q", _psize(sec)))
            payload_parts.extend(sec)

        var_sizes = ()
        from .dtypes import domain_decomposition_type as _ddt

        if dd.domain_decomposed and config.domain_decomposition == _ddt.Variable:
            var_sizes = tuple(
                dd.subdomain_shape(i)[dd.domain_decomposed_dim] for i in range(S)
            )

        # l_target recorded from the first subdomain's hierarchy
        first_hier = get_hierarchy(
            dd.subdomain_shape(0),
            arr.dtype,
            [c[sl] for c, sl in zip(coords_list, dd.subdomain_slices(0))]
            if coords_list
            else None,
            config,
        )
        meta = Metadata(
            dtype=dt if _demote_src is None else _demote_src,
            demoted=_demote_src is not None,
            shape=shape,
            dstype=(
                data_structure_type.Cartesian_Grid_Uniform
                if coords is None
                else data_structure_type.Cartesian_Grid_Non_Uniform
            ),
            coords=coords_list,
            decomposition=config.decomposition,
            l_target=first_hier.l_target,
            reorder=config.reorder,
            hybrid_grouping=(
                config.decomposition == decomposition_type.Hybrid
                and bool(config.hybrid_level_grouping)
            ),
            domain_decomposed=dd.domain_decomposed,
            ddtype=config.domain_decomposition,
            domain_decomposed_dim=dd.domain_decomposed_dim,
            domain_decomposed_size=dd.domain_decomposed_size,
            dd_variable_sizes=var_sizes,
            ebtype=mode,
            norm=norm,
            tol=float(tol),
            ntype=norm_type.L_Inf if s_inf else norm_type.L_2,
            s=float(s),
            ltype=config.lossless,
            huff_dict_size=config.huff_dict_size,
            huff_block_size=config.huff_block_size,
            block_delta_block_size=config.block_delta_block_size,
            nlocal=max(1, min(3, int(config.num_local_refactoring_level)))
            if config.decomposition == decomposition_type.Hybrid
            else 0,
            adjusted=adjusted,
        )
        # single-copy final assembly: header + every section written once
        blob = _join([meta.serialize()] + payload_parts)
        t_total.end()
        t_total.print("compress total", int(np.prod(shape)) * arr.dtype.itemsize)
        log.info(
            f"compressed {int(np.prod(shape)) * arr.dtype.itemsize} -> "
            f"{len(blob)} bytes over {S} subdomain(s)"
        )
        return blob, compress_status_type.Success
    except FormatError:
        return b"", compress_status_type.Failure
    except Exception:  # mirror general_compress's catch-all translation
        import traceback

        traceback.print_exc()
        return b"", compress_status_type.Failure


def _compress_zfp_path(arr, tol, s, mode, config, dt, shape):
    """ZFP-style transform compressor behind the standard self-describing
    header (reference: compressor_type::ZFP selection in
    CompressionHighLevel.hpp:311-341). ABS/REL L-inf bounds."""
    from .zfp import compress_zfp

    if not math.isinf(s):
        return b"", compress_status_type.Failure
    abs_tol = float(tol)
    norm = 0.0
    if mode == error_bound_type.REL:
        norm = calculate_norm(jnp.asarray(arr), s, False)
        abs_tol = tol * norm
    payload = compress_zfp(arr, tol=abs_tol, config=config)
    meta = Metadata(
        dtype=dt,
        shape=shape,
        decomposition=config.decomposition,
        ebtype=mode,
        norm=norm,
        tol=float(tol),
        s=float(s),
        ltype=config.lossless,
        ctype=compressor_type.ZFP,
    )
    return meta.serialize() + payload, compress_status_type.Success


def decompress(
    blob: bytes, config: Optional[Config] = None
) -> Tuple[Optional[np.ndarray], compress_status_type]:
    """Decompress a self-describing mgard-tpu blob.

    Returns (array, status). Mirrors mgard_x::decompress
    (reference: compress_x.hpp:109-154), including the reference's
    header-sniffing dispatch (compress_internal.cpp:5-13): streams written
    by the reference MGARD-X library route to the cross-decoder
    (formats/ref_stream.py) when their lossless backend is supported.
    """
    from .formats import ref_stream

    if ref_stream.sniff(bytes(blob[:8])):
        try:
            out, _h = ref_stream.decompress_reference(blob)
            return out, compress_status_type.Success
        except (FormatError, struct.error, ValueError, IndexError, KeyError):
            import traceback

            traceback.print_exc()
            return None, compress_status_type.Failure
    try:
        meta, off = Metadata.deserialize(blob)
    except (FormatError, struct.error):
        return None, compress_status_type.Failure
    from .utils.log import Timer, log

    t_total = Timer()
    t_total.start()
    try:
        cfg = config or Config()
        if config is not None and config.log_level:
            log.level = max(log.level, int(config.log_level))
        cfg.lossless = meta.ltype
        cfg.huff_dict_size = meta.huff_dict_size
        cfg.huff_block_size = meta.huff_block_size
        cfg.decomposition = meta.decomposition
        cfg.block_delta_block_size = meta.block_delta_block_size

        dtype = np_dtype(meta.dtype)
        # demoted streams (file 2.2) carry an f32 payload of a double
        # field: the whole decode pipeline runs in f32, the final cast
        # restores the declared dtype (bound already certified at
        # compress time with the cast error deducted)
        work_dtype = np.dtype(np.float32) if meta.demoted else np.dtype(dtype)
        shape = tuple(meta.shape)
        if getattr(meta, "ctype", compressor_type.MGARD) == compressor_type.ZFP:
            from .zfp import decompress_zfp

            out, _ = decompress_zfp(blob, off)
            t_total.end()
            t_total.print("decompress total", out.nbytes)
            return out.astype(dtype), compress_status_type.Success
        s = meta.s
        s_inf = math.isinf(s)
        orthogonal = infer_orthogonal_projection(s)
        prep = _prep_huffman(cfg)

        work_shape = adjust_shape(shape) if meta.adjusted else shape
        dd = DomainDecomposer.from_metadata(work_shape, work_dtype, meta, cfg)
        S = dd.num_subdomains
        local_tol = calc_local_abs_tol(meta.ebtype, meta.norm, meta.tol, s, S)

        out = np.empty(work_shape, work_dtype)
        coords_list = meta.coords

        def _dispatch_decompress(i, pos):
            """Parse subdomain i's section and dispatch its device pipeline
            WITHOUT synchronizing; returns (device array, slices). The
            caller overlaps subdomain i+1's dispatch with materializing i —
            the decompress-side double buffering the reference does in
            decompress_pipeline_gpu (GPUPipelines.hpp:262)."""
            roi_mults = None
            sls = dd.subdomain_slices(i)
            sub_coords = (
                [c[sl] for c, sl in zip(coords_list, sls)] if coords_list else None
            )
            hier = get_hierarchy(dd.subdomain_shape(i), work_dtype, sub_coords, cfg)

            if meta.roi_enabled:
                (mz_len,) = struct.unpack_from("<Q", blob, pos)
                pos += 8
                mask = np.unpackbits(
                    np.frombuffer(zlib.decompress(blob[pos : pos + mz_len]), np.uint8)
                )[: hier.total_num_elems].reshape(hier.shape).astype(bool)
                pos += mz_len
                from .ops.roi import roi_map_nested

                roi_mults = _roi_mult(roi_map_nested(mask, hier), meta.roi_factor)
            out_idx, out_val, used = _deserialize_outliers(blob, pos)
            pos = pos + used
            # pad outlier arrays to a coarse bucket so varying counts don't
            # retrace the decompress program (fill index n is dropped)
            from .lossless.huffman import _bucket

            m = len(out_idx)
            mb = max(min(_bucket(max(m, 1)), max(hier.total_num_elems, 1)), m)
            pad_idx = np.full(mb, hier.total_num_elems, np.int64)
            pad_idx[:m] = out_idx
            pad_val = np.zeros(mb, np.int64)
            pad_val[:m] = out_val

            hybrid_section = (
                meta.decomposition == decomposition_type.Hybrid
                and s_inf
                and _raw_symbol_backend(meta.ltype)
            )
            hybrid_v2 = hybrid_v3 = False
            if hybrid_section:
                (flag,) = struct.unpack_from("<B", blob, pos)
                pos += 1
                hybrid_v2 = flag == 1
                hybrid_v3 = flag == 2
                if flag > 2:
                    raise FormatError(
                        f"subdomain {i}: unknown hybrid front-end flag "
                        f"{flag} (this build reads 0..2)"
                    )
            if hybrid_v2 or hybrid_v3:
                from .lossless import bfp as _bfp
                from .ops.hybrid import (
                    hybrid_l_total,
                    pad_to8,
                    remainder_shape,
                    v3_ok_shape,
                )

                vtag = "v3" if hybrid_v3 else "v2"
                _nl = max(1, min(3, int(meta.nlocal) or 1))
                _padded = pad_to8(hier.shape)
                (cf_len,) = struct.unpack_from("<Q", blob, pos)
                pos += 8
                base3d, crl, rbuf, (n_cf, K, E, sb, C), _used = (
                    _bfp.deserialize_prepared(blob, pos,
                                              static_cap=hybrid_v3)
                )
                pos += cf_len
                if n_cf != int(np.prod(_padded)):
                    raise FormatError(
                        f"subdomain {i}: hybrid-{vtag} cf stream has "
                        f"{n_cf} symbols, expected {int(np.prod(_padded))}"
                    )
                if hybrid_v3 and not (
                    v3_ok_shape(_padded)
                    and sb == 32 * _padded[-1]
                    and C == _padded[-1] // 32
                    and 1 <= E <= 15
                    and 0 <= K and K + E <= 16
                ):
                    # flag-2 streams are only defined on the tile=SB
                    # scheme; anything else is corruption, not a format
                    raise FormatError(
                        f"subdomain {i}: hybrid-v3 cf stream geometry "
                        f"(sb={sb}, C={C}, K={K}, E={E}) does not match "
                        f"the v3 scheme for domain {_padded}"
                    )
                rem_sym, _used2 = lossless_decompress(blob, pos)
                _rem_shape = remainder_shape(_padded, _nl)
                if int(rem_sym.shape[0]) != int(np.prod(_rem_shape)):
                    raise FormatError(
                        f"subdomain {i}: hybrid-{vtag} rem stream has "
                        f"{int(rem_sym.shape[0])} symbols, expected "
                        f"{int(np.prod(_rem_shape))}"
                    )
                rem_hier = get_hierarchy(_rem_shape, work_dtype, None, cfg)
                qh = _hybrid_quantizer(
                    local_tol, hybrid_l_total(_padded, _nl, rem_hier)
                )
                if hybrid_v3:
                    NSB = (n_cf // 32) // sb
                    sbc = sb // C
                    CAP = E * (sb // _bfp.LANES)
                    rec = _decompress_core_hybrid_v3(
                        base3d, crl.reshape(NSB, sbc), rbuf[: NSB * CAP],
                        rem_sym, jnp.asarray(qh, work_dtype), hier.shape,
                        _padded, _nl, rem_hier, K, E,
                    )
                else:
                    zz_rows = _bfp.decode_core_zz(
                        base3d, crl, rbuf, K, E, sb, n_cf // 32, C,
                    )
                    rec = _decompress_core_hybrid_v2(
                        zz_rows, rem_sym, jnp.asarray(qh, work_dtype),
                        hier.shape, _padded, _nl, rem_hier, C,
                    )
                return rec, sls
            qflat, used = lossless_decompress(blob, pos)
            expected = hier.total_num_elems
            if hybrid_section:
                from .ops.hybrid import pad_to8, remainder_shape

                _nl = max(1, min(3, int(meta.nlocal) or 1))
                _padded = pad_to8(hier.shape)
                expected = int(np.prod(_padded)) + int(
                    np.prod(remainder_shape(_padded, _nl))
                )
            if int(qflat.shape[0]) != expected:
                raise FormatError(
                    f"subdomain {i}: payload has {int(qflat.shape[0])} symbols, "
                    f"expected {expected}"
                )

            quantizers = hier.quantizers(
                local_tol, s, 0.0, error_bound_type.ABS, meta.decomposition, orthogonal
            )
            single_dim = meta.decomposition == decomposition_type.SingleDim
            if (
                meta.decomposition == decomposition_type.Hybrid
                and s_inf
                and _raw_symbol_backend(meta.ltype)
            ):
                from .ops.hybrid import (
                    hybrid_l_total,
                    pad_to8,
                    remainder_shape,
                )

                nl = max(1, min(3, int(meta.nlocal) or 1))
                padded = pad_to8(hier.shape)
                rem_hier = get_hierarchy(
                    remainder_shape(padded, nl), work_dtype, None, cfg
                )
                q = _hybrid_quantizer(
                    local_tol, hybrid_l_total(padded, nl, rem_hier)
                )
                rec = _decompress_core_hybrid(
                    qflat, jnp.asarray(q, work_dtype), hier.shape, padded, nl,
                    rem_hier, zgroup=bool(meta.hybrid_grouping),
                )
            elif _raw_symbol_backend(meta.ltype):
                rec = _decompress_core_sym(
                    qflat, jnp.asarray(quantizers), hier, orthogonal, s_inf,
                    single_dim, step_mult=roi_mults if meta.roi_enabled else None,
                )
            elif meta.roi_enabled:
                rec = _decompress_core_roi(
                    qflat, jnp.asarray(quantizers), jnp.asarray(pad_idx),
                    jnp.asarray(pad_val), roi_mults, hier, orthogonal, prep,
                    int(meta.huff_dict_size), s_inf, single_dim,
                )
            else:
                rec = _decompress_core(
                    qflat,
                    jnp.asarray(quantizers),
                    jnp.asarray(pad_idx),
                    jnp.asarray(pad_val),
                    hier,
                    orthogonal,
                    prep,
                    int(meta.huff_dict_size),
                    s_inf,
                    single_dim,
                )
            return rec, sls

        # depth-2 deserialize/device overlap (mirror of the compress-side
        # pipeline; gated by config.prefetch like the reference's)
        overlap = bool(cfg.prefetch) and S > 1
        pending = None
        for i in range(S):
            (sec_len,) = struct.unpack_from("<Q", blob, off)
            off += 8
            state = _dispatch_decompress(i, off)
            if not overlap:
                out[state[1]] = np.asarray(state[0])
            else:
                if pending is not None:
                    out[pending[1]] = np.asarray(pending[0])
                pending = state
            off += sec_len
        if pending is not None:
            out[pending[1]] = np.asarray(pending[0])
        if meta.adjusted:
            out = out[tuple(slice(0, s) for s in shape)]
        if meta.demoted:
            out = out.astype(dtype)
        t_total.end()
        t_total.print("decompress total", out.nbytes)
        return out, compress_status_type.Success
    except FormatError:
        return None, compress_status_type.Failure
    except Exception:
        import traceback

        traceback.print_exc()
        return None, compress_status_type.Failure


# ----------------------------------------------------------------------
# Region-of-interest compression (reference: mgard::compress_roi,
# include/compress.tpp + adaptive_roi.tpp; examples/roi/mgard_roi.cpp)
# ----------------------------------------------------------------------
@partial(
    jax.jit,
    static_argnames=(
        "hier", "orthogonal", "prep_huffman", "dict_size", "outlier_cap", "s_inf", "single_dim",
    ),
)
def _compress_core_roi(
    v, quantizers, step_mult, hier, orthogonal, prep_huffman, dict_size, outlier_cap,
    s_inf, single_dim=False,
):
    dec = (decompose_single if single_dim else decompose)(v, hier, orthogonal)
    return Q.quantize_with_scales(
        dec, hier, quantizers, s_inf, prep_huffman, dict_size, outlier_cap,
        step_mult=step_mult,
    )


@partial(
    jax.jit,
    static_argnames=("hier", "orthogonal", "prep_huffman", "dict_size", "s_inf", "single_dim"),
)
def _decompress_core_roi(
    qflat, quantizers, outlier_idx, outlier_val, step_mult, hier, orthogonal,
    prep_huffman, dict_size, s_inf, single_dim=False,
):
    dec = Q.dequantize_with_scales(
        qflat, hier, quantizers, s_inf, prep_huffman, dict_size, outlier_idx, outlier_val,
        step_mult=step_mult,
    )
    return (recompose_single if single_dim else recompose)(dec, hier, orthogonal)


def _roi_mult(mask_nested, roi_factor: float):
    import jax.numpy as jnp

    return jnp.where(jnp.asarray(mask_nested) > 0, roi_factor, 1.0)


def compress_roi(
    data,
    tol: float,
    roi_mask=None,
    roi_factor: float = 16.0,
    s: float = math.inf,
    mode: error_bound_type = error_bound_type.ABS,
    config: Optional[Config] = None,
    coords: Optional[Sequence[np.ndarray]] = None,
    roi_detect: Optional[dict] = None,
) -> Tuple[bytes, compress_status_type]:
    """Compress with a finer error bound (tol/roi_factor) inside a region
    of interest. roi_mask: boolean array of the data's shape, or None to
    detect the region automatically from the data's own multilevel
    coefficients (ops/roi.py detect_roi — the counterpart of the
    reference's histogram-driven block selection, adaptive_roi.hpp:30-56
    driven from compress_roi, include/compress.tpp:64-130). roi_detect:
    optional kwargs forwarded to detect_roi (init_bw, bw_ratio, thresh,
    buffer_radius)."""
    config = config or Config()
    if config.decomposition == decomposition_type.Hybrid:
        # ROI step multipliers are defined on the MultiDim nested-box
        # hierarchy (ops/roi.py); the Hybrid default falls back here and
        # the effective choice is recorded in the header
        import dataclasses as _dc

        config = _dc.replace(config, decomposition=decomposition_type.MultiDim)
    try:
        from .ops.roi import roi_map_nested

        arr = np.asarray(data)
        if arr.ndim < 1 or arr.ndim > MAX_DIM:
            return b"", compress_status_type.NotSupportHigherNumberOfDimensionsFailure
        try:
            dt = dtype_enum(arr.dtype)
        except TypeError:
            return b"", compress_status_type.NotSupportDataTypeFailure
        shape = tuple(int(x) for x in arr.shape)
        s_inf = math.isinf(s)
        orthogonal = infer_orthogonal_projection(s)
        prep = _prep_huffman(config)
        single_dim = config.decomposition == decomposition_type.SingleDim
        coords_list = [np.asarray(c, np.float64) for c in coords] if coords else None
        hier = get_hierarchy(shape, arr.dtype, coords_list, config)

        if roi_mask is None:
            from .ops.roi import detect_roi

            mask = detect_roi(arr, hier, **(roi_detect or {}))
        else:
            mask = np.asarray(roi_mask).astype(bool)
        if mask.shape != arr.shape:
            raise ValueError("roi_mask shape must match data shape")

        norm = 0.0
        if mode == error_bound_type.REL:
            norm = calculate_norm(jnp.asarray(arr), s, config.normalize_coordinates)
        quantizers = hier.quantizers(
            tol, s, norm, mode, config.decomposition, orthogonal
        )
        nested = roi_map_nested(mask, hier)
        mult = _roi_mult(nested, roi_factor)
        n = hier.total_num_elems
        cap = _outlier_cap(n, config)
        if _raw_symbol_backend(config.lossless):
            sym = _compress_core_sym(
                jnp.asarray(arr), jnp.asarray(quantizers), hier, orthogonal,
                s_inf, single_dim, step_mult=mult,
            )
            mask_z = zlib.compress(np.packbits(mask).tobytes(), 3)
            payload = struct.pack("<Q", len(mask_z)) + mask_z
            payload += _serialize_outliers(
                0, np.zeros(0, np.int64), np.zeros(0, np.int64)
            )
            payload += lossless_compress(sym.ravel(), config)
            payload = struct.pack("<Q", len(payload)) + payload
            meta = Metadata(
                dtype=dt,
                shape=shape,
                dstype=(
                    data_structure_type.Cartesian_Grid_Uniform
                    if coords is None
                    else data_structure_type.Cartesian_Grid_Non_Uniform
                ),
                coords=coords_list,
                decomposition=config.decomposition,
                l_target=hier.l_target,
                ebtype=mode,
                norm=norm,
                tol=float(tol),
                ntype=norm_type.L_Inf if s_inf else norm_type.L_2,
                s=float(s),
                ltype=config.lossless,
                huff_dict_size=config.huff_dict_size,
                huff_block_size=config.huff_block_size,
                roi_enabled=True,
                roi_factor=float(roi_factor),
            )
            return meta.serialize() + payload, compress_status_type.Success
        qres = _compress_core_roi(
            jnp.asarray(arr), jnp.asarray(quantizers), mult, hier, orthogonal, prep,
            int(config.huff_dict_size), cap, s_inf, single_dim,
        )
        count = int(qres.outlier_count)
        if count > cap:
            cap2 = min(1 << (count - 1).bit_length(), n)
            qres = _compress_core_roi(
                jnp.asarray(arr), jnp.asarray(quantizers), mult, hier, orthogonal, prep,
                int(config.huff_dict_size), cap2, s_inf, single_dim,
            )
            count = int(qres.outlier_count)

        mask_z = zlib.compress(np.packbits(mask).tobytes(), 3)
        payload = struct.pack("<Q", len(mask_z)) + mask_z
        payload += _serialize_outliers(count, qres.outlier_idx, qres.outlier_val)
        payload += lossless_compress(qres.quantized.ravel(), config)
        payload = struct.pack("<Q", len(payload)) + payload

        meta = Metadata(
            dtype=dt,
            shape=shape,
            dstype=(
                data_structure_type.Cartesian_Grid_Uniform
                if coords is None
                else data_structure_type.Cartesian_Grid_Non_Uniform
            ),
            coords=coords_list,
            decomposition=config.decomposition,
            l_target=hier.l_target,
            ebtype=mode,
            norm=norm,
            tol=float(tol),
            ntype=norm_type.L_Inf if s_inf else norm_type.L_2,
            s=float(s),
            ltype=config.lossless,
            huff_dict_size=config.huff_dict_size,
            huff_block_size=config.huff_block_size,
            roi_enabled=True,
            roi_factor=float(roi_factor),
        )
        return meta.serialize() + payload, compress_status_type.Success
    except Exception:
        import traceback

        traceback.print_exc()
        return b"", compress_status_type.Failure
