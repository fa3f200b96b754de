"""Multi-device compression: subdomains sharded over a 1-D device mesh.

A re-design of the reference's scale-out story (reference: SURVEY.md
§2.13): the reference runs MPI rank-per-GPU with an MPI_Allreduce for the
global norm (pmdr-x-qoi.cpp:891-935) and otherwise fully independent
per-rank compression. Here the same structure is one shard_map over a
device mesh: each device transforms and quantizes its subdomain locally;
the only cross-device communication is an O(1) psum/pmax for the global
norm — exactly the reference's Allreduce, as an XLA collective instead of
MPI.

Both directions are sharded: compress_sharded writes a standard
self-describing blob (decompressable by mgard_tpu.decompress), and
decompress_sharded reads any BFX-backend MultiDim blob back over the mesh.
Arbitrary leading-dim sizes are supported through a Variable domain
decomposition (equal chunks on the mesh + one remainder subdomain on the
single-device path); float32 and float64 both run in their own dtype —
no silent casting.
"""

from __future__ import annotations

import math
import struct
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..hierarchy import Hierarchy
from ..ops import quantize as Q
from ..ops.refactor import decompose, recompose


def make_subdomain_mesh(n_devices: Optional[int] = None, axis: str = "subdomain") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def quantizers_ingraph(l_target: int, D: int, total_dof, abs_tol, s, s_inf: bool,
                       decomposition_multidim: bool = True,
                       orthogonal: bool = False):
    """Per-level quantizer steps computed inside the XLA program.

    Mirrors Hierarchy.quantizers / reference CalcQuantizers
    (LinearQuantization.hpp:234-298) with tol/s/norm as traced scalars, so a
    sharded pipeline can derive steps from a psum'd global norm in-graph.
    """
    L = l_target
    levels = jnp.arange(L + 1, dtype=jnp.float64)
    abs_tol = abs_tol.astype(jnp.float64) * 2.0
    if s_inf:
        if decomposition_multidim:
            denom = (L + 1) * ((1 + 3.0**D) if orthogonal else 1.0)
        else:
            denom = (L + 1) * D * 4.0
        q = jnp.full((L + 1,), 1.0, jnp.float64) * (abs_tol / denom)
    else:
        q = abs_tol / (jnp.exp2(s.astype(jnp.float64) * levels) * math.sqrt(total_dof))
    return q


# ----------------------------------------------------------------------
# Subdomain planning: equal chunks on the mesh + optional remainder
# ----------------------------------------------------------------------
def _plan_subdomains(shape, n_dev: int):
    """Split dim 0 into n_dev equal chunks plus an optional remainder chunk.

    Returns (chunk, sizes): the reference's Variable decomposition strategy
    (DomainDecomposer.hpp generate_*_strategy) specialised to the mesh — the
    equal chunks ride shard_map, the remainder takes the single-device path.
    """
    n0 = shape[0]
    if n0 < n_dev:
        raise ValueError(
            f"leading dim {n0} smaller than mesh size {n_dev}; use a smaller "
            "mesh (make_subdomain_mesh(n)) for this input"
        )
    chunk = n0 // n_dev
    rem = n0 - chunk * n_dev
    sizes = [chunk] * n_dev + ([rem] if rem else [])
    return chunk, sizes


def compress_shards_symbols(
    vs,
    hier: Hierarchy,
    mesh: Mesh,
    tol,
    s: float,
    rel: bool,
    normalize: bool = True,
    axis: str = "subdomain",
    n_total_subdomains: Optional[int] = None,
    extra_norm: float = 0.0,
    total_dof: Optional[int] = None,
):
    """Sharded decompose + raw-symbol quantize (the BFX-class path).

    vs: (S, *sub_shape) sharded over `axis`. Returns (symbols (S, n) int32
    still sharded, global norm scalar). The only cross-device communication
    is the O(1) psum/pmax for the norm — the reference's MPI_Allreduce
    (pmdr-x-qoi.cpp:891-935) as an XLA collective. extra_norm folds in the norm
    contribution of subdomains outside the mesh (the remainder chunk):
    max for L-inf, sum-of-squares for L2. total_dof is the exact global
    element count for REL-L2 normalization (a remainder subdomain is
    smaller than a mesh chunk, so n_sub * chunk_elems would overcount).
    """
    s_inf = math.isinf(s)
    orthogonal = not s_inf
    n_sub = n_total_subdomains or vs.shape[0]
    if total_dof is None:
        total_dof = n_sub * hier.total_num_elems

    def shard_fn(v_shard, tol_s, s_s, extra):
        if rel:
            if s_inf:
                norm = jnp.maximum(
                    jax.lax.pmax(jnp.max(jnp.abs(v_shard)), axis), extra
                )
            else:
                sq = jax.lax.psum(
                    jnp.sum(v_shard.astype(jnp.float64) ** 2), axis
                ) + extra
                norm = jnp.sqrt(sq / total_dof) if normalize else jnp.sqrt(sq)
            abs_tol = tol_s * norm.astype(jnp.float64)
        else:
            norm = jnp.asarray(0.0, jnp.float64)
            abs_tol = tol_s
        if not s_inf:
            # per-subdomain L2 errors add in quadrature (reference:
            # ErrorToleranceCalculator.hpp:127-147)
            abs_tol = abs_tol / math.sqrt(n_sub)
        quant = quantizers_ingraph(
            hier.l_target, hier.D, hier.total_num_elems, abs_tol, s_s, s_inf,
            orthogonal=orthogonal,
        )

        def one(v):
            dec = decompose(v, hier, orthogonal)
            return Q.quantize_symbols(dec, hier, quant.astype(v.dtype), s_inf)

        sym = jax.vmap(one)(v_shard)
        return sym, norm[None]

    from jax import shard_map

    fn = jax.jit(
        shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(axis), P(), P(), P()),
            out_specs=(P(axis), P(axis)),
        )
    )
    sym, norms = fn(
        vs,
        jnp.asarray(float(tol), jnp.float64),
        jnp.asarray(0.0 if s_inf else float(s), jnp.float64),
        jnp.asarray(float(extra_norm), jnp.float64),
    )
    return sym, float(norms[0])


# ----------------------------------------------------------------------
# Full sharded compress -> standard blob
# ----------------------------------------------------------------------
def compress_sharded(
    arr,
    tol: float,
    s: float = math.inf,
    mode=None,
    config=None,
    mesh: Optional[Mesh] = None,
):
    """Full multi-device compression to a standard self-describing blob.

    The leading axis is split into one equal subdomain per mesh device plus
    an optional remainder subdomain (Variable decomposition, recorded in the
    header); each device runs the complete decompose->quantize->BFX encode
    locally with a single psum/pmax for REL norms. The blob is
    byte-compatible with the single-device DomainDecomposer format, so
    mgard_tpu.decompress() (and decompress_sharded) read it directly.
    float32 and float64 inputs compress in their own dtype.
    """
    from ..config import Config
    from ..dtypes import (
        compress_status_type,
        data_structure_type,
        decomposition_type,
        domain_decomposition_type,
        dtype_enum,
        error_bound_type,
        lossless_type,
        norm_type,
    )
    from ..formats.metadata import Metadata
    from ..highlevel import (
        _compress_subdomain,
        _empty_outliers,
        _norm_kernel,
        _raw_encode_device,
        _raw_symbol_backend,
    )
    from ..hierarchy import get_hierarchy

    config = config or Config()
    if s < 0:  # includes s = -inf
        # the sharded path builds uniform hierarchies only; the uniform
        # dist chain's even-axis re-spread breaks the negative-s bound in
        # the true-mesh s-norm (see highlevel.compress's geometry-true
        # routing + COVERAGE.md r4 finding). Route via the single-device
        # API, which carries explicit coords, rather than ship a stream
        # with a silently weaker certificate.
        raise ValueError(
            "compress_sharded does not support negative s; use "
            "mgard_tpu.compress (it routes through the geometry-true "
            "non-uniform chain)"
        )
    if not _raw_symbol_backend(config.lossless):
        raise ValueError(
            "compress_sharded runs the raw-symbol (BFX/BFP-class) pipeline; "
            "set config.lossless accordingly (use mgard_tpu.compress for "
            "other backends)"
        )
    if config.decomposition == decomposition_type.Hybrid:
        # the sharded pipeline runs the MultiDim transform; the default
        # Config selects Hybrid for the single-device flagship, so fall back
        # transparently (recorded in the written metadata, not an error)
        import dataclasses as _dc

        config = _dc.replace(config, decomposition=decomposition_type.MultiDim)
    mode = mode if mode is not None else error_bound_type.ABS
    mesh = mesh or make_subdomain_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    arr = np.asarray(arr) if not isinstance(arr, jax.Array) else arr
    if arr.dtype not in (np.float32, np.float64):
        return b"", compress_status_type.NotSupportDataTypeFailure
    shape = tuple(int(x) for x in arr.shape)
    s_inf = math.isinf(s)
    rel = mode == error_bound_type.REL

    chunk, sizes = _plan_subdomains(shape, n_dev)
    S = len(sizes)
    has_rem = S > n_dev
    sub_shape = (chunk,) + shape[1:]
    hier = get_hierarchy(sub_shape, arr.dtype, None, config)

    # remainder subdomain's norm contribution enters the in-graph collective
    rem_arr = None
    extra_norm = 0.0
    if has_rem:
        rem_arr = jnp.asarray(arr[n_dev * chunk :])
        if rel:
            if s_inf:
                extra_norm = float(_norm_kernel(rem_arr, True, False))
            else:
                extra_norm = float(_norm_kernel(rem_arr, False, False)) ** 2

    # each shard goes to its own device straight from host memory (a
    # device-resident input is resharded in place)
    head = arr[: n_dev * chunk]
    head = (head.reshape((n_dev,) + sub_shape) if isinstance(head, jax.Array)
            else np.reshape(head, (n_dev,) + sub_shape))
    vs = jax.device_put(head, NamedSharding(mesh, P(axis)))
    sym, norm = compress_shards_symbols(
        vs, hier, mesh, tol, s, rel, config.normalize_coordinates, axis=axis,
        n_total_subdomains=S, extra_norm=extra_norm,
        total_dof=int(np.prod(shape)),
    )
    if rel and not s_inf and config.normalize_coordinates:
        # the in-graph norm already divides by total dof; nothing to fix up
        pass

    # ---- per-subdomain entropy encode + serialize (host loop over shards);
    # sections are bytesink parts lists so the final assembly below writes
    # each payload byte once (same single-copy contract as highlevel)
    from ..highlevel import _raw_section_parts
    from ..utils.bytesink import join as _join, parts_size as _psize

    sections = []
    for i in range(n_dev):
        lt_eff, state = _raw_encode_device(sym[i].ravel(), config)
        sections.append(
            [_empty_outliers()] + _raw_section_parts(lt_eff, state, config)
        )
    if has_rem:
        from ..decomposer import calc_local_abs_tol

        local_tol = calc_local_abs_tol(mode, norm, tol, s, S)
        rem_hier = get_hierarchy(
            (sizes[-1],) + shape[1:], arr.dtype, None, config
        )
        sections.append([
            _compress_subdomain(
                rem_arr, rem_hier, config, local_tol, s,
                orthogonal=not s_inf, prep=False,
            )
        ])

    payload_parts = []
    for sec in sections:
        payload_parts.append(struct.pack("<Q", _psize(sec)))
        payload_parts.extend(sec)
    meta = Metadata(
        dtype=dtype_enum(arr.dtype),
        shape=shape,
        dstype=data_structure_type.Cartesian_Grid_Uniform,
        coords=None,
        decomposition=config.decomposition,
        l_target=hier.l_target,
        reorder=config.reorder,
        domain_decomposed=True,
        ddtype=domain_decomposition_type.Variable,
        domain_decomposed_dim=0,
        domain_decomposed_size=chunk,
        dd_variable_sizes=tuple(sizes),
        ebtype=mode,
        norm=norm,
        tol=float(tol),
        ntype=norm_type.L_Inf if s_inf else norm_type.L_2,
        s=float(s),
        ltype=config.lossless,
        huff_dict_size=config.huff_dict_size,
        huff_block_size=config.huff_block_size,
        block_delta_block_size=config.block_delta_block_size,
    )
    from ..dtypes import compress_status_type as _st

    return _join([meta.serialize()] + payload_parts), _st.Success


# ----------------------------------------------------------------------
# Sharded decompress
# ----------------------------------------------------------------------
def decompress_sharded(
    blob: bytes,
    config=None,
    mesh: Optional[Mesh] = None,
):
    """Multi-device decompression of a standard blob.

    Every group of equal-shape subdomains whose count divides the mesh runs
    as one shard_map (BFX decode + dequantize + recompose per device); the
    rest fall back to the single-device path. Mirrors
    decompress_pipeline_gpu's role (reference: GPUPipelines.hpp:262) at mesh
    scale. Returns (array, status).
    """
    from ..config import Config
    from ..decomposer import DomainDecomposer, calc_local_abs_tol
    from ..dtypes import (
        compress_status_type,
        compressor_type,
        decomposition_type,
        lossless_type,
        np_dtype,
    )
    from ..formats.metadata import FormatError, Metadata
    from ..highlevel import _deserialize_outliers, adjust_shape
    from ..hierarchy import get_hierarchy
    from ..lossless import bfx
    from ..lossless.registry import _HDR as _LHDR

    try:
        meta, off = Metadata.deserialize(blob)
    except (FormatError, struct.error):
        return None, compress_status_type.Failure
    cfg = config or Config()
    mesh = mesh or make_subdomain_mesh()
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    supported = (
        getattr(meta, "ctype", compressor_type.MGARD) == compressor_type.MGARD
        and meta.ltype in (lossless_type.BFX, lossless_type.BFX_Zstd)
        and meta.decomposition
        in (decomposition_type.MultiDim, decomposition_type.SingleDim)
        and not meta.roi_enabled
        and meta.coords is None
    )
    if not supported or meta.decomposition == decomposition_type.SingleDim:
        # correctness first: anything outside the meshed fast path routes
        # through the reference-parity single-device decompress
        from ..highlevel import decompress as _single

        return _single(blob, config)

    dtype = np_dtype(meta.dtype)
    shape = tuple(meta.shape)
    work_shape = adjust_shape(shape) if meta.adjusted else shape
    dd = DomainDecomposer.from_metadata(work_shape, dtype, meta, cfg)
    S = dd.num_subdomains
    s = meta.s
    s_inf = math.isinf(s)
    orthogonal = not s_inf
    local_tol = calc_local_abs_tol(meta.ebtype, meta.norm, meta.tol, s, S)

    # ---- parse all sections first
    secs = []
    for i in range(S):
        (sec_len,) = struct.unpack_from("<Q", blob, off)
        off += 8
        secs.append((off, sec_len))
        off += sec_len

    def parse_bfx(sec_off, sec_len):
        _, _, used = _deserialize_outliers(blob, sec_off)
        p = sec_off + used
        bt, inner_size = struct.unpack_from(_LHDR, blob, p)
        p += struct.calcsize(_LHDR)
        inner = blob[p : p + inner_size]
        if lossless_type(bt) == lossless_type.BFX_Zstd:
            from ..lossless import host as _host

            inner = _host.zstd_decompress(bytes(inner))
        return bytes(inner)

    # ---- group equal-shape subdomains; shard groups of n_dev
    out = np.empty(work_shape, dtype)
    groups: dict = {}
    for i in range(S):
        groups.setdefault(dd.subdomain_shape(i), []).append(i)

    from jax import shard_map

    _fn_cache: dict = {}

    def _make_shard_dec(hier, sb, align, n):
        """Per-(shape, layout) jitted decoder, cached so equal batches reuse
        ONE compiled program — a fresh closure per batch defeated the jit
        cache and recompiled the identical shard_map every iteration."""
        key = (hier.shape, sb, align)
        if key in _fn_cache:
            return _fn_cache[key]

        def shard_dec(words_b, widths_b, quant):
            def one(wb, wd):
                sym = bfx.decode_core(wb, wd, sb, align)[:n]
                dec = Q.dequantize_symbols(
                    sym.reshape(hier.shape), hier, quant.astype(dtype),
                    s_inf,
                )
                return recompose(dec, hier, orthogonal)

            return jax.vmap(one)(words_b, widths_b)

        fn = jax.jit(
            shard_map(
                shard_dec,
                mesh=mesh,
                in_specs=(P(axis), P(axis), P()),
                out_specs=P(axis),
            )
        )
        _fn_cache[key] = fn
        return fn

    for sub_shape, idxs in groups.items():
        hier = get_hierarchy(sub_shape, dtype, None, cfg)
        from ..dtypes import error_bound_type as _ebt

        quantizers = hier.quantizers(
            local_tol, s, 0.0, _ebt.ABS, meta.decomposition, orthogonal
        )
        n = hier.total_num_elems
        k = len(idxs)
        whole = k // n_dev * n_dev
        # meshed batches of n_dev subdomains
        for g0 in range(0, whole, n_dev):
            batch = idxs[g0 : g0 + n_dev]
            decoded = [bfx_parse_and_pad(parse_bfx(*secs[i]), n) for i in batch]
            sb = decoded[0][2]
            rows_max = max(d[0].shape[0] for d in decoded)
            words = np.zeros((n_dev, rows_max, 128), np.uint32)
            widths = np.zeros((n_dev, decoded[0][1].shape[0]), np.int32)
            for j, (wbuf, wd, _sb, _align) in enumerate(decoded):
                words[j, : wbuf.shape[0]] = wbuf
                widths[j] = wd
            align = decoded[0][3]
            fn = _make_shard_dec(hier, sb, align, n)
            ws = jax.device_put(
                jnp.asarray(words), NamedSharding(mesh, P(axis))
            )
            wd = jax.device_put(
                jnp.asarray(widths), NamedSharding(mesh, P(axis))
            )
            rec = np.asarray(fn(ws, wd, jnp.asarray(quantizers)))
            for j, i in enumerate(batch):
                out[dd.subdomain_slices(i)] = rec[j]
        # stragglers: single-device jitted path
        for i in idxs[whole:]:
            inner = parse_bfx(*secs[i])
            sym, _ = bfx.decode(inner)
            from ..highlevel import _decompress_core_sym

            rec = _decompress_core_sym(
                sym, jnp.asarray(quantizers), hier, orthogonal, s_inf,
                meta.decomposition == decomposition_type.SingleDim,
            )
            out[dd.subdomain_slices(i)] = np.asarray(rec)

    if meta.adjusted:
        out = out[tuple(slice(0, t) for t in shape)]
    return out, compress_status_type.Success


def bfx_parse_and_pad(inner: bytes, n_expected: int):
    """Parse a BFX blob into device-ready (words2d, widths, sb, align)
    without decoding (the decode runs sharded)."""
    from ..lossless import bfx

    magic, n, total, sb_blocks, align = struct.unpack_from(bfx._HDR, inner, 0)
    if magic != bfx._MAGIC:
        raise ValueError("bad BFX blob in sharded stream")
    if n != n_expected:
        raise ValueError(f"BFX blob has {n} symbols, expected {n_expected}")
    p = struct.calcsize(bfx._HDR)
    npad = bfx._pad_to(n, sb_blocks)
    nb = npad // bfx.BS
    widths = np.frombuffer(inner, np.uint8, nb, p).astype(np.int32)
    p += nb
    words = np.frombuffer(inner, "<u4", total, p)
    cap = sb_blocks * 32
    rows = (total + cap + 127) // 128 + 1
    wbuf = np.zeros((rows, 128), np.uint32)
    wbuf.reshape(-1)[:total] = words
    return wbuf, widths, sb_blocks, align


def compress_shards_device(
    vs,
    hier: Hierarchy,
    mesh: Mesh,
    tol,
    s: float,
    rel: bool,
    prep_huffman: bool = True,
    dict_size: int = 8192,
    outlier_cap: int = 4096,
    axis: str = "subdomain",
):
    """Device portion of sharded compression (outlier-capture variant).

    vs: (S, *subdomain_shape) array, S divisible by mesh size. Each shard is
    decomposed+quantized independently; REL bounds use a global pmax/psum
    norm (the reference's MPI_Allreduce, as an XLA collective). Returns per-subdomain
    quantized arrays + outlier info, still sharded.
    """
    s_inf = math.isinf(s)
    orthogonal = not s_inf
    n_sub = vs.shape[0]
    total_dof = n_sub * hier.total_num_elems

    def shard_fn(v_shard, tol_s, s_s):
        # local batch of subdomains on this device
        def one(v):
            return decompose(v, hier, orthogonal)

        dec = jax.vmap(one)(v_shard)
        if rel:
            if s_inf:
                local = jnp.max(jnp.abs(v_shard))
                norm = jax.lax.pmax(local, axis)
            else:
                local = jnp.sum(v_shard.astype(jnp.float64) ** 2)
                norm = jnp.sqrt(jax.lax.psum(local, axis) / total_dof)
            abs_tol = tol_s * norm.astype(jnp.float64)
        else:
            abs_tol = tol_s
        if not s_inf:
            # Per-subdomain L2 errors add in quadrature across the n_sub
            # independent subdomains, so each local bound must shrink by
            # sqrt(n_sub) for the global bound to hold (reference:
            # ErrorToleranceCalculator.hpp:127-147; matches
            # decomposer.calc_local_abs_tol).
            abs_tol = abs_tol / math.sqrt(n_sub)
        quant = quantizers_ingraph(
            hier.l_target, hier.D, hier.total_num_elems, abs_tol, s_s, s_inf,
            orthogonal=orthogonal,
        )

        def qz(d):
            return Q.quantize_with_scales(
                d, hier, quant, s_inf, prep_huffman, dict_size, outlier_cap
            )

        res = jax.vmap(qz)(dec)
        return res.quantized, res.outlier_count, res.outlier_idx, res.outlier_val

    from jax import shard_map

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    return fn(
        vs,
        jnp.asarray(float(tol), jnp.float64),
        jnp.asarray(0.0 if s_inf else float(s), jnp.float64),
    )
