"""MDR progressive refactoring tests.

Oracle: the estimated error bound used by MDRequest must dominate the actual
reconstruction error, and retrieval must be monotone (more planes -> smaller
error, more bytes)."""

import math

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu import mdr
from mgard_tpu.config import Config
from mgard_tpu.mdr.api import (
    RefactoredMetadata,
    read_mdr_metadata,
    read_mdr_planes,
    retrieve_size,
    write_mdr,
)
from mgard_tpu.mdr import bitplane


def smooth(shape, seed=0):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 1, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    v = np.zeros(shape)
    for _ in range(3):
        ks = rng.integers(1, 5, len(shape))
        acc = rng.uniform(0, 2 * np.pi)
        for k, g in zip(ks, grids):
            acc = acc + 2 * np.pi * k * g
        v += rng.uniform(0.3, 1.0) * np.sin(acc)
    return v


def _cfg(b=10):
    cfg = Config()
    cfg.total_num_bitplanes = b
    return cfg


def test_bitplane_roundtrip_full_planes():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    v = rng.standard_normal(256)
    B = 16
    planes, exp, err_max, err_sq, n = bitplane.encode_level(jnp.asarray(v), B)
    rec = np.asarray(bitplane.decode_level(np.asarray(planes), exp, B, B, n))
    # full-precision round trip error = fixed-point rounding error
    step = 2.0 ** (exp - B + 1)
    assert np.max(np.abs(rec - v)) <= step
    assert float(err_max[B]) <= step
    # error tables are monotone decreasing
    assert np.all(np.diff(np.asarray(err_max)) <= 1e-12)


def test_error_tables_match_actual():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    v = rng.standard_normal(512)
    B = 12
    planes, exp, err_max, err_sq, n = bitplane.encode_level(jnp.asarray(v), B)
    for b in [1, 3, 6, 12]:
        rec = np.asarray(
            bitplane.decode_level(np.asarray(planes)[: 1 + b], exp, B, b, n)
        )
        actual = np.max(np.abs(rec - v))
        assert np.isclose(actual, float(err_max[b]), rtol=1e-12), (b, actual, err_max[b])


def test_bitplane_extreme_magnitudes():
    """Error tables must stay finite upper bounds for data whose squared
    errors exceed the range of an emulated f32-pair float64 (amax ~1e30,
    physical err_sq ~1e61): the device kernels return unit-space tables and
    scale_tables converts on host (regression for the r4 NaN overflow)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    f32 = np.float32
    v = np.concatenate(
        [
            rng.standard_normal(1024 - 8).astype(f32) * 7.3,
            np.array([0, -0.0, 1e-38, -1e-38, 2, -4, 1e30, -1e30], f32),
        ]
    )
    for B in (16, 32):
        planes, exp, err_max, err_sq, n = bitplane.encode_level(
            jnp.asarray(v), B
        )
        assert np.isfinite(err_max).all() and np.isfinite(err_sq).all()
        for b in (B // 2, B):
            rec = np.asarray(
                bitplane.decode_level(
                    np.asarray(planes)[: 1 + b], exp, B, b, n
                )
            ).astype(np.float64)
            err = np.max(np.abs(rec - v.astype(np.float64)))
            sq = float(np.sum((rec - v.astype(np.float64)) ** 2))
            assert err <= float(err_max[b]) * (1 + 1e-9), (B, b)
            assert sq <= float(err_sq[b]) * (1 + 1e-6), (B, b)


@pytest.mark.parametrize("shape", [(65,), (33, 33)])
def test_progressive_bound_holds(shape):
    v = smooth(shape)
    meta, data = mdr.MDRefactor(v, _cfg(12))
    prev_bytes = 0
    prev_err = np.inf
    for tol in [3e-1, 3e-2, 3e-3]:
        counts = mdr.MDRequest(meta, tol)
        meta.prev_used = []
        nbytes = retrieve_size(meta, counts)
        rec = mdr.MDReconstruct(meta, data, counts)
        err = np.max(np.abs(rec.data - v))
        assert err <= tol, f"tol {tol}: err {err}"
        assert nbytes >= prev_bytes
        assert err <= prev_err + 1e-14
        prev_bytes, prev_err = nbytes, err


def test_metadata_serialization_roundtrip():
    v = smooth((33,))
    meta, data = mdr.MDRefactor(v, _cfg(8))
    blob = meta.serialize()
    meta2, used = RefactoredMetadata.deserialize(blob)
    assert meta2.shape == meta.shape
    assert meta2.number_bitplanes == meta.number_bitplanes
    assert len(meta2.levels) == len(meta.levels)
    assert np.allclose(meta2.levels[3].err_max, meta.levels[3].err_max)
    assert meta2.levels[2].plane_sizes == meta.levels[2].plane_sizes


def test_file_writer_partial_retrieval(tmp_path):
    v = smooth((33, 17))
    meta, data = mdr.MDRefactor(v, _cfg(10))
    path = str(tmp_path / "test.mdr")
    write_mdr(path, meta, data)
    meta2, hdr = read_mdr_metadata(path)
    counts = mdr.MDRequest(meta2, 1e-2)
    partial = read_mdr_planes(path, meta2, counts, hdr)
    rec = mdr.MDReconstruct(meta2, partial, counts)
    assert np.max(np.abs(rec.data - v)) <= 1e-2
    # partial retrieval actually skipped bytes
    fetched = sum(len(b) for lvl in partial.planes for b in lvl)
    total = sum(sum(l.plane_sizes) for l in meta2.levels)
    assert fetched <= total


def test_l2_mode_request():
    v = smooth((65, 65))
    meta, data = mdr.MDRefactor(v, _cfg(12))
    tol = 1e-3
    counts = mdr.MDRequest(meta, tol, s=0.0)
    rec = mdr.MDReconstruct(meta, data, counts)
    l2 = float(np.sqrt(np.mean((rec.data - v) ** 2)))
    assert l2 <= tol


# ----------------------------------------------------------------------
# Round-2 additions: NegaBinary encoding, orthogonal basis, decomposed MDR
# ----------------------------------------------------------------------
def test_negabinary_roundtrip_and_progression():
    import numpy as np
    from mgard_tpu import Config
    from mgard_tpu.dtypes import bitplane_encoding_type
    from mgard_tpu.mdr.api import MDRefactor, MDReconstruct, MDRequest

    rng = np.random.default_rng(3)
    v = rng.standard_normal((17, 17)).astype(np.float32)
    cfg = Config()
    cfg.mdr_encoding = bitplane_encoding_type.NegaBinary
    cfg.total_num_bitplanes = 30
    meta, data = MDRefactor(v, cfg)
    assert meta.sign_rows == 0
    # metadata round-trips the encoding flag
    m2, _ = type(meta).deserialize(meta.serialize())
    assert m2.encoding == bitplane_encoding_type.NegaBinary
    errs = []
    for tol in (1e-1, 1e-2, 1e-3):
        counts = MDRequest(meta, tol)
        meta.prev_used = []
        out = MDReconstruct(meta, data, counts, cfg)
        err = float(np.max(np.abs(out.data - v)))
        assert err <= tol
        errs.append(err)
    assert errs[0] >= errs[-1]


def test_orthogonal_basis_roundtrip():
    import numpy as np
    from mgard_tpu import Config
    from mgard_tpu.mdr.api import MDRefactor, MDReconstruct, MDRequest

    rng = np.random.default_rng(5)
    v = rng.standard_normal((16, 9)).astype(np.float32)
    cfg = Config()
    cfg.mdr_orthogonal_basis = True
    meta, data = MDRefactor(v, cfg)
    assert meta.orthogonal
    counts = MDRequest(meta, 1e-3)
    out = MDReconstruct(meta, data, counts, cfg)
    assert float(np.max(np.abs(out.data - v))) <= 1e-3


def test_decomposed_mdr():
    import numpy as np
    from mgard_tpu import Config
    from mgard_tpu.dtypes import domain_decomposition_type
    from mgard_tpu.mdr.api import (
        MDReconstructDecomposed,
        MDRefactorDecomposed,
        MDRequestDecomposed,
    )

    rng = np.random.default_rng(9)
    v = rng.standard_normal((24, 9, 9)).astype(np.float32)
    cfg = Config()
    cfg.domain_decomposition = domain_decomposition_type.Block
    cfg.block_size = 9
    dmdr = MDRefactorDecomposed(v, cfg)
    assert len(dmdr.metas) > 1
    plans = MDRequestDecomposed(dmdr, 1e-2)
    out = MDReconstructDecomposed(dmdr, plans, cfg)
    assert float(np.max(np.abs(out - v))) <= 1e-2


def test_reorganized_writer_roundtrip(tmp_path):
    import numpy as np
    from mgard_tpu import Config
    from mgard_tpu.mdr.api import (
        MDReconstruct,
        MDRefactor,
        MDRequest,
        read_mdr_metadata,
        read_mdr_planes,
        write_mdr,
    )

    rng = np.random.default_rng(11)
    v = rng.standard_normal((17, 17)).astype(np.float32)
    meta, data = MDRefactor(v)
    meta.reorganized = True
    path = str(tmp_path / "x.mdr")
    write_mdr(path, meta, data)
    m2, hdr = read_mdr_metadata(path)
    assert m2.reorganized
    counts = MDRequest(m2, 1e-2)
    d2 = read_mdr_planes(path, m2, counts, hdr)
    out = MDReconstruct(m2, d2, counts)
    assert float(np.max(np.abs(out.data - v))) <= 1e-2


def test_blocked_interleaver_roundtrip_and_ratio():
    """Blocked interleaver (reference: MDR-X/Interleaver/BlockedInterleaver)
    round-trips exactly and its locality-aware plane packing is measured
    against direct order."""
    import numpy as np

    import mgard_tpu
    from mgard_tpu.mdr import MDReconstruct, MDRefactor, MDRequest

    rng = np.random.default_rng(9)
    x = np.linspace(0, 1, 64)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    v = (np.sin(5 * X) * np.cos(4 * Y) + 0.1 * Z).astype(np.float32)
    sizes = {}
    for mode in ("direct", "blocked"):
        cfg = mgard_tpu.Config()
        cfg.mdr_interleaver = mode
        meta, data = MDRefactor(v, cfg)
        assert meta.interleaver == (1 if mode == "blocked" else 0)
        counts = MDRequest(meta, 1e-3)
        rec = MDReconstruct(meta, data, counts)
        assert np.max(np.abs(rec.data - v)) <= 1e-3, mode
        sizes[mode] = sum(sum(lm.plane_sizes) for lm in meta.levels)
    # measured effect, not asserted as an improvement (data-dependent):
    # both must be within 25% of each other on this smooth field
    a, b = sizes["direct"], sizes["blocked"]
    assert abs(a - b) <= 0.25 * max(a, b), sizes


def test_sfc_interleaver_roundtrip_and_ratio():
    """SFC (Morton) interleaver (reference: MDR-X/Interleaver/
    SFCInterleaver.hpp) round-trips exactly; measured ratio effect vs
    direct like the Blocked test."""
    import numpy as np

    import mgard_tpu
    from mgard_tpu.mdr import MDReconstruct, MDRefactor, MDRequest
    from mgard_tpu.mdr.components import _morton_fwd, _morton_inv

    # pure-permutation sanity: morton of an 8x8 iota is the Z-order curve
    a = np.arange(64).reshape(8, 8)
    m = np.asarray(_morton_fwd(a))
    assert m[0] == 0 and m[1] == a[0, 1] and m[2] == a[1, 0] and m[3] == a[1, 1]
    np.testing.assert_array_equal(np.asarray(_morton_inv(m, (8, 8))), a)

    x = np.linspace(0, 1, 64)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    v = (np.sin(5 * X) * np.cos(4 * Y) + 0.1 * Z).astype(np.float32)
    sizes = {}
    for mode in ("direct", "sfc"):
        cfg = mgard_tpu.Config()
        cfg.mdr_interleaver = mode
        meta, data = MDRefactor(v, cfg)
        assert meta.interleaver == (2 if mode == "sfc" else 0)
        counts = MDRequest(meta, 1e-3)
        rec = MDReconstruct(meta, data, counts)
        assert np.max(np.abs(rec.data - v)) <= 1e-3, mode
        sizes[mode] = sum(sum(lm.plane_sizes) for lm in meta.levels)
    a, b = sizes["direct"], sizes["sfc"]
    assert abs(a - b) <= 0.25 * max(a, b), sizes


def test_interleaver_persisted_in_header(tmp_path):
    import numpy as np

    import mgard_tpu
    from mgard_tpu.mdr import MDRefactor
    from mgard_tpu.mdr.api import RefactoredMetadata, read_mdr_metadata, write_mdr

    rng = np.random.default_rng(10)
    v = rng.standard_normal((16, 16)).astype(np.float32)
    cfg = mgard_tpu.Config()
    cfg.mdr_interleaver = "blocked"
    meta, data = MDRefactor(v, cfg)
    pth = str(tmp_path / "x.mdr")
    write_mdr(pth, meta, data)
    m2, _ = read_mdr_metadata(pth)
    assert m2.interleaver == 1


def test_int_quantize_matches_f64_oracle():
    """_int_quantize_f32 (pure IEEE-754 bit manipulation) must equal the
    f64 oracle: mag = round-half-away(|v| * 2^(frac-exp)) clamped, and the
    residue remi*2^-kc must equal p - mag exactly whenever kc < 31."""
    import jax.numpy as jnp

    from mgard_tpu.mdr.bitplane import _int_quantize_f32, _residue_f32

    rng = np.random.default_rng(5)
    v = np.concatenate(
        [
            rng.standard_normal(4096)
            * 10.0 ** rng.integers(-8, 8, 4096).astype(np.float64),
            np.array([0.0, -0.0, 1.0, -1.0, 0.5, 2.0**-126, 65504.0]),
        ]
    ).astype(np.float32)
    B = 24
    exp = 30  # covers sh<0 and sh>=0 regimes across the magnitudes
    mag, remi, kc, sign = (
        np.asarray(x)
        for x in _int_quantize_f32(jnp.asarray(v), jnp.int32(exp), B - 1, 2 ** (B - 1) - 1)
    )
    r = np.asarray(_residue_f32(jnp.asarray(remi), jnp.asarray(kc)))
    p = np.abs(v.astype(np.float64)) * 2.0 ** ((B - 1) - exp)
    mag_ref = np.minimum(np.floor(p + 0.5), 2 ** (B - 1) - 1)
    assert np.array_equal(mag, mag_ref.astype(np.uint32))
    assert np.array_equal(sign == 1, np.signbit(v))
    exact = kc < 31
    np.testing.assert_array_equal(
        (r.astype(np.float64))[exact], (p - mag_ref)[exact]
    )
    # clamped-scale residues still dominate the true residue magnitude
    over = ~exact
    assert np.all(np.abs(r[over]) >= np.abs(p - mag_ref)[over] - 1e-30)


def test_decode_tiny_exponent_f32_no_underflow():
    """Levels with amax near 2^-120 at B=32 must decode correctly in f32:
    a single-factor exp2(exp - (B-1)) scale underflows to zero (exponent
    -151 < f32 minimum) and silently zeroes the whole level. Regression for
    the two-factor scale in decode_kernel / decode_kernel_negabinary."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    v = (rng.standard_normal(256) * 2.0**-120).astype(np.float64)
    B = 32
    for nb in (False, True):
        enc = bitplane.encode_kernel_negabinary if nb else bitplane.encode_kernel
        dec = bitplane.decode_kernel_negabinary if nb else bitplane.decode_kernel
        planes, exp, _, _ = enc(bitplane.pad_stream(jnp.asarray(v)), B)
        rows = planes[: B if nb else 1 + B]
        rec32 = np.asarray(dec(rows, exp, B, B, jnp.float32))[:256]
        rec64 = np.asarray(dec(rows, exp, B, B, jnp.float64))[:256]
        assert np.any(rec32 != 0.0), ("all-zero decode (underflow)", nb)
        # f32 decode agrees with the f64 decode to f32 rounding; results
        # below the f32 normal range flush to 0 (documented _pow2_scale_f32
        # contract), so allow atol = min normal
        np.testing.assert_allclose(rec32, rec64, rtol=1e-6, atol=2.0**-126)
        assert np.max(np.abs(rec64 - v)) <= 2.0 ** (int(exp) - B + 2)


def test_decomposed_finite_s_rms_bound():
    """MDRequestDecomposed plans with the GLOBAL tol per subdomain for
    finite s: estimate_error bounds are RMS-normalized, and the global RMS
    is a weighted mean of per-subdomain RMS values, so no tol/sqrt(S)
    split is needed. The bound must still hold globally."""
    from mgard_tpu import Config
    from mgard_tpu.dtypes import domain_decomposition_type
    from mgard_tpu.mdr.api import (
        MDReconstructDecomposed,
        MDRefactorDecomposed,
        MDRequestDecomposed,
    )

    rng = np.random.default_rng(12)
    v = rng.standard_normal((24, 9, 9)).astype(np.float32)
    cfg = Config()
    cfg.domain_decomposition = domain_decomposition_type.Block
    cfg.block_size = 9
    dmdr = MDRefactorDecomposed(v, cfg)
    assert len(dmdr.metas) > 1
    tol = 1e-2
    plans = MDRequestDecomposed(dmdr, tol, s=0.0)
    out = MDReconstructDecomposed(dmdr, plans, cfg)
    rms = float(np.sqrt(np.mean((out.astype(np.float64) - v) ** 2)))
    assert rms <= tol, rms
    # and the plan is not sqrt(S)-inflated: each subdomain's own estimate
    # already meets the global tol, no tighter
    from mgard_tpu.mdr.components import estimate_error

    for m, c in zip(dmdr.metas, plans):
        assert estimate_error(m, c, 0.0) <= tol
