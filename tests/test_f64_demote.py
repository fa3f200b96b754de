"""float64 fast path: certified precision demotion (file 2.2).

When the L-inf budget covers the exact f64->f32 cast error, compress()
routes double data through the f32 flagship pipeline with the cast error
deducted from the tolerance; decompress() returns float64 and the ORIGINAL
double field is within the user's bound. The reference instantiates double
natively everywhere (reference: include/compress_x.hpp:31-159); demotion
halves the bytes every stage moves.
"""

import dataclasses
import math

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu import Config
from mgard_tpu.dtypes import (
    compress_status_type,
    decomposition_type,
    error_bound_type,
)
from mgard_tpu.formats.metadata import Metadata


def _field(shape, seed=7, scale=1.0):
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.linspace(0, 3, n) for n in shape], indexing="ij")
    v = sum(np.sin(2.1 * a + i) for i, a in enumerate(axes))
    v += 0.05 * rng.standard_normal(shape)
    return (scale * v).astype(np.float64)


def _meta(blob):
    m, _ = Metadata.deserialize(blob)
    return m


@pytest.mark.parametrize("shape", [(33, 34, 35), (64, 64, 64)])
@pytest.mark.parametrize("mode", [error_bound_type.ABS, error_bound_type.REL])
def test_demoted_roundtrip_bound_on_double(shape, mode):
    v = _field(shape)
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol, math.inf, mode)
    assert st == compress_status_type.Success
    m = _meta(blob)
    assert m.demoted, "ample budget must take the demoted fast path"
    from mgard_tpu.dtypes import np_dtype
    assert np_dtype(m.dtype) == np.float64
    out, st = mgard_tpu.decompress(blob)
    assert st == compress_status_type.Success
    assert out.dtype == np.float64 and out.shape == shape
    bound = tol * (np.abs(v).max() if mode == error_bound_type.REL else 1.0)
    assert np.max(np.abs(out - v)) <= bound


def test_tight_tolerance_keeps_native_f64():
    # budget below the cast error: the gate must refuse demotion and the
    # native double transform must still certify the bound
    v = _field((17, 18, 19), scale=1.0)
    cast_err = float(np.max(np.abs(v - v.astype(np.float32).astype(np.float64))))
    assert cast_err > 0
    tol = cast_err  # < 4x cast error -> no demotion
    blob, st = mgard_tpu.compress(v, tol, math.inf, error_bound_type.ABS)
    assert st == compress_status_type.Success
    m = _meta(blob)
    assert not m.demoted
    out, st = mgard_tpu.decompress(blob)
    assert st == compress_status_type.Success
    assert np.max(np.abs(out - v)) <= tol


def test_demote_disabled_by_config():
    v = _field((16, 17, 18))
    cfg = Config()
    cfg.f64_demote = False
    blob, st = mgard_tpu.compress(v, 1e-2, math.inf, error_bound_type.ABS, cfg)
    assert st == compress_status_type.Success
    assert not _meta(blob).demoted


def test_finite_s_never_demotes():
    v = _field((17, 17))
    blob, st = mgard_tpu.compress(v, 1e-2, 0.0, error_bound_type.ABS)
    assert st == compress_status_type.Success
    assert not _meta(blob).demoted


def test_f32_input_unaffected():
    v = _field((16, 16, 16)).astype(np.float32)
    blob, st = mgard_tpu.compress(v, 1e-3, math.inf, error_bound_type.ABS)
    assert st == compress_status_type.Success
    m = _meta(blob)
    assert not m.demoted
    out, st = mgard_tpu.decompress(blob)
    assert out.dtype == np.float32


def test_demoted_flag_versioning():
    # demoted streams must stamp file minor >= 2 so pre-2.2 readers reject
    # them cleanly; plain streams keep the minimum minor
    m = Metadata(shape=(4, 4), demoted=True)
    blob = m.serialize()
    m2, _ = Metadata.deserialize(blob)
    assert m2.demoted
    import struct
    fv = struct.unpack_from("<3B", blob, len(b"MGARDTPU") + 8 + 3)
    assert fv[1] >= 2
    m3 = Metadata(shape=(4, 4), demoted=False)
    fv3 = struct.unpack_from("<3B", m3.serialize(), len(b"MGARDTPU") + 8 + 3)
    assert fv3[1] == 0


def test_demoted_nonuniform_coords():
    shape = (21, 22)
    coords = [np.sort(np.random.default_rng(i).uniform(0, 1, n)) for i, n in enumerate(shape)]
    for c in coords:
        c[0], c[-1] = 0.0, 1.0
    v = _field(shape)
    tol = 5e-3
    blob, st = mgard_tpu.compress(v, tol, math.inf, error_bound_type.ABS,
                                  coords=coords)
    assert st == compress_status_type.Success
    assert _meta(blob).demoted
    out, st = mgard_tpu.decompress(blob)
    assert out.dtype == np.float64
    assert np.max(np.abs(out - v)) <= tol


def test_demoted_domain_decomposed():
    # larger-than-footprint double input: demotion composes with the
    # domain decomposer (subdomain partitioning is computed on the f32
    # image on BOTH sides)
    v = _field((40, 40, 40))
    cfg = Config()
    cfg.max_memory_footprint = 4 * v.size  # force multiple f32 subdomains
    tol = 1e-2
    blob, st = mgard_tpu.compress(v, tol, math.inf, error_bound_type.ABS, cfg)
    assert st == compress_status_type.Success
    m = _meta(blob)
    assert m.demoted and m.domain_decomposed
    out, st = mgard_tpu.decompress(blob)
    assert st == compress_status_type.Success
    assert out.dtype == np.float64
    assert np.max(np.abs(out - v)) <= tol
