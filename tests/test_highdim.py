"""4D/5D end-to-end coverage (untested dimensions are assumed
broken). The reference instantiates and ships D=1..5
(reference: include/compress_x.hpp:31-159; examples/xgc-casestudy/
TestXGC4DNonuniform.cpp, TestXGC5DTemporal.cpp)."""

import math

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.dtypes import decomposition_type, error_bound_type, lossless_type


def _smooth(shape, dtype):
    rng = np.random.default_rng(5)
    axes = [np.linspace(0, 1, s) for s in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    v = np.zeros(shape)
    for _ in range(3):
        ks = rng.integers(1, 4, len(shape))
        ph = rng.uniform(0, 2 * np.pi)
        acc = ph
        for g, k in zip(grids, ks):
            acc = acc + 2 * np.pi * k * g
        v = v + rng.uniform(0.3, 1.0) * np.sin(acc)
    return v.astype(dtype)


@pytest.mark.parametrize("shape", [(9, 10, 11, 12), (5, 6, 7, 8, 9)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_linf_bound_4d5d(shape, dtype):
    v = _smooth(shape, dtype)
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol=tol, s=math.inf)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert out.shape == v.shape and out.dtype == v.dtype
    assert np.max(np.abs(out - v)) <= tol


@pytest.mark.parametrize("shape", [(9, 10, 11, 12), (5, 6, 7, 8, 9)])
def test_l2_rel_bound_4d5d(shape):
    v = _smooth(shape, np.float64)
    tol = 1e-3
    blob, st = mgard_tpu.compress(
        v, tol=tol, s=0.0, mode=error_bound_type.REL
    )
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    l2 = np.sqrt(np.mean((out - v) ** 2))
    l2v = np.sqrt(np.mean(v**2))
    assert l2 <= tol * l2v


@pytest.mark.parametrize("shape", [(9, 10, 11, 12), (5, 6, 7, 8, 9)])
def test_singledim_4d5d(shape):
    v = _smooth(shape, np.float32)
    tol = 1e-2
    cfg = mgard_tpu.Config()
    cfg.decomposition = decomposition_type.SingleDim
    blob, st = mgard_tpu.compress(v, tol=tol, config=cfg)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert np.max(np.abs(out - v)) <= tol


@pytest.mark.parametrize("shape", [(9, 10, 11, 12)])
def test_hybrid_4d_falls_back_correctly(shape):
    """Hybrid decomposition on 4D: the fused kernel only covers D<=3; the
    XLA path must still honor the bound (or cleanly refuse)."""
    v = _smooth(shape, np.float32)
    tol = 1e-2
    cfg = mgard_tpu.Config()
    cfg.decomposition = decomposition_type.Hybrid
    blob, st = mgard_tpu.compress(v, tol=tol, config=cfg)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert np.max(np.abs(out - v)) <= tol


def test_nonuniform_4d():
    """Non-uniform coords in 4D (reference: TestXGC4DNonuniform.cpp)."""
    shape = (9, 10, 11, 8)
    rng = np.random.default_rng(0)
    coords = [np.cumsum(0.5 + rng.random(s)) for s in shape]
    v = _smooth(shape, np.float64)
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol=tol, coords=coords)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert np.max(np.abs(out - v)) <= tol


@pytest.mark.parametrize("shape", [(9, 10, 11, 12), (5, 6, 7, 8, 9)])
def test_mdr_4d5d(shape):
    from mgard_tpu.mdr import MDReconstruct, MDRefactor, MDRequest

    v = _smooth(shape, np.float32)
    meta, data = MDRefactor(v)
    for tol in (1e-1, 1e-2):
        counts = MDRequest(meta, tol)
        rec = MDReconstruct(meta, data, counts)
        assert np.max(np.abs(rec.data - v)) <= tol


def test_six_d_rejected():
    v = np.zeros((2, 2, 2, 2, 2, 2), np.float32)
    blob, st = mgard_tpu.compress(v, tol=1e-3)
    assert int(st) == int(
        mgard_tpu.compress_status_type.NotSupportHigherNumberOfDimensionsFailure
    )
