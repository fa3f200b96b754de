"""Multi-device sharded compression on the virtual 8-device CPU mesh.

Mirrors how the reference exercises its MPI scale-out (pmdr-x-qoi.cpp:
rank-per-GPU independent compression + Allreduce norms); here the mesh is
8 virtual CPU devices (conftest forces xla_force_host_platform_device_count).
"""

import math

import jax
import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.parallel import (
    compress_sharded,
    decompress_sharded,
    make_subdomain_mesh,
)


def _field(shape, dtype=np.float32):
    rng = np.random.default_rng(7)
    return rng.standard_normal(shape).astype(dtype)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    return make_subdomain_mesh(8)


def test_sharded_linf_bound(mesh):
    v = _field((8 * 9, 17, 9))
    blob, st = compress_sharded(v, tol=1e-2, s=math.inf, mesh=mesh)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert np.max(np.abs(out - v)) <= 1e-2


def test_sharded_l2_rel_bound(mesh):
    v = _field((8 * 9, 17, 9))
    blob, st = compress_sharded(
        v, tol=1e-2, s=0.0, mode=mgard_tpu.error_bound_type.REL, mesh=mesh
    )
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    l2 = np.sqrt(np.mean((out - v).astype(np.float64) ** 2))
    l2v = np.sqrt(np.mean(v.astype(np.float64) ** 2))
    assert l2 <= 1e-2 * l2v


def test_sharded_matches_single_device_bound(mesh):
    """The sharded blob must decompress to the same data quality as the
    single-device path at the same settings."""
    v = _field((8 * 5, 9, 9))
    blob_s, _ = compress_sharded(v, tol=1e-3, s=math.inf, mesh=mesh)
    out_s, _ = mgard_tpu.decompress(blob_s)
    assert np.max(np.abs(out_s - v)) <= 1e-3


def test_sharded_indivisible_leading_dim(mesh):
    """Arbitrary leading dims: equal chunks on the mesh + a remainder
    subdomain on the single-device path (r2 required divisibility)."""
    v = _field((8 * 6 + 5, 9, 9))
    blob, st = compress_sharded(v, tol=1e-2, s=math.inf, mesh=mesh)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert out.shape == v.shape
    assert np.max(np.abs(out - v)) <= 1e-2


def test_sharded_float64_no_silent_cast(mesh):
    """f64 data compresses in f64: a tolerance far below f32 resolution must
    hold (the f32 downcast silently violated the stated bound)."""
    rng = np.random.default_rng(3)
    v = rng.standard_normal((8 * 4, 9, 9)).astype(np.float64)
    # far below f32 resolution on O(1) data (~2.4e-7 cast error) but well
    # inside int32 symbol range
    tol = 1e-7
    blob, st = compress_sharded(v, tol=tol, s=math.inf, mesh=mesh)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert out.dtype == np.float64
    assert np.max(np.abs(out - v)) <= tol


def test_sharded_rejects_tiny_leading_dim(mesh):
    v = _field((5, 9, 9))
    with pytest.raises(ValueError):
        compress_sharded(v, tol=1e-2, mesh=mesh)


def test_sharded_rejects_negative_s(mesh):
    # negative s needs the geometry-true non-uniform dist chain (see
    # highlevel.compress routing); the sharded path builds uniform
    # hierarchies only, so it must refuse rather than ship a stream with
    # a silently weaker certificate.
    v = _field((8 * 2, 9, 9))
    with pytest.raises(ValueError, match="negative s"):
        compress_sharded(v, tol=1e-2, s=-1.0, mesh=mesh)


def test_sharded_rejects_non_bfx_config(mesh):
    v = _field((8 * 2, 9, 9))
    cfg = mgard_tpu.Config()
    cfg.lossless = mgard_tpu.lossless_type.Huffman
    with pytest.raises(ValueError):
        compress_sharded(v, tol=1e-2, config=cfg, mesh=mesh)


def test_decompress_sharded_roundtrip(mesh):
    v = _field((8 * 9, 17, 9))
    blob, st = compress_sharded(v, tol=1e-2, s=math.inf, mesh=mesh)
    assert int(st) == 0
    out, st2 = decompress_sharded(blob, mesh=mesh)
    assert int(st2) == 0
    assert out.shape == v.shape
    assert np.max(np.abs(out - v)) <= 1e-2


def test_decompress_sharded_reads_single_device_blob(mesh):
    """decompress_sharded must read blobs written by the regular
    single-device compress() (BFX backend, domain-decomposed)."""
    v = _field((64, 9, 9))
    cfg = mgard_tpu.Config()
    cfg.domain_decomposition = mgard_tpu.domain_decomposition_type.Variable
    cfg.domain_decomposition_dim = 0
    cfg.domain_decomposition_sizes = [8] * 8
    blob, st = mgard_tpu.compress(v, tol=1e-2, config=cfg)
    assert int(st) == 0
    out, st2 = decompress_sharded(blob, mesh=mesh)
    assert int(st2) == 0
    assert np.max(np.abs(out - v)) <= 1e-2


def test_decompress_sharded_remainder_and_f64(mesh):
    rng = np.random.default_rng(11)
    v = rng.standard_normal((8 * 3 + 2, 9, 9)).astype(np.float64)
    blob, st = compress_sharded(v, tol=1e-8, s=math.inf, mesh=mesh)
    assert int(st) == 0
    out, st2 = decompress_sharded(blob, mesh=mesh)
    assert int(st2) == 0
    assert out.dtype == np.float64
    assert np.max(np.abs(out - v)) <= 1e-8


def test_mdr_sharded_bfx_planes_roundtrip(mesh, monkeypatch):
    """The sharded refactor writer must support every plane codec the
    readers do: with mdr_level_compressor='bfx' the
    BFX-coded planes must reconstruct through BOTH the sharded and the
    host (decomposed) reconstruct paths."""
    from mgard_tpu import Config
    from mgard_tpu.mdr import MDReconstructDecomposed, MDRequestDecomposed
    from mgard_tpu.mdr import api as mdr_api
    from mgard_tpu.parallel import MDReconstructSharded, MDRefactorSharded

    # small planes still go through BFX (the production gate only guards
    # dispatch overhead, not correctness)
    monkeypatch.setattr(mdr_api, "PLANE_BFX_MIN_WORDS", 1)
    cfg = Config()
    cfg.mdr_level_compressor = "bfx"
    rng = np.random.default_rng(23)
    # small noise + one spike per subdomain: the top magnitude bitplanes
    # are nearly all-zero, so BFX actually beats raw at this size
    v = (1e-3 * rng.standard_normal((8 * 8, 17, 33))).astype(np.float32)
    v[::8, 0, 0] = 1.0
    dmdr, _ = MDRefactorSharded(v, config=cfg)
    assert any(
        c == mdr_api.PLANE_BFX
        for m in dmdr.metas for lv in m.levels for c in lv.plane_raw
    ), "no plane actually took the BFX codec"
    plans = MDRequestDecomposed(dmdr, 1e-2)
    shared = [max(p[l] for p in plans) for l in range(len(plans[0]))]
    out = MDReconstructSharded(dmdr, shared)
    assert np.max(np.abs(out - v)) <= 1e-2
    out2 = MDReconstructDecomposed(dmdr, plans)
    assert np.max(np.abs(out2 - v)) <= 1e-2


def test_mdr_sharded_roundtrip(mesh):
    """Sharded MDR refactor + sharded reconstruct (the reference's actual
    distributed workload, pmdr-x-qoi.cpp) on the virtual mesh."""
    from mgard_tpu.mdr import MDRequestDecomposed
    from mgard_tpu.parallel import MDReconstructSharded, MDRefactorSharded

    rng = np.random.default_rng(20)
    v = rng.standard_normal((8 * 4, 9, 9)).astype(np.float32)
    dmdr, (gmin, gmax) = MDRefactorSharded(v)
    assert abs(gmin - v.min()) < 1e-6 and abs(gmax - v.max()) < 1e-6
    assert len(dmdr.metas) == 8
    for tol in (1e-1, 1e-2):
        plans = MDRequestDecomposed(dmdr, tol)
        # homogeneous data -> shared plan; take the per-level max for safety
        shared = [max(p[l] for p in plans) for l in range(len(plans[0]))]
        out = MDReconstructSharded(dmdr, shared)
        assert np.max(np.abs(out - v)) <= tol


def test_mdr_sharded_matches_host_decomposed(mesh):
    """Sharded refactor output must reconstruct identically through the
    host (MDReconstructDecomposed) path."""
    from mgard_tpu.mdr import MDReconstructDecomposed, MDRequestDecomposed
    from mgard_tpu.parallel import MDRefactorSharded

    rng = np.random.default_rng(21)
    v = rng.standard_normal((8 * 3, 9, 9)).astype(np.float32)
    dmdr, _ = MDRefactorSharded(v)
    plans = MDRequestDecomposed(dmdr, 1e-2)
    out = MDReconstructDecomposed(dmdr, plans)
    assert np.max(np.abs(out - v)) <= 1e-2


def test_mdr_sharded_qoi_plan(mesh):
    """QoI-driven retrieval planning over sharded MDR output (the
    pmdr-x-qoi pipeline shape: refactor per rank, plan jointly)."""
    from mgard_tpu.mdr import MDRequestDecomposed
    from mgard_tpu.parallel import MDReconstructSharded, MDRefactorSharded

    rng = np.random.default_rng(22)
    v = (rng.standard_normal((8 * 4, 9, 9)) + 3.0).astype(np.float32)
    dmdr, (gmin, gmax) = MDRefactorSharded(v)
    # QoI: V_TOT-style scale from the global range (the Allreduce product)
    qoi_tol = 1e-2 * max(abs(gmin), abs(gmax))
    plans = MDRequestDecomposed(dmdr, qoi_tol)
    shared = [max(p[l] for p in plans) for l in range(len(plans[0]))]
    out = MDReconstructSharded(dmdr, shared)
    assert np.max(np.abs(out - v)) <= qoi_tol
