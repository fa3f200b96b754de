"""Deliberate on-card smoke matrix.

These tests carry the ``gpu`` marker and run only with MGARD_TEST_GPU=1
(the conftest otherwise pins the suite to CPU): a small end-to-end matrix
on the real device, including the float64 paths and the hybrid front-end.
On the card: ``MGARD_TEST_GPU=1 python -m pytest -m gpu
tests/test_gpu_smoke.py -q`` (one process — no ``-n``).
"""

import math
import os

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu import Config
from mgard_tpu.dtypes import compress_status_type, decomposition_type

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _on_gpu():
    """The card decision is made here, per test, never at import time."""
    if not os.environ.get("MGARD_TEST_GPU"):
        pytest.skip("on-card smoke matrix is opt-in (MGARD_TEST_GPU=1)")
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.fail(f"MGARD_TEST_GPU=1 but JAX found {dev.platform}, not a GPU")


def _field(shape, dtype):
    axes = [np.linspace(0, 1, n) for n in shape]
    G = np.meshgrid(*axes, indexing="ij")
    v = np.sin(4 * np.pi * G[0])
    if len(G) > 1:
        v = v * np.cos(3 * np.pi * G[-1])
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_e2e_on_device(dtype):
    v = _field((128, 128, 128), dtype)
    blob, st = mgard_tpu.compress(v, tol=1e-4, s=math.inf)
    assert st == compress_status_type.Success
    out, st2 = mgard_tpu.decompress(blob)
    assert st2 == compress_status_type.Success
    assert float(np.max(np.abs(out - v))) <= 1e-4


def test_hybrid_on_device():
    v = _field((128, 128, 128), np.float32)
    cfg = Config()
    cfg.decomposition = decomposition_type.Hybrid
    blob, st = mgard_tpu.compress(v, tol=1e-4, s=math.inf, config=cfg)
    assert st == compress_status_type.Success
    out, st2 = mgard_tpu.decompress(blob)
    assert st2 == compress_status_type.Success
    assert float(np.max(np.abs(out - v))) <= 1e-4


def test_s_norm_on_device():
    v = _field((64, 64, 64), np.float32)
    blob, st = mgard_tpu.compress(
        v, tol=1e-3, s=0.0, mode=mgard_tpu.error_bound_type.REL
    )
    assert st == compress_status_type.Success
    out, st2 = mgard_tpu.decompress(blob)
    assert st2 == compress_status_type.Success
    l2 = np.sqrt(np.mean((out - v).astype(np.float64) ** 2))
    l2v = np.sqrt(np.mean(v.astype(np.float64) ** 2))
    assert l2 <= 1e-3 * l2v


def test_f64_demoted_fast_path_on_device():
    """Double rides the f32 flagship pipeline when the budget covers the
    cast error; bound certified on the DOUBLE data."""
    from mgard_tpu.formats.metadata import Metadata

    v = _field((128, 128, 128), np.float64)
    tol = 1e-4
    blob, st = mgard_tpu.compress(v, tol=tol, s=math.inf)
    assert st == compress_status_type.Success
    m, _ = Metadata.deserialize(blob)
    assert m.demoted
    out, st2 = mgard_tpu.decompress(blob)
    assert st2 == compress_status_type.Success
    assert out.dtype == np.float64
    assert float(np.max(np.abs(out - v))) <= tol


def test_f64_native_tight_tolerance_on_device():
    """Budget below the f64->f32 cast error: the native double transform
    must carry the bound on the card."""
    from mgard_tpu.formats.metadata import Metadata

    v = _field((48, 48, 48), np.float64)
    cast_err = float(np.max(np.abs(v - v.astype(np.float32).astype(np.float64))))
    tol = max(cast_err, 1e-12)
    blob, st = mgard_tpu.compress(v, tol=tol, s=math.inf)
    assert st == compress_status_type.Success
    m, _ = Metadata.deserialize(blob)
    assert not m.demoted
    out, st2 = mgard_tpu.decompress(blob)
    assert st2 == compress_status_type.Success
    assert float(np.max(np.abs(out - v))) <= tol


def test_non_uniform_coords_on_device():
    shape = (96, 96, 96)
    rng = np.random.default_rng(2)
    coords = [np.sort(rng.uniform(0, 1, n)) for n in shape]
    for c in coords:
        c[0], c[-1] = 0.0, 1.0
    v = _field(shape, np.float32)
    blob, st = mgard_tpu.compress(v, tol=1e-3, s=math.inf, coords=coords)
    assert st == compress_status_type.Success
    out, st2 = mgard_tpu.decompress(blob)
    assert st2 == compress_status_type.Success
    assert float(np.max(np.abs(out - v))) <= 1e-3


def test_mdr_progressive_reconstruct_on_device():
    """MDR refactor + two-round incremental retrieval on the card:
    each round's reconstruction must meet its requested tolerance."""
    from mgard_tpu.mdr.api import MDReconstruct, MDRefactor, MDRequest

    v = _field((96, 96, 96), np.float32)
    meta, data = MDRefactor(v)
    for tol in (1e-2, 1e-4):
        counts = MDRequest(meta, tol)
        meta.prev_used = []
        rec = MDReconstruct(meta, data, counts)
        assert float(np.max(np.abs(rec.data - v))) <= tol
