"""QoI preservation tests (compression-side linear QoI + MDR V_TOT)."""

import math

import numpy as np

import mgard_tpu
from mgard_tpu import decompress, mdr
from mgard_tpu.config import Config
from mgard_tpu.mdr.qoi import MDReconstructQoI, VTotQoI
from mgard_tpu.qoi import TensorQuantityOfInterest, compress_qoi


def smooth(shape, seed=0):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 1, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    v = np.zeros(shape)
    for _ in range(3):
        ks = rng.integers(1, 4, len(shape))
        acc = rng.uniform(0, 2 * np.pi)
        for k, g in zip(ks, grids):
            acc = acc + 2 * np.pi * k * g
        v += rng.uniform(0.3, 1.0) * np.sin(acc)
    return v


def test_linear_qoi_average_preserved():
    """The domain average (reference: examples/qoi/average.cpp) must be
    preserved to the requested QoI tolerance."""
    v = smooth((65, 65))
    w = np.full(v.shape, 1.0 / v.size)  # average functional
    qoi = TensorQuantityOfInterest(w)
    tol = 1e-5
    for s in [math.inf, 0.0]:
        blob, st, data_tol = compress_qoi(v, qoi, tol, s=s)
        out, _ = decompress(blob)
        dq = abs(qoi(v) - qoi(out))
        assert dq <= tol, f"s={s}: QoI err {dq} > {tol}"


def test_qoi_norms():
    w = np.array([1.0, -2.0, 3.0])
    q = TensorQuantityOfInterest(w)
    assert np.isclose(q.norm(math.inf), 6.0)
    assert np.isclose(q.norm(0.0), math.sqrt(3) * math.sqrt(14))


def test_mdr_vtot_qoi():
    shape = (33, 33)
    cfg = Config()
    cfg.total_num_bitplanes = 12
    vars_true = [smooth(shape, seed=i) + 1.5 for i in range(3)]
    metas, datas = [], []
    for v in vars_true:
        m, d = mdr.MDRefactor(v, cfg)
        metas.append(m)
        datas.append(d)
    qoi = VTotQoI()
    vtot_true = qoi.eval(vars_true)
    tol = 1e-2
    vars_rec, vtot_rec, bound, counts = MDReconstructQoI(metas, datas, tol, qoi)
    assert bound <= tol
    actual = np.max(np.abs(vtot_true - vtot_rec))
    assert actual <= tol, f"QoI actual err {actual} > {tol}"
    # joint planning retrieves fewer planes for some variables than full
    assert any(c < 12 for counts_v in counts for c in counts_v)


def test_mdr_qoi_device_check_survives_corrupted_tables():
    """The acceptance test runs on device against the actual reconstructed
    fields (reference: QoIKernel.hpp:22-147 inside ReconstructPipelineQoI's
    loop), so inflating the stored error tables 50x must still terminate
    with a bound the true QoI error respects."""
    shape = (33, 33)
    cfg = Config()
    cfg.total_num_bitplanes = 12
    vars_true = [smooth(shape, seed=10 + i) + 1.5 for i in range(3)]
    metas, datas = [], []
    for v in vars_true:
        m, d = mdr.MDRefactor(v, cfg)
        metas.append(m)
        datas.append(d)
    qoi = VTotQoI()
    vtot_true = qoi.eval(vars_true)
    tol = 1e-2

    # (a) clean tables: the device bound certifies, is at most the global
    # Lipschitz bound, and the true error respects it
    vars_rec, vtot_rec, bound, counts = MDReconstructQoI(metas, datas, tol, qoi)
    assert bound <= tol
    per_var = [
        __import__("mgard_tpu.mdr.components", fromlist=["estimate_error"])
        .estimate_error(m, c, np.inf)
        for m, c in zip(metas, counts)
    ]
    assert bound <= qoi.bound(per_var) + 1e-12, "device bound looser than Lipschitz"
    assert np.max(np.abs(vtot_true - vtot_rec)) <= bound + 1e-12

    # (b) corrupted (50x inflated) tables: the target tol is unreachable,
    # but the loop escalates to full retrieval and the RETURNED bound is
    # still a correct certificate for the actual reconstruction
    for m in metas:
        for lm in m.levels:
            lm.err_max = lm.err_max * 50.0
            lm.err_sq = lm.err_sq * 2500.0
    vars_rec, vtot_rec, bound, counts = MDReconstructQoI(metas, datas, tol, qoi)
    actual = np.max(np.abs(vtot_true - vtot_rec))
    assert actual <= bound + 1e-12, f"true QoI err {actual} > bound {bound}"
    assert all(
        c == metas[0].number_bitplanes for cv in counts for c in cv
    ), "corrupted tables must escalate to full retrieval"


def test_multilevel_qoi_beats_holder():
    """The multilevel (quantizer-structure) QoI bound must derive a
    measurably larger data tolerance than the global Hoelder dual on the
    average functional, while still preserving the QoI."""
    import numpy as np

    from mgard_tpu.qoi import TensorQuantityOfInterest, compress_qoi
    import mgard_tpu

    shape = (33, 33)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(shape).astype(np.float32)
    w = np.full(shape, 1.0 / v.size)  # average functional
    qoi = TensorQuantityOfInterest(w)
    qtol = 1e-4
    # measured gains: ~7.6x for the RMS-normed path, ~1.3x for L-inf
    for s, min_gain in ((float("inf"), 1.1), (0.0, 2.0)):
        blob_m, st_m, tol_m = compress_qoi(v, qoi, qtol, s=s, method="multilevel")
        blob_h, st_h, tol_h = compress_qoi(v, qoi, qtol, s=s, method="holder")
        assert int(st_m) == 0 and int(st_h) == 0
        assert tol_m > min_gain * tol_h, (s, tol_m, tol_h)
        out, _ = mgard_tpu.decompress(blob_m)
        assert abs(qoi(out) - qoi(v)) <= qtol
        if s == 0.0:
            # the looser data tolerance must pay off in blob size
            assert len(blob_m) <= len(blob_h)


def test_qoi_finite_s_values():
    """Arbitrary finite s through the multilevel Riesz bound (the reference handles any s via TensorQuantityOfInterest component
    norms; here the bound comes from the exact recompose adjoint)."""
    import numpy as np

    import mgard_tpu
    from mgard_tpu.qoi import TensorQuantityOfInterest, compress_qoi

    shape = (17, 33)
    rng = np.random.default_rng(2)
    v = rng.standard_normal(shape).astype(np.float64)
    w = rng.random(shape) / v.size
    qoi = TensorQuantityOfInterest(w)
    qtol = 1e-5
    for s in (0.5, -0.5, 1.0):
        blob, st, data_tol = compress_qoi(v, qoi, qtol, s=s)
        assert int(st) == 0 and data_tol > 0
        out, st2 = mgard_tpu.decompress(blob)
        assert int(st2) == 0
        assert abs(qoi(out) - qoi(v)) <= qtol, s


def test_qoi_decomposed_domain():
    """QoI bound across DomainDecomposer subdomains (per-subdomain Riesz
    factors summed against the local tolerance rule)."""
    import numpy as np

    import mgard_tpu
    from mgard_tpu.dtypes import domain_decomposition_type
    from mgard_tpu.qoi import TensorQuantityOfInterest, compress_qoi

    shape = (24, 9, 9)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(shape).astype(np.float32)
    w = np.full(shape, 1.0 / v.size)
    qoi = TensorQuantityOfInterest(w)
    cfg = mgard_tpu.Config()
    cfg.domain_decomposition = domain_decomposition_type.Variable
    cfg.domain_decomposition_dim = 0
    cfg.domain_decomposition_sizes = [8, 8, 8]
    qtol = 1e-4
    for s in (float("inf"), 0.0, 0.5):
        blob, st, _ = compress_qoi(v, qoi, qtol, s=s, config=cfg)
        assert int(st) == 0
        out, st2 = mgard_tpu.decompress(blob)
        assert int(st2) == 0
        assert abs(qoi(out) - qoi(v)) <= qtol, s


def test_qoi_nonuniform_coords():
    import numpy as np

    import mgard_tpu
    from mgard_tpu.qoi import TensorQuantityOfInterest, compress_qoi

    shape = (17, 17)
    rng = np.random.default_rng(4)
    coords = [np.cumsum(0.5 + rng.random(s)) for s in shape]
    v = rng.standard_normal(shape).astype(np.float64)
    w = rng.random(shape) / v.size
    qoi = TensorQuantityOfInterest(w)
    qtol = 1e-5
    blob, st, _ = compress_qoi(v, qoi, qtol, s=0.0, coords=coords)
    assert int(st) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert abs(qoi(out) - qoi(v)) <= qtol


def test_qoi_certificate_not_voided_by_hybrid_default():
    """compress_qoi's multilevel certificate is derived from the MultiDim
    quantizer structure; with the Hybrid default Config and a large
    x8-friendly f32 array (the _hybrid_worthwhile regime) the compressor
    must fall back to MultiDim — and the QoI bound must actually hold."""
    from mgard_tpu.dtypes import decomposition_type
    from mgard_tpu.formats.metadata import Metadata

    v = smooth((64, 64, 64)).astype(np.float32)
    w = np.full(v.shape, 1.0 / v.size)
    qoi = TensorQuantityOfInterest(w)
    tol = 1e-6
    blob, st, data_tol = compress_qoi(v, qoi, tol, s=math.inf)
    assert int(st) == 0
    meta, _ = Metadata.deserialize(bytes(blob))
    assert meta.decomposition != decomposition_type.Hybrid, (
        "QoI compression must not route through the Hybrid (L-inf only) path"
    )
    out, _ = decompress(blob)
    dq = abs(qoi(v) - qoi(out))
    assert dq <= tol, f"QoI err {dq} > {tol}"
