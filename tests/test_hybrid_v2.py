"""Hybrid v2 one-pass front-end (hybrid front-end flag 1).

local_transform_v2_xla must emit exactly the flag-0 transform's symbols
(zigzagged, z-class grouped, u16) plus true chunk widths, its inverse must
round-trip, and compress() must write flag 1 for every shape the stream
format admits — falling back to flag 0 when a chunk needs more than 16
bits. Any device decodes any stream (reference parity:
compress_internal.cpp:5-13).
"""

import struct

import numpy as np

import jax.numpy as jnp

import mgard_tpu
import mgard_tpu.highlevel as H
from mgard_tpu.formats.metadata import Metadata
from mgard_tpu.hierarchy import get_hierarchy
from mgard_tpu.ops import hybrid as Hy


SHAPE = (16, 16, 128)
NL = 3
C = 4  # Z=128 -> chunk rows of C*32=128 lanes tile the axis exactly


def _field(shape):
    rng = np.random.default_rng(3)
    x = np.linspace(0, 1, shape[0], dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        * np.cos(np.linspace(0, 3, shape[1], dtype=np.float32))[None, :, None]
        + np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :] ** 2
        + 0.05 * rng.standard_normal(shape).astype(np.float32)
    )
    return jnp.asarray(v)


def _hybrid_flag(blob) -> int:
    """Front-end flag byte of the first (only) subdomain section."""
    _meta, off = Metadata.deserialize(blob)
    return blob[off + 8 + len(H._empty_outliers())]


def _hybrid_setup(shape, tol):
    padded = Hy.pad_to8(shape)
    rem_hier = get_hierarchy(Hy.remainder_shape(padded, NL), np.float32,
                             None, mgard_tpu.Config())
    q = H._hybrid_quantizer(tol, Hy.hybrid_l_total(padded, NL, rem_hier))
    return padded, rem_hier, jnp.float32(q)


def _unzigzag(zz):
    zz = np.asarray(zz).astype(np.int64)
    return (zz >> 1) ^ -(zz & 1)


def test_v2_symbols_match_flag0_transform():
    """The v2 payload is the flag-0 front-end's grouped cf symbols in
    zigzag u16 form, cw their true chunk widths, and the remainder symbols
    are the flag-0 stream's tail."""
    padded, rem_hier, q = _hybrid_setup(SHAPE, 1e-3)
    v = _field(SHAPE)
    sym0 = np.asarray(H._compress_core_hybrid(v, q, padded, NL, rem_hier,
                                              zgroup=True))
    pay, cw, rem_sym = H._compress_core_hybrid_v2(v, q, padded, NL,
                                                  rem_hier, C)
    n_cf = int(np.prod(padded))
    assert int(jnp.max(cw)) <= 16, "test field must fit the u16 budget"
    cf1 = _unzigzag(pay).ravel()
    cf0 = sym0[:n_cf].astype(np.int64)
    # same arithmetic in two XLA graphs: only one-step flips at .5 ties
    mism = cf1 != cf0
    assert mism.mean() < 1e-4, mism.mean()
    assert np.abs(cf1 - cf0)[mism].max(initial=0) <= 1
    np.testing.assert_array_equal(np.asarray(rem_sym), sym0[n_cf:])
    rows = np.asarray(pay).astype(np.int64).reshape(-1, C * 32)
    mx = rows.max(axis=1)
    want = np.where(mx == 0, 0, np.floor(np.log2(np.maximum(mx, 1))) + 1)
    np.testing.assert_array_equal(np.asarray(cw), want.astype(np.int32))


def test_v2_inverse_roundtrips():
    v = _field(SHAPE)
    q = jnp.float32(1.7e-4)
    pay, cw, rem_c = Hy.local_transform_v2_xla(v, 1.0 / q, NL, C)
    rem_shape = Hy.remainder_shape(SHAPE, NL)
    out = Hy.local_inverse_v2_xla(pay, rem_c.reshape(rem_shape), q, NL,
                                  jnp.float32)
    # the remainder rides exactly, so cf quantization is the only loss
    err = float(jnp.max(jnp.abs(out - v)))
    assert err <= float(q) * (NL + 2), err


def test_v2_wide_chunks_fall_back_to_flag0():
    """Chunks wider than 16 bits cannot ride the u16 payload: compress()
    must write the flag-0 layout instead, and it must hold the bound."""
    # noise of amplitude ~5 against a 1e-3 bound: symbols far past 2^15
    v = np.asarray(_field((64, 64, 128))) * 100
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol=tol, s=np.inf)
    assert int(st) == 0
    assert _hybrid_flag(blob) == 0
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= tol


def test_v2_long_last_axis_via_compress():
    """Z=768: the chunk pick drops to C=8 (16*32 does not divide 768) and
    the stream still rides flag 1 through the public API."""
    shape = (16, 128, 768)
    assert H._pick_v2_chunk(shape, mgard_tpu.Config()) == 8
    v = np.asarray(_field(shape))
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol=tol, s=np.inf)
    assert int(st) == 0
    assert _hybrid_flag(blob) == 1
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= tol


def test_default_compress_writes_flag1():
    """Nothing but the stream format gates v2: a default compress() of an
    admitted 3D shape writes flag 1 on whatever backend runs it."""
    shape = (64, 64, 128)
    assert H._hybrid_v2_ok(shape, np.float32, mgard_tpu.Config())
    v = np.asarray(_field(shape))
    blob, st = mgard_tpu.compress(v, tol=1e-3)
    assert int(st) == 0
    assert _hybrid_flag(blob) == 1


def test_v2_stream_decodes_through_public_api():
    """A v2-layout blob (BFP5 prepared cf stream + rem section) written by
    compress() decompresses through the public API within the bound."""
    # smallest shape satisfying the v2 stream invariant
    # (N % (SB_BLOCKS * 32) == 0): one full superblock
    v = np.asarray(_field((64, 64, 128)))
    cfg = mgard_tpu.Config()
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol=tol, config=cfg)
    assert int(st) == 0
    # the v2 flag byte must actually be in the stream (not legacy fallback)
    assert _hybrid_flag(blob) == 1
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    err = float(np.max(np.abs(out.astype(np.float64) - v)))
    assert err <= tol, err


def test_v2_stream_honors_tuned_superblock():
    """An autotuned/explicit Config.bfp_sb_blocks must reach the v2 cf
    stream (sb rides in the blob header, so any admitted value decodes)."""
    from mgard_tpu.lossless import bfp

    v = np.asarray(_field((64, 64, 128)))
    cfg = mgard_tpu.Config()
    cfg.bfp_sb_blocks = 8192
    tol = 1e-3
    blob, st = mgard_tpu.compress(v, tol=tol, config=cfg)
    assert int(st) == 0
    # the cf stream's recorded superblock must be the tuned one
    assert _hybrid_flag(blob) == 1
    idx = bytes(blob).find(b"BFP5")
    assert idx >= 0
    _m, _n, _rr, _K, _E, sb_rec, _C, _cnt = struct.unpack_from(bfp._HDR, blob,
                                                               idx)
    assert sb_rec == 8192, sb_rec
    out, st2 = mgard_tpu.decompress(blob)
    assert int(st2) == 0
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= tol


def test_stale_sticky_K_rechoose():
    """Compressing the same shape at a coarser then a FINER tolerance must
    keep the fast flag-1 format: the serializer re-chooses K from the
    fresh widths when the cached K undersizes them, instead of dropping
    to the legacy path (and it refreshes the cache)."""
    from mgard_tpu.lossless import bfp as _bfp

    shape = (16, 128, 256)
    v = np.asarray(_field(shape)).astype(np.float32)
    n_cf = int(np.prod(shape))
    E = 8
    key = ("v2", n_cf, E, H._pick_v2_chunk(shape, mgard_tpu.Config()), 0)
    _bfp._K_CACHE.pop(key, None)
    b1, s1 = mgard_tpu.compress(v, tol=1e-2, s=np.inf,
                                mode=mgard_tpu.error_bound_type.ABS)
    assert int(s1) == 0 and key in _bfp._K_CACHE
    K1 = _bfp._K_CACHE[key][0]
    # 1e-4 widens widths by ~7 bits but stays inside the u16 budget
    # (1e-5 would overflow u16 entirely -> the legitimate legacy path)
    b2, s2 = mgard_tpu.compress(v, tol=1e-4, s=np.inf,
                                mode=mgard_tpu.error_bound_type.ABS)
    assert int(s2) == 0
    K2 = _bfp._K_CACHE[key][0]
    assert K2 > K1, (K1, K2)  # cache refreshed for the finer widths
    # both streams stay on the fast flag-1 format
    assert _hybrid_flag(b1) == 1 and _hybrid_flag(b2) == 1
    for blob, tol in ((b1, 1e-2), (b2, 1e-4)):
        out, st = mgard_tpu.decompress(blob)
        assert int(st) == 0
        assert float(np.max(np.abs(out - v))) <= tol
    _bfp._K_CACHE.pop(key, None)


def test_route_and_superblock_choice_ignore_backend(monkeypatch):
    """The v2 gate and the BFP/BFX superblock picks depend on sizes and
    the stream format alone, never on which backend JAX reports."""
    import jax

    from mgard_tpu.lossless import bfp, bfx

    shapes = [(64, 64, 128), (16, 128, 768), (64, 64, 64), (512, 512, 512)]
    sizes = [1000, bfx.SB_BLOCKS * 32, bfp.SB_BLOCKS * 32 - 1,
             bfp.SB_BLOCKS * 32, 1 << 27]
    seen = []
    for backend in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        cfg = mgard_tpu.Config()
        seen.append((
            [H._hybrid_v2_ok(s, np.float32, cfg) for s in shapes],
            [bfp._choose_sb(n) for n in sizes],
            [bfx._choose_sb(n) for n in sizes],
        ))
    assert seen[0] == seen[1] == seen[2]
    gate, sb_p, sb_x = seen[0]
    assert gate == [True, True, False, True]
    assert sb_p == [bfp.SB_BLOCKS_SMALL] * 3 + [bfp.SB_BLOCKS] * 2
    assert sb_x == [bfx.SB_BLOCKS_SMALL] + [bfx.SB_BLOCKS] * 4
