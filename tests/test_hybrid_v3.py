"""Hybrid front-end flag 2 (v3 streams): decode only.

A v3 stream ties each (8, 128, Z) transform tile to one BFP superblock
(sb = 32*Z, sbc = 1024 chunks of C = Z/32 blocks) with the residual bands
in static slots and the chunks in tile-major order. This build writes no
v3 streams; tests/golden/hybrid_v3_flag2_16x128x256_f32.mgard (written by
the last encoder, at tol=1e-3 ABS, s=inf, from _field(GOLDEN_SHAPE,
seed=9)) pins the decoder: wire round trip, public-API decode within the
bound, and clean rejection of a corrupted geometry."""

import os
import struct

import numpy as np

import jax.numpy as jnp

import mgard_tpu
from mgard_tpu.lossless import bfp
from mgard_tpu.ops import hybrid as Hy
from mgard_tpu.utils.bytesink import join

SHAPE = (16, 256, 256)
GOLDEN_SHAPE = (16, 128, 256)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "hybrid_v3_flag2_16x128x256_f32.mgard")


def _field(shape, seed=5):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 1, shape[0], dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        * np.cos(np.linspace(0, 3, shape[1], dtype=np.float32))[None, :, None]
        + np.linspace(-1, 1, shape[2], dtype=np.float32)[None, None, :] ** 2
        + 0.05 * rng.standard_normal(shape).astype(np.float32)
    )
    return jnp.asarray(v)


def _golden() -> bytes:
    with open(GOLDEN, "rb") as f:
        return f.read()


def _hybrid_flag(blob: bytes) -> int:
    """The hybrid front-end flag byte sits 9 bytes before the cf blob's
    BFP5 magic (flag u8 + cf_len u64) for flag-1/2 streams."""
    i = bytes(blob).index(b"BFP5")
    return blob[i - 9]


def test_v3_wire_roundtrip_static_cap():
    """The golden's cf stream is plain BFP5 on the wire: expanded into the
    v3 fixed-slot device layout (static_cap) or the banded layout, it
    decodes to the same rows, and the banded layout re-serializes byte for
    byte — the fixed slots carry no wire padding."""
    blob = _golden()
    assert _hybrid_flag(blob) == 2
    i = blob.index(b"BFP5")
    (cf_len,) = struct.unpack_from("<Q", blob, i - 8)
    base, crl, rbuf, (n, K, E, sb, C), used = bfp.deserialize_prepared(
        blob, i, static_cap=True
    )
    assert used == cf_len
    Z = GOLDEN_SHAPE[2]
    assert (n, sb, C) == (int(np.prod(GOLDEN_SHAPE)), 32 * Z, Z // 32)
    base2, crl2, rbuf2, _, _ = bfp.deserialize_prepared(blob, i)
    rows_static = bfp.decode_core_zz(base, crl, rbuf, K, E, sb, n // 32, C,
                                     static_cap=True)
    rows_banded = bfp.decode_core_zz(base2, crl2, rbuf2, K, E, sb, n // 32,
                                     C)
    np.testing.assert_array_equal(np.asarray(rows_static),
                                  np.asarray(rows_banded))
    crl_h = np.asarray(crl)
    cnt = bfp._band_geometry(crl_h, E, C, sb)[0]
    rows_used = int((-(-cnt // bfp.LANES) * C).sum())
    parts = bfp.serialize_prepared_parts(n, K, E, sb, C, crl_h, base2,
                                         rbuf2, rows_used)
    assert join(parts) == blob[i : i + cf_len]
    wire_words = bfp.resid_wire_words(crl_h, E, C, sb)
    assert cf_len < wire_words * 4 + K * (n // 32) * 4 + 4096 + len(crl)


def test_v3_tilemajor_order_helpers_invert():
    """rows_tilemajor_field inverts the v3 chunk order: (8, 128) tiles of
    leading positions in (gx, gy) order, row-major inside each tile."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 16, SHAPE).astype(np.uint16)
    X, Y, Z = SHAPE
    rows = [a[gx * 8 + i, gy * 128 + j]
            for gx in range(X // 8) for gy in range(Y // 128)
            for i in range(8) for j in range(128)]
    back = Hy.rows_tilemajor_field(jnp.asarray(np.stack(rows)), SHAPE)
    np.testing.assert_array_equal(np.asarray(back), a)


def test_v3_stream_via_public_api_cpu():
    """The flag-2 golden decodes through the public decompress() within
    its bound."""
    v = np.asarray(_field(GOLDEN_SHAPE, seed=9))
    out, st = mgard_tpu.decompress(_golden())
    assert int(st) == 0
    assert out.shape == GOLDEN_SHAPE and out.dtype == np.float32
    err = float(np.max(np.abs(out - v)))
    assert err <= 1e-3, err


def test_v3_shape_gate():
    assert Hy.v3_ok_shape((8, 128, 512))
    assert Hy.v3_ok_shape((64, 256, 768))
    assert not Hy.v3_ok_shape((8, 128))          # not 3D
    assert not Hy.v3_ok_shape((12, 128, 512))    # X % 8
    assert not Hy.v3_ok_shape((8, 64, 512))      # Y % 128
    assert not Hy.v3_ok_shape((8, 128, 96))      # Z < 128
    assert not Hy.v3_ok_shape((8, 128, 1152))    # Z > 1024


def test_v3_flag_rejects_bad_geometry():
    """A flag-2 stream whose BFP5 header does not match the v3 tile=SB
    scheme must raise FormatError (clean rejection), not crash in a
    reshape."""
    blob = _golden()
    assert _hybrid_flag(blob) == 2
    # corrupt the BFP5 header's sb field (offset: magic4 + n8 + rows8 +
    # K1 + E1 -> sb u32); the v3 branch must reject sb != 32*Z
    # (Z=256 -> the correct sb IS 8192, so write a genuinely wrong value)
    i = blob.index(b"BFP5")
    bad = bytearray(blob)
    struct.pack_into("<I", bad, i + 22, 16384)
    out, st2 = mgard_tpu.decompress(bytes(bad))
    assert out is None and int(st2) != 0


def test_minor_version_forward_rejection(monkeypatch):
    """Streams with a HIGHER minor file version than this build must be
    rejected cleanly (they may carry front-end flags this build cannot
    parse). Written with a VALID CRC so the version gate itself is what
    rejects."""
    import struct as S
    import zlib as _zlib

    from mgard_tpu.formats import metadata as M

    v = np.linspace(0, 1, 4096, dtype=np.float32).reshape(16, 16, 16)
    blob, st = mgard_tpu.compress(v, tol=1e-3, s=np.inf,
                                  mode=mgard_tpu.error_bound_type.ABS)
    assert int(st) == 0
    # streams stamp the MINIMUM minor their features need; forge a
    # future minor (with a valid CRC) to exercise the forward gate
    buf = bytearray(blob)
    hdr = len(M.MAGIC)
    (size,) = S.unpack_from("<I", buf, hdr)
    body_off = hdr + 8
    buf[body_off + 4] = M.FILE_VERSION[1] + 1  # file-version minor byte
    crc = _zlib.crc32(bytes(buf[body_off : body_off + size])) & 0xFFFFFFFF
    S.pack_into("<II", buf, hdr, size, crc)
    out, st2 = mgard_tpu.decompress(bytes(buf))
    assert out is None and int(st2) != 0


def test_wire_minor_is_minimum_needed():
    """Flag-0/1 streams must stamp file minor 0 (2.0-reader parseable);
    only fused-v3 (flag-2) sections require minor 1."""
    from mgard_tpu.formats import metadata as M

    v = np.linspace(0, 1, 4096, dtype=np.float32).reshape(16, 16, 16)
    blob, st = mgard_tpu.compress(v, tol=1e-3, s=np.inf,
                                  mode=mgard_tpu.error_bound_type.ABS)
    assert int(st) == 0
    body_off = len(M.MAGIC) + 8
    assert blob[body_off + 3] == M.FILE_VERSION[0]
    assert blob[body_off + 4] == 0
