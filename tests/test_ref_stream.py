"""Cross-decoding of reference MGARD-X streams.

tests/golden/ref_blob_*.mgard are COMPLETE compressed files written by the
reference library itself (MGARD-X SERIAL general_compress, lossless=LZ4)
via tests/golden/generate_ref_blobs.sh. They must round-trip through
mgard_tpu.decompress within the certified bound — the reference's own
decompress contract (reference: include/compress_x.hpp:109-154).
"""

import os
import struct

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.formats import ref_stream
from mgard_tpu.formats.metadata import FormatError

GOLD = os.path.join(os.path.dirname(__file__), "golden")

CASES = [
    ("3d65_f32_lz4_abs", (65, 65, 65), np.float32, 1e-3, "abs"),
    ("3d606570_f64_lz4_abs", (60, 65, 70), np.float64, 1e-4, "abs"),
    ("3d65_f32_lz4_rel", (65, 65, 65), np.float32, 1e-3, "rel"),
]


def _load(tag, shape, dt):
    blob = open(os.path.join(GOLD, f"ref_blob_{tag}.mgard"), "rb").read()
    v = np.fromfile(os.path.join(GOLD, f"ref_input_{tag}.bin"), dt).reshape(shape)
    return blob, v


@pytest.mark.parametrize("tag,shape,dt,tol,mode", CASES)
def test_reference_blob_decompresses_within_bound(tag, shape, dt, tol, mode):
    blob, v = _load(tag, shape, dt)
    out, st = mgard_tpu.decompress(blob)
    assert st == mgard_tpu.compress_status_type.Success
    assert out.shape == shape and out.dtype == dt
    err = float(np.max(np.abs(out.astype(np.float64) - v)))
    bound = tol * (float(np.abs(v).max()) if mode == "rel" else 1.0)
    assert err <= bound, f"{err} > {bound}"


def test_reference_header_parse():
    blob, _ = _load(*CASES[0][:3])
    h = ref_stream.parse_header(blob)
    assert h.shape == (65, 65, 65)
    assert h.dtype == np.float32
    assert h.compressor == ref_stream.ENC_X_LZ4
    assert np.isinf(h.s)
    assert abs(h.tol - 1e-3) < 1e-9
    assert ref_stream.sniff(blob[:8])
    assert not ref_stream.sniff(b"MGARDTPU")


def test_reference_header_crc_detects_corruption():
    blob, _ = _load(*CASES[0][:3])
    bad = bytearray(blob)
    bad[20] ^= 0xFF  # flip a protobuf byte
    with pytest.raises(FormatError):
        ref_stream.parse_header(bytes(bad))
    out, st = mgard_tpu.decompress(bytes(bad))
    assert out is None and st == mgard_tpu.compress_status_type.Failure


def test_reference_unsupported_backend_clean_error():
    """A reference stream with an unknown backend id must fail with a clear
    message, not garbage output. (Every id the reference actually
    serializes is supported, so the forged id is an out-of-enum value.)"""
    blob, _ = _load(*CASES[0][:3])
    h = ref_stream.parse_header(blob)
    # re-parse and surgically change Encoding.compressor 8 (X_LZ4) -> 13
    # (no such backend) inside the protobuf body, then re-CRC the header
    import zlib

    p = 5
    (hsize,) = struct.unpack_from("<Q", blob, p)
    body = bytearray(blob[17 : 17 + hsize])
    # Encoding submessage: field 11, wire type 2; compressor: field 2 varint
    idx = bytes(body).find(bytes([11 << 3 | 2]))
    assert idx >= 0
    ln = body[idx + 1]
    sub = body[idx + 2 : idx + 2 + ln]
    cidx = bytes(sub).find(bytes([2 << 3 | 0, ref_stream.ENC_X_LZ4]))
    assert cidx >= 0
    body[idx + 2 + cidx + 1] = 13
    crc = zlib.crc32(bytes(body)) & 0xFFFFFFFF
    forged = blob[:13] + struct.pack("<I", crc) + bytes(body) + blob[17 + hsize:]
    with pytest.raises(FormatError, match="unknown lossless backend"):
        ref_stream.decompress_reference(forged)


@pytest.mark.parametrize(
    "tag,shape",
    [("335", (3, 3, 5)), ("559", (5, 5, 9)), ("5917", (5, 9, 17)),
     ("59", (5, 9))],
)
def test_singledim_x_recompose_inverts_reference(tag, shape):
    """recompose_single_x applied to the reference's own SingleDim
    decomposed coefficients (sdx_*.bin, generate_sdim.sh) reproduces the
    input to f64 eps — pinning the reference's (level, dim) loop order,
    in-place nested layout, and its boundary-guarded mass transfer
    (MassTransKernel.hpp: the last coarse node takes no contribution)."""
    from mgard_tpu.hierarchy import get_hierarchy
    from mgard_tpu.ops.refactor import recompose_single_x

    dec = np.fromfile(os.path.join(GOLD, f"sdx_dec_{tag}.bin"),
                      np.float64).reshape(shape)
    inp = np.fromfile(os.path.join(GOLD, f"sdx_in_{tag}.bin"),
                      np.float64).reshape(shape)
    hier = get_hierarchy(shape, np.float64, None, mgard_tpu.Config())
    rec = recompose_single_x(dec, hier)
    np.testing.assert_allclose(rec, inp, rtol=0, atol=1e-12)


def test_reference_singledim_stream_decodes():
    """A reference-written SingleDim stream decodes through the public
    mgard_tpu.decompress to f32-rounding parity with the reference's own
    decompressor, within the certified bound."""
    with open(os.path.join(GOLD, "ref_blob_3d65_f32_sdim.mgard"), "rb") as f:
        blob = f.read()
    ref_own = np.fromfile(
        os.path.join(GOLD, "ref_dec_3d65_f32_sdim.bin"), np.float32
    ).reshape(65, 65, 65)
    v = np.fromfile(
        os.path.join(GOLD, "ref_input_3d65_f32_lz4_abs.bin"), np.float32
    ).reshape(65, 65, 65)
    out, st = mgard_tpu.decompress(blob)
    assert int(st) == 0
    np.testing.assert_allclose(out.astype(np.float64), ref_own, rtol=0,
                               atol=2e-6)
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= 1e-3


def test_reference_hybrid_stream_clean_error():
    """The reference Hybrid decomposition layout is not cross-decoded;
    its streams must fail cleanly, not return garbage."""
    with open(os.path.join(GOLD, "ref_blob_3d65_f32_hyb.mgard"), "rb") as f:
        blob = f.read()
    with pytest.raises(FormatError, match="hybrid"):
        ref_stream.decompress_reference(blob)
    out, st = mgard_tpu.decompress(blob)
    assert out is None and int(st) != 0


@pytest.mark.parametrize("tag", [
    "3d65_f32_bdfixed", "3d65_f32_bddelta", "3d65_f32_bdoutlier",
    "3d65_f32_symrans", "3d65_f32_zrlerans",
])
def test_reference_alt_lossless_classes_decode(tag):
    """The remaining reference lossless classes (BlockDelta fixed/delta/
    outlier wire format, SymbolRans, ZeroRLE+rANS) cross-decode: goldens
    written by the reference SERIAL build (generate_ref_blobs2.sh) must
    match the reference's OWN decompressor to f32 rounding and hold the
    certified bound. With these, every lossless class the reference can
    serialize is readable."""
    with open(os.path.join(GOLD, f"ref_blob_{tag}.mgard"), "rb") as f:
        blob = f.read()
    ref_own = np.fromfile(
        os.path.join(GOLD, f"ref_dec_{tag}.bin"), np.float32
    ).reshape(65, 65, 65)
    v = np.fromfile(
        os.path.join(GOLD, "ref_input_3d65_f32_lz4_abs.bin"), np.float32
    ).reshape(65, 65, 65)
    out, st = mgard_tpu.decompress(blob)
    assert int(st) == 0
    np.testing.assert_allclose(out.astype(np.float64), ref_own, rtol=0,
                               atol=1e-6)
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= 1e-3


def test_reference_s0_blob_holds_l2_bound():
    """Whole-domain finite-s (s=0, L2) reference stream: our decode must
    hold the reference's own bound semantics (RMS-normalized L2 <= tol)."""
    blob, v = _load("3d65_f32_lz4_s0", (65, 65, 65), np.float32)
    out, st = mgard_tpu.decompress(blob)
    assert st == mgard_tpu.compress_status_type.Success
    l2 = float(np.sqrt(np.mean((out.astype(np.float64) - v) ** 2)))
    assert l2 <= 1e-3, l2


@pytest.mark.parametrize("tag", [
    "3d643333_f32_lz4_abs_dd", "3d643333_f32_lz4_s0_dd",
])
def test_reference_decomposed_blob_matches_reference_decompressor(tag):
    """Domain-decomposed reference streams (MaxDim dd_method=1, 16
    subdomains; the finite-s one pins the per-subdomain tol/sqrt(S)
    dequantizer rule). The fidelity oracle is the reference's OWN
    decompressor output (ref_dec_*.bin, written by generate_ref_blobs.sh):
    the reference's SERIAL decomposed COMPRESS pipeline corrupts subdomain
    interiors, so its own round-trip misses the bound by ~3 orders of
    magnitude — cross-decoder correctness here means ulp-level agreement
    with what the reference itself reconstructs, bug included."""
    blob, _v = _load(tag, (64, 33, 33), np.float32)
    refdec = np.fromfile(
        os.path.join(GOLD, f"ref_dec_{tag}.bin"), np.float32
    ).reshape(64, 33, 33)
    out, st = mgard_tpu.decompress(blob)
    assert st == mgard_tpu.compress_status_type.Success
    d = float(np.max(np.abs(out.astype(np.float64) - refdec)))
    assert d <= 1e-5, d


@pytest.mark.parametrize("tag,metric", [
    ("3d65_f32_huf_abs", "linf"),        # the reference's DEFAULT lossless
    ("3d65_f32_huflz4_abs", "linf"),     # Huffman wrapped in the LZ4 container
    ("3d65_f32_hufzstd_s0", "l2"),       # Huffman wrapped in zstd, finite-s
])
def test_reference_huffman_class_blob_decodes(tag, metric):
    """Reference GPU-Huffman-class streams (the DEFAULT reference config)
    cross-decode within the certified bound: canonical per-chunk decode +
    outlier restore + dictionary un-shift (ref_stream._decode_x_huffman;
    reference layout Lossless/ParallelHuffman/Huffman.hpp Serialize)."""
    blob, v = _load(tag, (65, 65, 65), np.float32)
    out, st = mgard_tpu.decompress(blob)
    assert st == mgard_tpu.compress_status_type.Success
    d = out.astype(np.float64) - v
    err = float(np.max(np.abs(d)) if metric == "linf"
                else np.sqrt(np.mean(d ** 2)))
    assert err <= 1e-3, err


def test_write_reference_stream_roundtrip():
    """compress_reference output must round-trip through OUR decoder within
    the bound (the sniffing dispatch routes it like any reference file)."""
    import math

    from mgard_tpu.formats import ref_stream as rs

    _, v = _load("3d65_f32_lz4_abs", (65, 65, 65), np.float32)
    blob = rs.compress_reference(v, 1e-3, math.inf)
    out, st = mgard_tpu.decompress(blob)
    assert st == mgard_tpu.compress_status_type.Success
    assert float(np.max(np.abs(out.astype(np.float64) - v))) <= 1e-3


@pytest.mark.parametrize("tag,dt,tol,metric", [
    ("3d65_f32_abs", np.float32, 1e-3, "linf"),
    ("3d65_f32_s0", np.float32, 1e-3, "l2"),
    ("3d65_f64_abs", np.float64, 1e-4, "linf"),
])
def test_reference_decodes_our_written_stream(tag, dt, tol, metric):
    """Bidirectional interop, pinned: xwrite_*.mgard was WRITTEN by
    compress_reference and xwrite_dec_*.bin is the REFERENCE library's own
    reconstruction of it (generate_xwrite.sh). The reference must (a) have
    accepted the stream and (b) reconstruct the original field within the
    certified bound — and our decoder must agree with the reference's
    reconstruction to ulp."""
    v = np.fromfile(
        os.path.join(GOLD, "ref_input_3d65_f32_lz4_abs.bin"), np.float32
    ).reshape(65, 65, 65).astype(dt)
    refdec = np.fromfile(
        os.path.join(GOLD, f"xwrite_dec_{tag}.bin"), dt
    ).reshape(65, 65, 65)
    d = refdec.astype(np.float64) - v
    err = float(np.max(np.abs(d)) if metric == "linf"
                else np.sqrt(np.mean(d ** 2)))
    assert err <= tol, err
    blob = open(os.path.join(GOLD, f"xwrite_{tag}.mgard"), "rb").read()
    ours, st = mgard_tpu.decompress(blob)
    assert st == mgard_tpu.compress_status_type.Success
    atol = 1e-5 if dt == np.float32 else 1e-12
    np.testing.assert_allclose(ours, refdec, rtol=0, atol=atol)
