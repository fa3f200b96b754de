"""Structured corruption fuzz of the self-describing stream readers.

Contract under test (reference parity: mgard::decompress returns an error
status for malformed buffers rather than crashing —
/root/reference/src/mgard/compress_internal.cpp:5-13 sniffing plus the
catch-all translation in compress_x.hpp:109-154): for ANY truncated or
byte-flipped input, `mgard_tpu.decompress` must return (out, status)
without raising, and a Success status must come with an output of the
original shape/dtype. Wrong DATA under payload corruption is permitted
(the CRC covers the header, not the payload — same as the reference);
uncaught parser exceptions, index crashes, or hangs are not.
"""

import numpy as np
import pytest

import mgard_tpu
from mgard_tpu.dtypes import compress_status_type, lossless_type


def _blob(lossless=lossless_type.BFP):
    rng = np.random.default_rng(7)
    x = np.linspace(0, 1, 40, dtype=np.float32)
    v = (
        np.sin(2 * np.pi * x)[:, None, None]
        + np.cos(3 * np.pi * x)[None, :, None] * x[None, None, :]
        + 0.01 * rng.standard_normal((40, 40, 40)).astype(np.float32)
    )
    cfg = mgard_tpu.Config()
    cfg.lossless = lossless
    blob, st = mgard_tpu.compress(v, tol=1e-3, config=cfg)
    assert int(st) == 0
    return bytes(blob), v


@pytest.fixture(scope="module")
def blob_and_field():
    return _blob()


def _check(data: bytes, shape, dtype):
    out, st = mgard_tpu.decompress(data)
    if st == compress_status_type.Success:
        assert out is not None and out.shape == shape and out.dtype == dtype
    else:
        assert out is None


def test_truncation_sweep(blob_and_field):
    """Every prefix of the stream parses to a clean Failure (or a
    well-formed Success for trailing-slack truncations), never a crash."""
    blob, v = blob_and_field
    n = len(blob)
    # dense near the header, stepped through the payload, dense at the tail
    points = sorted(
        set(
            list(range(0, min(96, n)))
            + list(range(96, n, max(1, n // 24)))
            + list(range(max(0, n - 8), n))
        )
    )
    for L in points:
        _check(blob[:L], v.shape, v.dtype)


def test_byte_flip_sweep(blob_and_field):
    """Single-byte flips spread across the whole stream (seeded): header
    flips must be caught by the CRC; payload flips may decode to wrong data
    but must not raise or hang."""
    blob, v = blob_and_field
    n = len(blob)
    rng = np.random.default_rng(42)
    positions = sorted(set(rng.integers(0, n, 24).tolist()) | {0, 1, 8, n - 1})
    for pos in positions:
        bad = bytearray(blob)
        bad[pos] ^= 0xA5
        _check(bytes(bad), v.shape, v.dtype)


def test_header_flip_is_detected(blob_and_field):
    """A flip INSIDE the metadata header region must yield Failure, not a
    silently mis-parsed stream (CRC32 coverage)."""
    blob, v = blob_and_field
    for pos in (12, 20, 33, 47):
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        out, st = mgard_tpu.decompress(bytes(bad))
        assert st != compress_status_type.Success


def test_empty_and_garbage():
    for data in (b"", b"\x00", b"not a stream at all" * 4, b"\xff" * 4096):
        out, st = mgard_tpu.decompress(data)
        assert st != compress_status_type.Success and out is None


@pytest.mark.parametrize(
    "lossless", [lossless_type.BFX, lossless_type.Huffman]
)
def test_truncation_other_backends(lossless):
    blob, v = _blob(lossless)
    n = len(blob)
    for L in range(0, n, max(1, n // 12)):
        _check(blob[:L], v.shape, v.dtype)


# ----------------------------------------------------------------------
# Reference-stream decoders (cross-decode paths) under corruption
# ----------------------------------------------------------------------
_REF_BLOBS = [
    "ref_blob_3d65_f32_huf_abs.mgard",      # GPU-Huffman class
    "ref_blob_3d65_f32_bdoutlier.mgard",    # BlockDelta outlier mode
    "ref_blob_3d65_f32_symrans.mgard",      # SymbolRans (rANS container)
    "ref_blob_3d65_f32_sdim.mgard",         # SingleDim decomposition
    "cpu_stream_3d151617_f64_sinf.mgard",   # CPU generation (Huffman+zstd)
]


@pytest.mark.parametrize("name", _REF_BLOBS)
def test_reference_stream_truncation_sweep(name):
    """Truncated REFERENCE-written streams must come back as a clean
    Failure through the public sniffing decompress — the cross-decoders
    (Huffman walks, rANS renormalization, BlockDelta layout scans, CPU
    container parsing) must never crash or hang on short input."""
    import os

    path = os.path.join(os.path.dirname(__file__), "golden", name)
    with open(path, "rb") as f:
        blob = f.read()
    n = len(blob)
    points = sorted(set(
        list(range(0, 64, 7)) + list(range(64, n, max(1, n // 12)))
        + [n - 3, n - 1]
    ))
    for L in points:
        out, st = mgard_tpu.decompress(blob[:L])
        assert out is None and st != compress_status_type.Success, f"L={L}"


@pytest.mark.parametrize("name", _REF_BLOBS)
def test_reference_stream_byte_flip_sweep(name):
    """Seeded single-byte flips across reference streams: header flips are
    CRC-caught; payload flips may decode to wrong data (no CRC there, as
    in the reference) but must not raise an uncaught exception or hang."""
    import os

    path = os.path.join(os.path.dirname(__file__), "golden", name)
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    rng = np.random.RandomState(5)
    n = len(blob)
    for pos in sorted(rng.choice(n, size=24, replace=False)):
        orig = blob[pos]
        blob[pos] ^= 0x5A
        out, st = mgard_tpu.decompress(bytes(blob))
        if st == compress_status_type.Success:
            assert out is not None
        else:
            assert out is None
        blob[pos] = orig


@pytest.mark.parametrize("comp", ["component_0_7_0", "component_0_7_4",
                                  "metadata"])
def test_mdrx_archive_flip_sweep(comp, tmp_path):
    """Seeded byte flips + truncations on the compressed MDR-X group
    containers (MGXRLEC component_0_7_0, MGXHUFF component_0_7_4) and
    the metadata struct: reconstruction must either succeed or raise
    FormatError — never crash, hang, or leak a raw numpy/struct error."""
    import os
    import shutil

    from mgard_tpu.formats.metadata import FormatError
    from mgard_tpu.formats.mdrx_stream import reconstruct_mdrx

    src = os.path.join(os.path.dirname(__file__), "golden", "mdrx3")
    arch = tmp_path / "mdrx3"
    shutil.copytree(src, arch)
    target = arch / comp
    orig = target.read_bytes()
    rng = np.random.RandomState(7)
    cases = [("flip", int(p)) for p in
             rng.choice(len(orig), size=8, replace=False)]
    cases += [("trunc", int(p)) for p in
              rng.choice(len(orig), size=4, replace=False)]
    for kind, pos in cases:
        if kind == "flip":
            buf = bytearray(orig)
            buf[pos] ^= 0x5A
            target.write_bytes(bytes(buf))
        else:
            target.write_bytes(orig[:pos])
        try:
            reconstruct_mdrx(str(arch), 2e-2)
        except FormatError:
            pass
        target.write_bytes(orig)


def _v3_blob():
    """The committed flag-2 (v3) golden stream and a field of its shape
    (tests/test_hybrid_v3.py documents how it was written)."""
    import os

    path = os.path.join(os.path.dirname(__file__), "golden",
                        "hybrid_v3_flag2_16x128x256_f32.mgard")
    with open(path, "rb") as f:
        blob = f.read()
    # the flag byte sits 9 bytes before the cf blob's BFP5 magic
    assert blob[blob.index(b"BFP5") - 9] == 2
    return blob, np.zeros((16, 128, 256), np.float32)


@pytest.fixture(scope="module")
def v3_blob_and_field():
    return _v3_blob()


def test_v3_truncation_sweep(v3_blob_and_field):
    """Every truncation of a flag-2 stream fails cleanly via status."""
    blob, v = v3_blob_and_field
    cuts = sorted({1, 8, 40, 64, len(blob) // 3, len(blob) // 2,
                   len(blob) - 129, len(blob) - 1})
    for cut in cuts:
        out, st = mgard_tpu.decompress(blob[:cut])
        assert out is None and int(st) != 0, cut


def test_v3_byte_flip_sweep(v3_blob_and_field):
    """Byte flips across a flag-2 stream never raise; Success implies the
    original shape/dtype (wrong data under payload corruption allowed)."""
    blob, v = v3_blob_and_field
    n = len(blob)
    for off in list(range(0, 200, 13)) + [n // 2, n - 40, n - 1]:
        bad = bytearray(blob)
        bad[off] ^= 0x5A
        out, st = mgard_tpu.decompress(bytes(bad))
        if int(st) == 0:
            assert out is not None and out.shape == v.shape
            assert out.dtype == v.dtype
