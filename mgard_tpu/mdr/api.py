"""MDR high-level API: MDRefactor / MDRequest / MDReconstruct.

Mirrors the reference's public MDR surface (reference: include/mdr_x.hpp:16-38,
include/mgard-x/MDRHighLevel/MDRHighLevel.hpp:74-358) and its aggregates
RefactoredMetadata / RefactoredData / ReconstructedData
(reference: MDRHighLevel/MDRDataHighLevel.hpp). The refactor pipeline is one
jitted device program (hierarchical decompose + per-level interleave +
bitplane encode with error collection); retrieval is error-driven and
incremental: MDRequest plans per-level bitplane counts, MDReconstruct
consumes only the requested planes and tracks consumed state for later
refinement rounds (reference: MDRMetadata.hpp prev_used_level_num_bitplanes).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from functools import partial
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config
from ..dtypes import bitplane_encoding_type, data_type, dtype_enum, np_dtype
from ..formats.metadata import FormatError
from ..hierarchy import Hierarchy, get_hierarchy
from ..ops.refactor import decompose, recompose
from . import bitplane
from .components import (
    deinterleave_level,
    estimate_error,
    interleave_level,
    interpret_retrieve_size,
    level_num_elems,
)

# Bumped ...1 -> ...2 with the round-3 layout change (reorg_s double +
# interleaver byte): older MDR streams are rejected instead of mis-parsed.
_MAGIC = b"MDRTPU2\x00"


# per-plane codec ids (reference: MDR-X/LosslessCompressor component kit)
PLANE_RAW = 0
PLANE_ZLIB = 1
PLANE_BFX = 2
# smallest plane (u32 words) worth a device-BFX dispatch; below this the
# kernel/dispatch overhead exceeds the plane itself
PLANE_BFX_MIN_WORDS = 8192


def choose_plane_blob(raw_bytes: bytes, candidate, codec_id: int):
    """Best-of plane selection (raw vs one encoded candidate): the SINGLE
    policy point shared by every writer (single-device MDRefactor and the
    sharded refactor host tail) so codec choices can never diverge."""
    if candidate is not None and len(candidate) < len(raw_bytes):
        return candidate, codec_id
    return raw_bytes, PLANE_RAW


def decode_plane_blob(blob: bytes, codec: int, m: int) -> np.ndarray:
    """Decode one stored bitplane blob to its (m,) uint32 row.

    Single decode point for every reconstruct path (single-device and
    sharded) so a codec supported by the writer can never be unsupported by
    a reader."""
    if codec == PLANE_ZLIB:
        raw = zlib.decompress(blob)
    elif codec == PLANE_BFX:
        from ..lossless import bfx as _bfx

        syms, _ = _bfx.decode(blob)
        raw = np.asarray(syms).view(np.uint32)[:m].tobytes()
    elif codec == PLANE_RAW:
        raw = blob
    else:
        raise FormatError(f"unsupported MDR plane codec id {codec}")
    return np.frombuffer(raw, "<u4", count=m)


@dataclasses.dataclass
class LevelMetadata:
    exp: int
    n: int  # number of coefficients (unpadded)
    plane_sizes: List[int]  # compressed bytes per stored plane (0=sign)
    plane_raw: List[int]  # per-plane codec id (PLANE_RAW/ZLIB/BFX)
    err_max: np.ndarray  # (B+1,)
    err_sq: np.ndarray  # (B+1,)


@dataclasses.dataclass
class RefactoredMetadata:
    dtype: data_type
    shape: tuple
    l_target: int
    number_bitplanes: int
    total_num_elems: int
    levels: List[LevelMetadata]
    # retrieval state
    requested: List[int] = dataclasses.field(default_factory=list)
    prev_used: List[int] = dataclasses.field(default_factory=list)
    coords: Optional[List[np.ndarray]] = None
    # encoding variant (reference: EncodeBinary vs EncodeNegaBinary,
    # BPEncoderRegisterBlock.hpp:111,183) and decomposition basis
    # (hierarchical vs L2-orthogonal decomposer)
    encoding: bitplane_encoding_type = bitplane_encoding_type.SignMagnitude
    orthogonal: bool = False
    # file segments stored in error-impact order (Reorganizer) instead of
    # level-major order
    reorganized: bool = False
    # the s-norm the reorganizer's greedy gain used; persisted so readers
    # recompute the identical segment order (an s passed at write
    # time but not at read time silently corrupted plane offsets)
    reorg_s: float = float("inf")
    # interleaver mode (reference: MDR-X/Interleaver/: Direct=0,
    # Blocked=1, SFC/Morton=2)
    interleaver: int = 0

    @property
    def sign_rows(self) -> int:
        return 0 if self.encoding == bitplane_encoding_type.NegaBinary else 1

    def serialize(self) -> bytes:
        body = bytearray()
        body += struct.pack(
            "<BBIQBBBBd",
            int(self.dtype),
            len(self.shape),
            self.number_bitplanes,
            self.total_num_elems,
            1 if self.coords is not None else 0,
            int(self.encoding),
            1 if self.orthogonal else 0,
            1 if self.reorganized else 0,
            float(self.reorg_s),
        )
        body += struct.pack("<B", int(self.interleaver))
        for n in self.shape:
            body += struct.pack("<Q", n)
        if self.coords is not None:
            for c in self.coords:
                body += np.asarray(c, "<f8").tobytes()
        body += struct.pack("<I", self.l_target)
        body += struct.pack("<I", len(self.levels))
        for lm in self.levels:
            body += struct.pack("<iQ", lm.exp, lm.n)
            body += struct.pack("<I", len(lm.plane_sizes))
            for sz, raw in zip(lm.plane_sizes, lm.plane_raw):
                # full codec id (PLANE_RAW/ZLIB/BFX), not a boolean — a
                # 1-if-truthy pack would silently relabel BFX planes as zlib
                body += struct.pack("<IB", sz, int(raw))
            body += np.asarray(lm.err_max, "<f8").tobytes()
            body += np.asarray(lm.err_sq, "<f8").tobytes()
        crc = zlib.crc32(bytes(body)) & 0xFFFFFFFF
        return _MAGIC + struct.pack("<II", len(body), crc) + bytes(body)

    @classmethod
    def deserialize(cls, data: bytes) -> tuple["RefactoredMetadata", int]:
        if data[:8] != _MAGIC:
            if data[:6] == b"MDRTPU":
                raise FormatError(
                    "mdr-tpu stream written by an incompatible format "
                    "revision — re-refactor with this version"
                )
            raise FormatError("not an mdr-tpu stream")
        size, crc = struct.unpack_from("<II", data, 8)
        body = bytes(data[16 : 16 + size])
        if len(body) != size or (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            raise FormatError("corrupted MDR metadata")
        p = 0
        dt, nd, B, total, has_coords, enc, orth, reorg, reorg_s = struct.unpack_from(
            "<BBIQBBBBd", body, p
        )
        p += struct.calcsize("<BBIQBBBBd")
        (ilv,) = struct.unpack_from("<B", body, p)
        p += 1
        shape = []
        for _ in range(nd):
            (n,) = struct.unpack_from("<Q", body, p)
            p += 8
            shape.append(n)
        coords = None
        if has_coords:
            coords = []
            for n in shape:
                coords.append(np.frombuffer(body, "<f8", count=n, offset=p).copy())
                p += 8 * n
        (l_target,) = struct.unpack_from("<I", body, p)
        p += 4
        (nlev,) = struct.unpack_from("<I", body, p)
        p += 4
        levels = []
        for _ in range(nlev):
            exp, n = struct.unpack_from("<iQ", body, p)
            p += struct.calcsize("<iQ")
            (nplanes,) = struct.unpack_from("<I", body, p)
            p += 4
            sizes, raws = [], []
            for _ in range(nplanes):
                sz, codec = struct.unpack_from("<IB", body, p)
                p += 5
                sizes.append(sz)
                raws.append(int(codec))
            err_max = np.frombuffer(body, "<f8", count=B + 1, offset=p).copy()
            p += 8 * (B + 1)
            err_sq = np.frombuffer(body, "<f8", count=B + 1, offset=p).copy()
            p += 8 * (B + 1)
            levels.append(LevelMetadata(exp, n, sizes, raws, err_max, err_sq))
        meta = cls(
            dtype=data_type(dt),
            shape=tuple(shape),
            l_target=l_target,
            number_bitplanes=B,
            total_num_elems=total,
            levels=levels,
            coords=coords,
            encoding=bitplane_encoding_type(enc),
            orthogonal=bool(orth),
            reorganized=bool(reorg),
            reorg_s=float(reorg_s),
            interleaver=int(ilv),
        )
        return meta, 16 + size


@dataclasses.dataclass
class RefactoredData:
    # planes[l][p] = compressed bytes of plane p of level l (0 = sign plane)
    planes: List[List[bytes]]


@dataclasses.dataclass
class ReconstructedData:
    data: Optional[np.ndarray] = None
    used: List[int] = dataclasses.field(default_factory=list)


# ----------------------------------------------------------------------
def _hier_sig(hier: Hierarchy):
    """Value-based hierarchy identity for program caches: two Hierarchy
    objects with the same signature produce identical compiled programs
    (id()-keying guaranteed a miss for every rebuilt non-uniform hierarchy
    and pinned stale entries forever)."""
    coords_sig = (
        None if hier.uniform
        else tuple(np.asarray(c, np.float64).tobytes() for c in hier.coords)
    )
    return (hier.shape, hier.dtype.name, coords_sig)


def _cache_put(cache: dict, key, val, cap: int = 32):
    if len(cache) >= cap:  # bound growth: drop the oldest entry
        cache.pop(next(iter(cache)))
    cache[key] = val
    return val


_REFACTOR_CACHE: dict = {}


def _refactor_device(hier: Hierarchy, B: int, negabinary: bool, orthogonal: bool,
                     interleaver: int = 0):
    key = (_hier_sig(hier), B, negabinary, orthogonal, interleaver)
    if key in _REFACTOR_CACHE:
        return _REFACTOR_CACHE[key]
    L = hier.l_target
    enc = (
        bitplane.encode_kernel_negabinary if negabinary else bitplane.encode_kernel
    )

    @jax.jit
    def fn(v):
        dec = decompose(v, hier, orthogonal=orthogonal)
        out = []
        for l in range(L + 1):
            stream = bitplane.pad_stream(interleave_level(dec, hier, l, interleaver))
            out.append(enc(stream, B))
        return out

    return _cache_put(_REFACTOR_CACHE, key, fn)


def MDRefactor(
    data,
    config: Optional[Config] = None,
    coords: Optional[Sequence[np.ndarray]] = None,
):
    """Refactor an array into progressive bitplane components.

    Returns (RefactoredMetadata, RefactoredData).
    Reference: MDR::MDRefactor (mdr_x.hpp:16, MDRHighLevel.hpp:74-173)."""
    config = config or Config()
    arr = np.asarray(data) if not isinstance(data, jax.Array) else data
    dt = dtype_enum(arr.dtype)
    shape = tuple(int(s) for s in arr.shape)
    coords_list = [np.asarray(c, np.float64) for c in coords] if coords else None
    hier = get_hierarchy(shape, arr.dtype, coords_list, config)
    B = int(config.total_num_bitplanes)
    negabinary = config.mdr_encoding == bitplane_encoding_type.NegaBinary
    orthogonal = bool(config.mdr_orthogonal_basis)

    interleaver = {"direct": 0, "blocked": 1, "sfc": 2}[
        getattr(config, "mdr_interleaver", "direct")
    ]
    results = _refactor_device(hier, B, negabinary, orthogonal, interleaver)(
        jnp.asarray(arr)
    )

    levels = []
    planes_data: List[List[bytes]] = []
    lvl_codec = getattr(config, "mdr_level_compressor", "zlib")
    # Device level-compression runs as a two-phase pipeline: dispatch the
    # encode of EVERY (level, plane) row first with no host sync (XLA queues
    # them back-to-back on device), then serialize. Replaces round-2's
    # serial per-plane host loop (reference counterpart: the batched
    # DefaultLevelCompressor, MDR-X/LosslessCompressor/).
    dispatched: List[List] = []
    if lvl_codec == "bfx":
        from ..lossless import bfx as _bfx

        for planes, _exp, _em, _es in results:
            row = []
            for p in range(planes.shape[0]):
                if planes.shape[1] >= PLANE_BFX_MIN_WORDS:
                    row.append(_bfx.encode_device(
                        jax.lax.bitcast_convert_type(planes[p], jnp.int32)))
                else:
                    row.append(None)
            dispatched.append(row)
    for l, (planes, exp, err_max, err_sq) in enumerate(results):
        err_max, err_sq = bitplane.scale_tables(
            err_max, err_sq, int(exp), B, negabinary
        )
        planes_h = np.asarray(planes)  # (B+1 or B, m) uint32
        n = level_num_elems(hier, l)
        sizes, raws, blobs = [], [], []
        for p in range(planes_h.shape[0]):
            raw_bytes = planes_h[p].astype("<u4").tobytes()
            cand, cid = None, PLANE_RAW
            if lvl_codec == "zlib":
                cand, cid = zlib.compress(raw_bytes, 1), PLANE_ZLIB
            elif lvl_codec == "bfx" and dispatched[l][p] is not None:
                from ..lossless import bfx as _bfx

                cand, cid = _bfx.serialize_device(dispatched[l][p]), PLANE_BFX
            best, codec = choose_plane_blob(raw_bytes, cand, cid)
            blobs.append(best)
            sizes.append(len(best))
            raws.append(codec)
        levels.append(
            LevelMetadata(int(exp), n, sizes, raws, np.asarray(err_max), np.asarray(err_sq))
        )
        planes_data.append(blobs)

    meta = RefactoredMetadata(
        dtype=dt,
        shape=shape,
        l_target=hier.l_target,
        number_bitplanes=B,
        total_num_elems=hier.total_num_elems,
        levels=levels,
        coords=coords_list,
        encoding=config.mdr_encoding,
        orthogonal=orthogonal,
        interleaver=interleaver,
    )
    return meta, RefactoredData(planes=planes_data)


def MDRequest(meta: RefactoredMetadata, tol: float, s: float = float("inf")) -> List[int]:
    """Plan per-level bitplane counts for a target tolerance.

    Reference: MDR::MDRequest -> GreedyBasedSizeInterpreter
    (MDRHighLevel.hpp:198, GenerateRequest.hpp:14-29)."""
    counts = interpret_retrieve_size(meta, tol, s)
    meta.requested = counts
    return counts


def retrieve_size(meta: RefactoredMetadata, counts: Sequence[int]) -> int:
    """Bytes needed to satisfy a retrieval plan (incremental over prev_used)."""
    prev = meta.prev_used or [0] * len(counts)
    sr = meta.sign_rows
    total = 0
    for lm, c, pu in zip(meta.levels, counts, prev):
        if sr and c > 0 and pu == 0:
            total += lm.plane_sizes[0]  # sign plane
        for b in range(pu, c):
            total += lm.plane_sizes[b + sr]
    return total


_RECON_CACHE: dict = {}


def _reconstruct_device(hier: Hierarchy, B: int, counts: tuple,
                        negabinary: bool, orthogonal: bool, dtype,
                        interleaver: int = 0):
    """Fully-jitted progressive reconstruct: per-level bitplane decode,
    in-graph deinterleave (static slab writes), and recompose — the device
    counterpart of the reference's BPDecoderRegisterBlockKernel +
    ProgressiveReconstruct chain (no per-plane host loops)."""
    key = (_hier_sig(hier), B, counts, negabinary, orthogonal,
           np.dtype(dtype).name, interleaver)
    if key in _RECON_CACHE:
        return _RECON_CACHE[key]
    from .components import level_regions, region_deinterleave

    dec_fn = (
        bitplane.decode_kernel_negabinary if negabinary else bitplane.decode_kernel
    )

    @jax.jit
    def fn(planes_list, exps):
        # accumulate in the data dtype: f64 is slow on most accelerators
        # and adds no accuracy below the dropped-plane error
        dec = jnp.zeros(hier.shape, dtype)
        for l, planes in enumerate(planes_list):
            b = counts[l]
            if b == 0:
                continue
            vals = dec_fn(planes, exps[l], B, b, jnp.dtype(dtype).type)
            off = 0
            for r in level_regions(hier, l):
                shp = tuple(s.stop - s.start for s in r)
                n = int(np.prod(shp))
                dec = dec.at[r].set(
                    region_deinterleave(vals[off : off + n], shp, interleaver)
                )
                off += n
        return recompose(dec, hier, orthogonal=orthogonal)

    return _cache_put(_RECON_CACHE, key, fn)


def MDReconstruct(
    meta: RefactoredMetadata,
    data: RefactoredData,
    counts: Optional[Sequence[int]] = None,
    config: Optional[Config] = None,
    state: Optional[ReconstructedData] = None,
) -> ReconstructedData:
    """Reconstruct using counts[l] magnitude planes per level.

    Reference: MDR::MDReconstruct -> ComposedReconstructor::
    ProgressiveReconstruct (MDRHighLevel.hpp:215-357)."""
    config = config or Config()
    counts = list(counts if counts is not None else meta.requested)
    dtype = np_dtype(meta.dtype)
    hier = get_hierarchy(meta.shape, dtype, meta.coords, config)
    B = meta.number_bitplanes
    sr = meta.sign_rows
    negabinary = sr == 0

    planes_list = []
    exps = []
    for l, lm in enumerate(meta.levels):
        b = counts[l]
        m = bitplane.padded_words(lm.n)
        # a level with no requested planes contributes nothing (its plane
        # blobs may not even have been retrieved)
        nrows = (sr + b) if b > 0 else 0
        rows = np.zeros((nrows, m), np.uint32)
        for p in range(nrows):
            rows[p] = decode_plane_blob(data.planes[l][p], int(lm.plane_raw[p]), m)
        planes_list.append(jnp.asarray(rows))
        exps.append(lm.exp)

    fn = _reconstruct_device(
        hier, B, tuple(counts), negabinary, bool(meta.orthogonal), dtype,
        int(getattr(meta, "interleaver", 0)),
    )
    rec = np.asarray(fn(tuple(planes_list), jnp.asarray(exps, jnp.int32)))
    out = state or ReconstructedData()
    out.data = rec
    out.used = counts
    meta.prev_used = counts
    return out


# ----------------------------------------------------------------------
# File writer/retriever (reference: ConcatLevelFileWriter /
# ConcatLevelFileRetriever, MDR-X/{Writer,Retriever}/) and Reorganizer
# (reference: MDR-X/Reorganizer/BasicReorganizer — order segments by error
# impact so a byte-range prefix read retrieves the most useful planes)
# ----------------------------------------------------------------------
def segment_order(meta: RefactoredMetadata):
    """Deterministic storage order of (level, row) segments.

    Level-major when not reorganized; otherwise greedy error-impact order
    (each level's sign plane rides immediately before its first magnitude
    plane) under the persisted meta.reorg_s norm. Readers recompute the
    identical order from the metadata alone, so no extra index is stored."""
    L = len(meta.levels)
    sr = meta.sign_rows
    if not meta.reorganized:
        return [(l, p) for l in range(L) for p in range(len(meta.levels[l].plane_sizes))]
    import heapq as _hq
    import math as _math

    s = meta.reorg_s

    def gain(l, b):
        lm = meta.levels[l]
        red = float(lm.err_max[b] - lm.err_max[b + 1]) if _math.isinf(s) else float(
            lm.err_sq[b] - lm.err_sq[b + 1]
        )
        cost = lm.plane_sizes[b + sr] + (lm.plane_sizes[0] if (b == 0 and sr) else 0)
        return red / max(cost, 1)

    order = []
    heap = [(-gain(l, 0), l, 0) for l in range(L)]
    _hq.heapify(heap)
    B = meta.number_bitplanes
    while heap:
        _, l, b = _hq.heappop(heap)
        if b == 0 and sr:
            order.append((l, 0))
        order.append((l, b + sr))
        if b + 1 < B:
            _hq.heappush(heap, (-gain(l, b + 1), l, b + 1))
    return order


def write_mdr(path: str, meta: RefactoredMetadata, data: RefactoredData,
              s: float = float("inf")) -> None:
    if meta.reorganized:
        meta.reorg_s = float(s)  # persisted; readers re-derive the order
    header = meta.serialize()
    with open(path, "wb") as f:
        f.write(header)
        for l, p in segment_order(meta):
            f.write(data.planes[l][p])


def read_mdr_metadata(path: str) -> tuple[RefactoredMetadata, int]:
    with open(path, "rb") as f:
        head = f.read(16)
        size, _ = struct.unpack_from("<II", head, 8)
        body = f.read(size)
    return RefactoredMetadata.deserialize(head + body)


def read_mdr_planes(
    path: str, meta: RefactoredMetadata, counts: Sequence[int], header_size: int,
) -> RefactoredData:
    """Retrieve only the planes a plan needs (byte-ranged reads). The
    segment order comes from the header (meta.reorg_s), never from caller
    arguments."""
    offsets = [
        [None] * len(lm.plane_sizes) for lm in meta.levels
    ]
    off = header_size
    for l, p in segment_order(meta):
        sz = meta.levels[l].plane_sizes[p]
        offsets[l][p] = (off, sz)
        off += sz
    planes: List[List[bytes]] = []
    with open(path, "rb") as f:
        for l, lm in enumerate(meta.levels):
            need = meta.sign_rows + counts[l] if counts[l] > 0 else 0
            lvl = []
            for p in range(len(lm.plane_sizes)):
                if p < need:
                    f.seek(offsets[l][p][0])
                    lvl.append(f.read(offsets[l][p][1]))
                else:
                    lvl.append(b"")
            planes.append(lvl)
    return RefactoredData(planes=planes)


# ----------------------------------------------------------------------
# MDR over a decomposed domain (reference: MDRHighLevel.hpp:74-173 runs
# MDRefactor/MDReconstruct per DomainDecomposer subdomain; subdomains are
# halo-free and independent)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DecomposedMDR:
    shape: tuple
    subdomain_slices: List[tuple]
    metas: List[RefactoredMetadata]
    datas: List[RefactoredData]


def MDRefactorDecomposed(
    data,
    config: Optional[Config] = None,
    coords: Optional[Sequence[np.ndarray]] = None,
) -> DecomposedMDR:
    """Refactor each DomainDecomposer subdomain independently."""
    from ..decomposer import DomainDecomposer

    config = config or Config()
    arr = np.asarray(data)
    dd = DomainDecomposer(arr.shape, arr.dtype, config)
    metas, datas, sls = [], [], []
    coords_list = [np.asarray(c, np.float64) for c in coords] if coords else None
    for i in range(dd.num_subdomains):
        sl = dd.subdomain_slices(i)
        sub_coords = (
            [c[s] for c, s in zip(coords_list, sl)] if coords_list else None
        )
        m, d = MDRefactor(arr[sl], config, sub_coords)
        metas.append(m)
        datas.append(d)
        sls.append(sl)
    return DecomposedMDR(
        shape=tuple(int(s) for s in arr.shape),
        subdomain_slices=sls,
        metas=metas,
        datas=datas,
    )


def MDRequestDecomposed(
    dmdr: DecomposedMDR, tol: float, s: float = float("inf")
) -> List[List[int]]:
    """Plan per-subdomain bitplane counts for a global tolerance.

    estimate_error returns RMS-NORMALIZED bounds (components.py divides by
    sqrt(n)), and the global RMS is a weighted MEAN of per-subdomain RMS
    values — so each subdomain independently meeting tol already implies
    the global bound for BOTH s=inf and finite s. (The tol/sqrt(S)
    quadrature rule applies only to unnormalized L2 norms, e.g.
    compression's calc_local_abs_tol; dividing here double-counted the
    split and over-fetched ~sqrt(S)x plane bytes.)"""
    return [MDRequest(m, tol, s) for m in dmdr.metas]


def MDReconstructDecomposed(
    dmdr: DecomposedMDR,
    counts: Optional[List[List[int]]] = None,
    config: Optional[Config] = None,
) -> np.ndarray:
    """Reconstruct the full domain from per-subdomain plans."""
    config = config or Config()
    out = np.empty(dmdr.shape, np_dtype(dmdr.metas[0].dtype))
    for i, (m, d, sl) in enumerate(
        zip(dmdr.metas, dmdr.datas, dmdr.subdomain_slices)
    ):
        c = counts[i] if counts is not None else None
        out[sl] = MDReconstruct(m, d, c, config).data
    return out
