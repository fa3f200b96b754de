"""Decode reference MGARD **CPU-generation** streams (``mgard::compress``).

The reference ships two stream generations behind one ``MGARD`` magic:
the MGARD-X family (handled by :mod:`.ref_stream`) and the older CPU
library whose payload is CPU-Huffman + zstd/zlib
(reference: include/compress.tpp:34-84, src/mgard/compressors.cpp:316-512).
This module decodes the CPU generation end-to-end so
``mgard_tpu.decompress`` reads *any* reference-written file:

  header (shared proto3 container, parsed by ref_stream.parse_header)
    -> CPU-Huffman decode      (src/mgard/compressors.cpp:183-313)
    -> dequantize              (include/mgard/TensorMultilevelCoefficientQuantizer.tpp)
    -> unshuffle               (include/mgard/shuffle.tpp)
    -> CPU-convention recompose (include/mgard/decompose.tpp:180-218)

Everything here follows the reference's *algorithms* re-derived from the
math (1D FEM mass/prolongation/restriction stencils as dense per-axis
operators applied as tensor products in numpy); nothing is translated
line-by-line. This is a host-side interop path for reading
reference-written files, not a performance path — the device pipeline is
`highlevel.compress`/`decompress` on this framework's own format.

Fidelity notes:
  * The Huffman tree must be rebuilt EXACTLY as the encoder built it,
    including `std::priority_queue` tie-breaking, so `_heap_push`/
    `_heap_pop` emulate libstdc++'s `__push_heap`/`__adjust_heap`
    element movement faithfully.
  * The reference runs its transform in the stream dtype (f32 for float
    data); we recompose in f64 and cast, so decoded values agree with the
    reference's own decompressor to f32-rounding class, not bit-exactly.
    The golden tests pin this (tests/test_cpu_stream.py).
"""

import math
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .metadata import FormatError

# mgard::nql (src/mgard/compressors.cpp:29): symbol alphabet size; level 0
# is the out-of-range escape, symbols are q + NQL/2.
NQL = 32768 * 4


# ----------------------------------------------------------------------
# CPU TensorMeshHierarchy (include/mgard/TensorMeshHierarchy.tpp:39-137)
# ----------------------------------------------------------------------
class CpuHierarchy:
    """Level index sets, dates of birth and shuffle order of the reference
    CPU mesh hierarchy (dyadic chain with non-dyadic finest level)."""

    def __init__(self, shape: Sequence[int],
                 coords: Optional[Sequence[np.ndarray]] = None):
        shape = tuple(int(n) for n in shape)
        if any(n < 1 for n in shape):
            raise FormatError("invalid CPU-stream shape")
        self.shape = shape
        N = len(shape)

        # L: dyadic level count, +1 when any axis is non-dyadic
        l_dyadic = None
        any_nondyadic = False
        base = []
        for n in shape:
            if n == 1:
                base.append(1)
                continue
            l = (n - 1).bit_length() - 1  # log2(n - 1)
            l_dyadic = l if l_dyadic is None else min(l_dyadic, l)
            any_nondyadic = any_nondyadic or ((1 << l) + 1) != n
            base.append((1 << l) + 1)
        if l_dyadic is None:
            raise FormatError("CPU-stream dataset is flat in every dimension")
        self.L = l_dyadic + 1 if any_nondyadic else l_dyadic

        # shapes per level: dyadic chain from the rounded-down finest
        shp = [1 if n == 1 else (((b - 1) >> l_dyadic) + 1)
               for n, b in zip(shape, base)]
        self.level_shapes: List[Tuple[int, ...]] = []
        for _ in range(self.L):
            self.level_shapes.append(tuple(shp))
            shp = [1 if n == 1 else (m - 1) * 2 + 1
                   for n, m in zip(shape, shp)]
        self.level_shapes.append(shape)

        # per-dim index sets: indices(l, i)[j] = (j * (n_fine-1)) // (n_l-1)
        self.indices: List[List[np.ndarray]] = []
        for l in range(self.L + 1):
            per_dim = []
            for i, n in enumerate(shape):
                nl = self.level_shapes[l][i]
                if n == 1:
                    per_dim.append(np.zeros(1, np.int64))
                else:
                    j = np.arange(nl, dtype=np.int64)
                    per_dim.append((j * (n - 1)) // (nl - 1))
            self.indices.append(per_dim)

        # per-dim dates of birth: coarsest level containing the index
        self.dob_dim: List[np.ndarray] = []
        for i, n in enumerate(shape):
            dob = np.zeros(n, np.int64)
            for l in range(self.L, -1, -1):
                dob[self.indices[l][i]] = l
            self.dob_dim.append(dob)

        # node date of birth = max over dims; shuffle = stable sort by dob
        # (shuffle.tpp: per-level writers fed in unshuffled order)
        dob = self.dob_dim[0].reshape((-1,) + (1,) * (N - 1))
        for i in range(1, N):
            shp_i = [1] * N
            shp_i[i] = shape[i]
            dob = np.maximum(dob, self.dob_dim[i].reshape(shp_i))
        self.dob_grid = dob
        self.shuffle_perm = np.argsort(dob.ravel(), kind="stable")

        if coords is None:
            self.coords = [
                (np.arange(n, dtype=np.float64) / (n - 1) if n > 1
                 else np.zeros(1, np.float64))
                for n in shape
            ]
        else:
            if len(coords) != N or any(len(c) != n
                                       for c, n in zip(coords, shape)):
                raise FormatError("CPU-stream coordinate count mismatch")
            self.coords = [np.asarray(c, np.float64) for c in coords]

    @property
    def ndof(self) -> int:
        return int(np.prod(self.shape))


# ----------------------------------------------------------------------
# CPU Huffman (src/mgard/compressors.cpp:183-313)
# ----------------------------------------------------------------------
def _heap_push(heap: list, cnt: list, node: int) -> None:
    """std::priority_queue push = push_back + libstdc++ __push_heap with
    comparator cnt[parent] > cnt[value] (min-heap by count)."""
    heap.append(node)
    hole = len(heap) - 1
    val = node
    while hole > 0:
        parent = (hole - 1) // 2
        if cnt[heap[parent]] > cnt[val]:
            heap[hole] = heap[parent]
            hole = parent
        else:
            break
    heap[hole] = val


def _heap_pop(heap: list, cnt: list) -> int:
    """std::priority_queue pop = libstdc++ __pop_heap + pop_back; the
    __adjust_heap element movement is reproduced exactly because tie
    placement decides Huffman tree shape."""
    top = heap[0]
    if len(heap) == 1:
        heap.pop()
        return top
    val = heap[-1]
    heap[-1] = heap[0]
    length = len(heap) - 1
    hole = 0
    second = 0
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if cnt[heap[second]] > cnt[heap[second - 1]]:
            second -= 1
        heap[hole] = heap[second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        heap[hole] = heap[second - 1]
        hole = second - 1
    while hole > 0:
        parent = (hole - 1) // 2
        if cnt[heap[parent]] > cnt[val]:
            heap[hole] = heap[parent]
            hole = parent
        else:
            break
    heap[hole] = val
    heap.pop()
    return top


def _build_tree(freq_pairs: np.ndarray):
    """Rebuild the Huffman tree from the serialized (symbol, count) table.
    Returns (q, left, right, root) arrays; leaves carry q >= 0."""
    q: List[int] = []
    cnt: List[int] = []
    left: List[int] = []
    right: List[int] = []
    heap: list = []
    for sym, c in freq_pairs:
        q.append(int(sym))
        cnt.append(int(c))
        left.append(-1)
        right.append(-1)
        _heap_push(heap, cnt, len(q) - 1)
    if not heap:
        raise FormatError("empty CPU-Huffman frequency table")
    while len(heap) > 1:
        a = _heap_pop(heap, cnt)
        b = _heap_pop(heap, cnt)
        q.append(-1)
        cnt.append(cnt[a] + cnt[b])
        left.append(a)
        right.append(b)
        _heap_push(heap, cnt, len(q) - 1)
    return q, left, right, heap[0]


def _bitstream(hit: bytes) -> np.ndarray:
    """The encoder packs codes MSB-first into little-endian u32 words
    (compressors.cpp:345-384): stream bit b lives at mask 0x80000000 >>
    (b % 32) of word b // 32."""
    pad = (-len(hit)) % 4
    words = np.frombuffer(hit + b"\x00" * pad, "<u4")
    return np.unpackbits(np.frombuffer(words.astype(">u4").tobytes(),
                                       np.uint8))


def decode_huffman_cpu(payload: bytes, ndof: int, zstd: bool) -> np.ndarray:
    """CPU-Huffman container -> int64 quantized symbols (shuffled order).

    Layout (compressors.cpp:494-511): 3 x u64 (tree bytes, hit bits, miss
    bytes) then one zstd/zlib frame of [freq table | hit bits | miss i32s].
    """
    if len(payload) < 24:
        raise FormatError("truncated CPU-Huffman payload")
    tree_size, hit_bits, miss_bytes = struct.unpack_from("<3Q", payload, 0)
    hit_bytes = hit_bits // 8 + 4
    total = tree_size + hit_bytes + miss_bytes
    frame = payload[24:]
    try:
        if zstd:
            from ..lossless.host import zstd_decompress

            raw = zstd_decompress(bytes(frame), int(total))
        else:
            raw = zlib.decompress(bytes(frame))
    except Exception as exc:
        raise FormatError(f"corrupt CPU-Huffman container: {exc}") from exc
    if len(raw) != total:
        raise FormatError("CPU-Huffman container size mismatch")
    if tree_size % 16:
        raise FormatError("malformed CPU-Huffman frequency table")
    if miss_bytes % 4:
        raise FormatError("malformed CPU-Huffman miss stream length")
    freq = np.frombuffer(raw, "<u8", count=tree_size // 8).reshape(-1, 2)
    hit = raw[tree_size : tree_size + hit_bytes]
    miss = np.frombuffer(raw, "<i4", offset=tree_size + hit_bytes)

    qv, left, right, root = _build_tree(freq)
    out = np.empty(ndof, np.int64)
    half = NQL // 2
    if left[root] < 0:
        # degenerate single-symbol tree: zero bits per symbol
        sym = qv[root]
        if sym != 0:
            out[:] = sym - half
        else:
            if miss.size < ndof:
                raise FormatError("CPU-Huffman miss stream underrun")
            out[:] = miss[:ndof].astype(np.int64) - half
        return out
    pos = _walk(hit, hit_bits, qv, left, right, root, miss, half, out)
    if pos != hit_bits:
        raise FormatError("CPU-Huffman bitstream length mismatch")
    return out


def _walk(hit: bytes, hit_bits: int, qv, left, right, root: int,
          miss: np.ndarray, half: int, out: np.ndarray) -> int:
    """Per-symbol tree walk — a serial bit chain, so it runs in native C
    (native/huffdec.cpp) with a pure-python fallback when no toolchain is
    available. Returns the number of bits consumed."""
    ndof = out.size
    try:
        import ctypes

        from ..native import load

        lib = load("huffdec")
        lib.mgard_huffdec_cpu.restype = ctypes.c_int64
        pad = (-len(hit)) % 4
        buf = bytes(hit) + b"\x00" * pad
        l32 = np.asarray(left, np.int32)
        r32 = np.asarray(right, np.int32)
        q32 = np.asarray(qv, np.int32)
        m32 = np.ascontiguousarray(miss, np.int32)
        rc = lib.mgard_huffdec_cpu(
            buf, ctypes.c_int64(hit_bits),
            l32.ctypes.data_as(ctypes.c_void_p),
            r32.ctypes.data_as(ctypes.c_void_p),
            q32.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int32(root), ctypes.c_int32(len(qv)),
            m32.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int64(m32.size), ctypes.c_int64(half),
            out.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(ndof),
        )
        if rc == -1:
            raise FormatError("CPU-Huffman bitstream underrun")
        if rc == -2:
            raise FormatError("CPU-Huffman miss stream underrun")
        if rc == -3:
            raise FormatError("corrupt CPU-Huffman tree")
        return int(rc)
    except ImportError:
        pass
    except Exception as exc:
        from ..native import NativeBuildError

        if not isinstance(exc, NativeBuildError):
            raise
    bits = _bitstream(bytes(hit))
    nbits = bits.size
    pos = 0
    mi = 0
    for k in range(ndof):
        n = root
        while left[n] >= 0:
            if pos >= nbits:
                raise FormatError("CPU-Huffman bitstream underrun")
            n = right[n] if bits[pos] else left[n]
            pos += 1
        sym = qv[n]
        if sym != 0:
            out[k] = sym - half
        else:
            if mi >= miss.size:
                raise FormatError("CPU-Huffman miss stream underrun")
            out[k] = int(miss[mi]) - half
            mi += 1
    return pos


# ----------------------------------------------------------------------
# Dequantization (TensorMultilevelCoefficientQuantizer.tpp:12-56)
# ----------------------------------------------------------------------
def _quantum_grid(hier: CpuHierarchy, s: float, tol: float) -> np.ndarray:
    """Per-node quantum in PHYSICAL layout."""
    d_eff = sum(1 for n in hier.shape if n > 1)
    if math.isinf(s):
        q = 2.0 * tol / ((hier.L + 1) * (1 + 3.0 ** d_eff))
        return np.full(hier.shape, q, np.float64)
    out = np.zeros(hier.shape, np.float64)
    ndof = hier.ndof
    for ell in range(hier.L + 1):
        vol_vecs = []
        for i, n in enumerate(hier.shape):
            idx = hier.indices[ell][i]
            if n == 1:
                vol_vecs.append(np.ones(1, np.float64))
                continue
            x = hier.coords[i][idx]
            # predecessor/successor clamp at the boundary
            # (utilities.tpp:295-317)
            succ = np.concatenate([x[1:], x[-1:]])
            pred = np.concatenate([x[:1], x[:-1]])
            vol_vecs.append((succ - pred) / 2.0)
        vol = vol_vecs[0].reshape((-1,) + (1,) * (len(hier.shape) - 1))
        for i in range(1, len(hier.shape)):
            shp = [1] * len(hier.shape)
            shp[i] = vol_vecs[i].size
            vol = vol * vol_vecs[i].reshape(shp)
        quant = 2.0 * tol / (np.exp2(s * ell) * np.sqrt(ndof * vol))
        ix = np.ix_(*hier.indices[ell])
        born_here = hier.dob_grid[ix] == ell
        sub = out[ix]
        sub[born_here] = quant[born_here]
        out[ix] = sub
    return out


# ----------------------------------------------------------------------
# CPU-convention recompose (decompose.tpp:180-218), dense per-axis
# operators applied as tensor products
# ----------------------------------------------------------------------
def _mass_mat(x: np.ndarray) -> np.ndarray:
    """1D FEM mass matrix on nodes x (TensorMassMatrix.tpp:15-90)."""
    n = x.size
    h = np.diff(x)
    M = np.zeros((n, n))
    M[0, 0] = h[0] / 3
    M[0, 1] = h[0] / 6
    for i in range(1, n - 1):
        M[i, i - 1] = h[i - 1] / 6
        M[i, i] = (h[i - 1] + h[i]) / 3
        M[i, i + 1] = h[i] / 6
    M[n - 1, n - 2] = h[-1] / 6
    M[n - 1, n - 1] = h[-1] / 3
    return M


def _interp_mats(xf: np.ndarray, pos: np.ndarray):
    """(P, R): multilinear prolongation fine<-coarse and its transpose-
    with-identity restriction (TensorProlongation.tpp / TensorRestriction
    .tpp). P rows at coarse positions are identity; new rows lerp the two
    surrounding coarse nodes in coordinate space."""
    n = xf.size
    nc = pos.size
    P = np.zeros((n, nc))
    P[pos, np.arange(nc)] = 1.0
    R = np.zeros((nc, n))
    R[np.arange(nc), pos] = 1.0
    j = 0
    for m in range(n):
        if j + 1 < nc and m == pos[j + 1]:
            j += 1
        if m == pos[j]:
            continue
        xl, xr = xf[pos[j]], xf[pos[j + 1]]
        wl = (xr - xf[m]) / (xr - xl)
        P[m, j] = wl
        P[m, j + 1] = 1.0 - wl
        R[j, m] = wl
        R[j + 1, m] = 1.0 - wl
    return P, R


def _apply(mat: np.ndarray, a: np.ndarray, axis: int) -> np.ndarray:
    return np.moveaxis(np.tensordot(mat, a, axes=(1, axis)), 0, axis)


class _LevelOps:
    """Per-(level, axis) operators for one CpuHierarchy."""

    def __init__(self, hier: CpuHierarchy, l: int):
        self.hier = hier
        self.l = l
        N = len(hier.shape)
        self.corr = [None] * N  # (nc x n) Minv_coarse @ R @ M_fine
        self.prol = [None] * N  # (n x nc)
        self.pos = []
        for i, n in enumerate(hier.shape):
            idx_f = hier.indices[l][i]
            idx_c = hier.indices[l - 1][i]
            pos = np.searchsorted(idx_f, idx_c)
            self.pos.append(pos)
            if n == 1:
                continue
            xf = hier.coords[i][idx_f]
            P, R = _interp_mats(xf, pos)
            Mf = _mass_mat(xf)
            Mc = _mass_mat(hier.coords[i][idx_c])
            self.corr[i] = np.linalg.solve(Mc, R @ Mf)
            self.prol[i] = P

    def new_mask(self) -> np.ndarray:
        """mesh-l-local boolean mask of the nodes NOT in mesh l-1."""
        shp = self.hier.level_shapes[self.l]
        old = np.zeros(shp, bool)
        old[np.ix_(*self.pos)] = True
        return ~old


def recompose_cpu(u_phys: np.ndarray, hier: CpuHierarchy) -> np.ndarray:
    """Inverse of the reference CPU multilevel transform, physical layout,
    f64 arithmetic (decompose.tpp:180-218 level loop)."""
    v = np.asarray(u_phys, np.float64).copy()
    for l in range(1, hier.L + 1):
        ops = _LevelOps(hier, l)
        ixl = np.ix_(*hier.indices[l])
        ixc = np.ix_(*hier.indices[l - 1])
        G = v[ixl]
        B = G.copy()
        B[np.ix_(*ops.pos)] = 0.0  # zero_on_old_copy_on_new
        for i in range(len(hier.shape)):  # M, R, m_inv per axis
            if ops.corr[i] is not None:
                B = _apply(ops.corr[i], B, i)
        Bc = B - v[ixc]  # subtract_on_old (buffer -= Q_{l-1}u)
        I_full = Bc
        for i in range(len(hier.shape)):  # prolongation addition
            if ops.prol[i] is not None:
                I_full = _apply(ops.prol[i], I_full, i)
        new = ops.new_mask()
        G[new] -= I_full[new]  # v[new] -= -interp(Pi Q_l u) [negated below]
        G[np.ix_(*ops.pos)] = -Bc  # v[old] = -(buffer on old)
        v[ixl] = G
    return v


def decompose_cpu(u_phys: np.ndarray, hier: CpuHierarchy) -> np.ndarray:
    """Forward CPU transform (decompose.tpp:128-175), for tests."""
    v = np.asarray(u_phys, np.float64).copy()
    for l in range(hier.L, 0, -1):
        ops = _LevelOps(hier, l)
        ixl = np.ix_(*hier.indices[l])
        ixc = np.ix_(*hier.indices[l - 1])
        G = v[ixl]
        # copy_on_old_zero_on_new + PA == multilinear interp of the coarse
        # values (tensor product of P_i)
        interp = G[np.ix_(*ops.pos)]
        for i in range(len(hier.shape)):
            if ops.prol[i] is not None:
                interp = _apply(ops.prol[i], interp, i)
        new = ops.new_mask()
        surplus = np.zeros_like(G)
        surplus[new] = G[new] - interp[new]
        G[new] = surplus[new]
        corr = surplus
        for i in range(len(hier.shape)):
            if ops.corr[i] is not None:
                corr = _apply(ops.corr[i], corr, i)
        G[np.ix_(*ops.pos)] = G[np.ix_(*ops.pos)] + corr
        v[ixl] = G
    return v


# ----------------------------------------------------------------------
# WRITE side: emit CPU-generation streams the reference library reads
# ----------------------------------------------------------------------
def _serialize_cpu_header(hier: CpuHierarchy, dtype, s: float, tol: float,
                          coords: Optional[Sequence[np.ndarray]]) -> bytes:
    """Binary preamble + proto3 header for a CPU-generation stream
    (big-endian size/CRC framing per src/mgard/format.cpp serialize<>;
    field values mirror populate_defaults + compress.tpp:45-56)."""
    from .ref_stream import (
        SIGNATURE,
        _w_dfield,
        _w_msg,
        _w_packed_u64,
        _w_varint,
        _w_vfield,
    )

    D = len(hier.shape)
    topo = _w_vfield(1, D) + _w_packed_u64(2, hier.shape)
    domain = _w_msg(2, topo)
    if coords is not None:
        flat = np.concatenate([np.asarray(c, "<f8") for c in coords])
        body = flat.tobytes()
        geom = _w_varint(2 << 3 | 2) + _w_varint(len(body)) + body
        domain += _w_vfield(3, 1) + _w_msg(4, geom)  # EXPLICIT_CUBE
    dataset = (
        _w_vfield(1, 1 if np.dtype(dtype) == np.float64 else 0)
        + _w_vfield(2, 1)
    )
    # mode is always ABSOLUTE for mgard::compress (compress.tpp:46)
    s_inf = math.isinf(s)
    errctl = _w_vfield(2, 0 if s_inf else 1)  # L_INFINITY / S_NORM
    if not s_inf and s != 0.0:
        errctl += _w_dfield(3, s)
    errctl += _w_dfield(5, tol)
    quant = _w_vfield(1, 1) + _w_vfield(3, 3)  # COEFFICIENTWISE_LINEAR i64
    enc = _w_vfield(1, 1) + _w_vfield(2, 1)  # SHUFFLE + CPU_HUFFMAN_ZLIB
    body = (
        _w_msg(2, _w_vfield(1, 1) + _w_vfield(2, 6))  # mgard_version 1.6
        + _w_msg(3, _w_vfield(1, 1))  # file format 1.0
        + _w_msg(4, domain)
        + _w_msg(5, dataset)
        + _w_msg(6, errctl)
        + _w_msg(9, quant)
        + _w_msg(11, enc)
    )
    return (SIGNATURE + struct.pack(">Q", len(body))
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body)


def compress_cpu(data, tol: float, s: float = math.inf,
                 coords: Optional[Sequence[np.ndarray]] = None) -> bytes:
    """Compress into a reference CPU-generation stream
    (``mgard::compress`` wire format, CPU_HUFFMAN_ZLIB payload = plain
    zlib of the shuffled int64 quantized stream) that the reference CPU
    library's own ``mgard::decompress`` reads within the certified bound.
    Pinned by tests/golden/cpuwrite_* (generate_cpu_write.sh)."""
    arr = np.ascontiguousarray(data)
    if arr.dtype not in (np.float32, np.float64):
        raise FormatError("CPU-generation streams carry float32/float64")
    hier = CpuHierarchy(arr.shape, coords)
    w = decompose_cpu(arr.astype(np.float64), hier)
    quantum = _quantum_grid(hier, s, tol)
    x = w / quantum
    if np.any(np.abs(x) >= 2.0**62):
        raise FormatError("value too large to be quantized (CPU format)")
    q = np.trunc(np.copysign(0.5 + np.abs(x), x)).astype(np.int64)
    q_shuf = q.ravel()[hier.shuffle_perm]
    payload = zlib.compress(q_shuf.astype("<i8").tobytes(), 9)
    header = _serialize_cpu_header(hier, arr.dtype, s, tol, coords)
    return header + payload


# ----------------------------------------------------------------------
# End-to-end decode
# ----------------------------------------------------------------------
def decompress_cpu(blob: bytes, header) -> np.ndarray:
    """Reference CPU-generation stream -> decoded array (physical layout).

    `header` is a ref_stream.RefHeader (same proto container both
    generations)."""
    from .ref_stream import ENC_CPU_HUFFMAN_ZLIB, ENC_CPU_HUFFMAN_ZSTD

    if header.compressor not in (ENC_CPU_HUFFMAN_ZLIB,
                                 ENC_CPU_HUFFMAN_ZSTD):
        raise FormatError("not a CPU-generation reference stream")
    if (int(np.prod(header.shape, dtype=np.float64)) > (1 << 34)
            or len(header.shape) > 7):
        # forged-header guard (see ref_stream.decompress_reference)
        raise FormatError(
            f"implausible reference stream shape {header.shape}"
        )
    hier = CpuHierarchy(header.shape, header.coords)
    payload = blob[header.header_bytes :]
    if header.compressor == ENC_CPU_HUFFMAN_ZSTD:
        q = decode_huffman_cpu(payload, hier.ndof, zstd=True)
    else:
        # CPU_HUFFMAN_ZLIB is, despite the name, plain zlib of the int64
        # quantized stream (compressors.cpp:664-665 routes it straight to
        # compress_memory_z with no Huffman stage)
        try:
            raw = zlib.decompress(bytes(payload))
        except zlib.error as exc:
            raise FormatError(f"corrupt CPU-zlib payload: {exc}") from exc
        if len(raw) != hier.ndof * 8:
            raise FormatError("CPU-zlib quantized stream size mismatch")
        q = np.frombuffer(raw, "<i8").copy()
    quantum = _quantum_grid(hier, header.s, header.tol)
    u_phys = np.empty(hier.ndof, np.float64)
    u_phys[hier.shuffle_perm] = q  # unshuffle (shuffle.tpp:24-38)
    u_phys = u_phys.reshape(hier.shape) * quantum
    out = recompose_cpu(u_phys, hier)
    return out.astype(header.dtype)
