"""Single-copy byte assembly for stream serialization.

Serializers describe a stream as a flat list of *parts* instead of
concatenating eagerly; :func:`join` then writes every payload byte exactly
once into the final ``bytes`` object. The reference pays this cost in C++
(Metadata::Serialize memcpys each section once into one malloc'd buffer —
/root/reference/src/mgard-x/Metadata/Metadata.cpp SerializeAll); the
eager-``+``/``b"".join`` style this replaces copied the 512^3 payload
~5x between device fetch and the final blob.

A part is one of
  - ``bytes`` / ``bytearray`` / ``memoryview``  — copied verbatim;
  - ``np.ndarray``                              — its C-order bytes
    (little-endian dtypes; non-contiguous arrays are written through a
    strided view of the destination when alignment admits it);
  - :class:`Fill`                               — ``size`` bytes produced
    by ``fn(out)`` writing into a uint8 view of the destination region
    (lets e.g. BFP residual compaction target the final buffer directly).

``join`` allocates the result with ``PyBytes_FromStringAndSize(NULL, n)``
and fills it in place through a NumPy view — the only way in CPython to
build ``bytes`` without a final extra copy. The object is not shared
until fully written, so immutability is preserved observably. On any
non-CPython runtime (no ``ctypes.pythonapi``) a bytearray fallback keeps
correctness at the cost of that one extra copy.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, List, NamedTuple, Union

import numpy as np

# parts write disjoint destination regions, so assembly parallelizes
# trivially; numpy block copies release the GIL. 0/1 disables (default on
# single-core hosts); multi-core hosts benefit up to memory bandwidth.
_THREADS = int(os.environ.get("MGARD_TPU_SERIALIZE_THREADS",
                              min(4, os.cpu_count() or 1)))
_MIN_PARALLEL_BYTES = 8 << 20


class Fill(NamedTuple):
    """A deferred region: ``fn`` writes exactly ``size`` bytes into the
    uint8 destination view it is handed."""

    size: int
    fn: Callable[[np.ndarray], None]


Part = Union[bytes, bytearray, memoryview, np.ndarray, Fill]

try:  # CPython fast path
    _new_bytes = ctypes.pythonapi.PyBytes_FromStringAndSize
    _new_bytes.restype = ctypes.py_object
    _new_bytes.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
    _bytes_ptr = ctypes.pythonapi.PyBytes_AsString
    _bytes_ptr.restype = ctypes.c_void_p
    _bytes_ptr.argtypes = [ctypes.py_object]
    _HAVE_CAPI = True
except AttributeError:  # pragma: no cover - non-CPython
    _HAVE_CAPI = False


def part_nbytes(p: Part) -> int:
    if isinstance(p, Fill):
        return int(p.size)
    if isinstance(p, (np.ndarray, memoryview)):
        return int(p.nbytes)  # len(memoryview) counts ELEMENTS, not bytes
    return len(p)


def parts_size(parts) -> int:
    return sum(part_nbytes(p) for p in parts)


def _write_array(dst_u8: np.ndarray, src: np.ndarray) -> None:
    # wire format is little-endian: normalize explicit '>' AND native
    # order on big-endian hosts (byteorder '=' there is also BE)
    if src.dtype.byteorder == ">" or (
        src.dtype.byteorder == "=" and sys.byteorder == "big"
        and src.dtype.itemsize > 1
    ):
        src = src.astype(src.dtype.newbyteorder("<"))
    if src.flags.c_contiguous:
        dst_u8[:] = src.reshape(-1).view(np.uint8)
        return
    try:
        # strided copy straight into the destination (no staging buffer);
        # numpy views only require the byte count to divide, not alignment
        np.copyto(dst_u8.view(src.dtype).reshape(src.shape), src)
    except ValueError:
        dst_u8[:] = np.ascontiguousarray(src).reshape(-1).view(np.uint8)


def _write_part(dst: np.ndarray, p: Part) -> None:
    if isinstance(p, Fill):
        p.fn(dst)
    elif isinstance(p, np.ndarray):
        _write_array(dst, p)
    else:
        dst[:] = np.frombuffer(p, np.uint8)


def join_into(out: np.ndarray, parts, threads: int | None = None) -> int:
    """Write ``parts`` consecutively into uint8 array ``out``; returns the
    total byte count written. Parts target disjoint regions, so big
    streams are written by a thread pool when ``threads`` (default: the
    MGARD_TPU_SERIALIZE_THREADS env knob, capped at 4) allows."""
    parts = list(parts)  # one-shot iterators are walked twice below
    offs, o = [], 0
    for p in parts:
        offs.append(o)
        o += part_nbytes(p)
    nthreads = _THREADS if threads is None else threads
    if nthreads > 1 and o >= _MIN_PARALLEL_BYTES and len(parts) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=nthreads) as ex:
            list(ex.map(
                lambda t: _write_part(out[t[0] : t[0] + part_nbytes(t[1])],
                                      t[1]),
                zip(offs, parts),
            ))
        return o
    for off, p in zip(offs, parts):
        _write_part(out[off : off + part_nbytes(p)], p)
    return o


def join(parts) -> bytes:
    """Assemble parts into one ``bytes`` with a single copy per byte."""
    parts = list(parts)  # guard one-shot iterators: sized twice below
    total = parts_size(parts)
    if not _HAVE_CAPI:  # pragma: no cover - non-CPython
        buf = np.empty(total, np.uint8)
        join_into(buf, parts)
        return buf.tobytes()
    blob = _new_bytes(None, total)
    if total:
        ptr = _bytes_ptr(blob)
        view = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(total,)
        )
        join_into(view, parts)
    return blob
