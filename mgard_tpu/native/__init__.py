"""Native (C++) runtime components, built on demand with the system
toolchain and loaded through ctypes.

The device compute path is JAX/XLA; host-side byte-chasing work that a
whole-array vector program cannot express (LZ4 match search, stream splicing) lives
here instead — the same division of labor as the reference's host Zstd
stage (reference: include/mgard-x/Lossless/Zstd.hpp:30-120).

Shared objects are cached under ~/.cache/mgard_tpu/native keyed by a hash
of the source, so rebuilds happen only when the source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent
_CACHE_DIR = Path(
    os.environ.get(
        "MGARD_TPU_NATIVE_CACHE",
        os.path.expanduser("~/.cache/mgard_tpu/native"),
    )
)
_LOCK = threading.Lock()
_LOADED: dict = {}


class NativeBuildError(RuntimeError):
    pass


def _build(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cpp"
    code = src.read_bytes()
    tag = hashlib.sha256(code).hexdigest()[:16]
    out = _CACHE_DIR / f"lib{name}-{tag}.so"
    if out.exists():
        return out
    _CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        os.environ.get("CXX", "g++"),
        "-O3",
        "-shared",
        "-fPIC",
        "-std=c++17",
        str(src),
        "-o",
        str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        raise NativeBuildError(
            f"building {src.name} failed: {detail.decode(errors='replace')}"
        ) from e
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the named native module."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ctypes.CDLL(str(_build(name)))
        return _LOADED[name]
