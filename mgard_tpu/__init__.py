"""mgard-tpu: MGARD in JAX — error-bounded lossy compression and
progressive refactoring of scientific data on structured grids.

A from-scratch JAX/XLA re-design with the capabilities of
JieyangChen7/MGARD (see SURVEY.md): multilevel decomposition, error-bound
driven levelwise quantization, device entropy coding, self-describing format,
domain decomposition sharded over device meshes, and MDR progressive
bitplane refactoring.
"""

import os as _os

import jax as _jax

# float64 inputs are a first-class feature of the reference (data_type::Double);
# JAX requires the x64 flag for them. f32 paths keep explicit float32 dtypes.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: repeated compressions of the same shape are
# compile-free across processes (plays the role of the reference's
# CompressorCache + AutoTuner tables persisting across runs). Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and the directory is
# left alone; otherwise the cache lives at one fixed path inside the
# checkout, next to the package (listed in .gitignore). JAX's own
# jax_enable_compilation_cache setting turns it off.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".xla_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .config import Config  # noqa: E402
from .dtypes import (  # noqa: E402
    compress_status_type,
    data_type,
    decomposition_type,
    domain_decomposition_type,
    error_bound_type,
    lossless_type,
)
from .hierarchy import Hierarchy, get_hierarchy  # noqa: E402

__version__ = "0.1.0"
__all__ = [
    "Config",
    "Hierarchy",
    "get_hierarchy",
    "compress",
    "decompress",
    "compress_status_type",
    "data_type",
    "decomposition_type",
    "domain_decomposition_type",
    "error_bound_type",
    "lossless_type",
    "norm",
]


def __getattr__(name):
    # Lazy high-level API import to keep `import mgard_tpu` light.
    if name in ("compress", "decompress", "compress_roi",
                "calculate_norm"):
        from . import highlevel

        return getattr(highlevel, name)
    if name == "norm":
        # mgard::norm parity (reference include/mgard/TensorNorms.hpp)
        from .ops.norms import norm

        return norm
    raise AttributeError(f"module 'mgard_tpu' has no attribute {name!r}")
