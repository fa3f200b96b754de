"""Runtime configuration.

Mirrors the reference Config knobs (reference: include/mgard-x/Config/Config.h:10-46
with defaults from src/mgard-x/Config/Config.cpp:33-68), dropping the
device-selection fields (dev_type/dev_id: JAX owns device placement) and
adding this framework's own (mesh/sharding controls, codec knobs).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .dtypes import (
    bitplane_encoding_type,
    block_delta_mode_type,
    compressor_type,
    decomposition_type,
    domain_decomposition_type,
    lossless_type,
)

_UNLIMITED = 2**63 - 1


@dataclasses.dataclass
class Config:
    # --- compression pipeline selection -------------------------------
    compressor: compressor_type = compressor_type.MGARD
    # Defaults = the flagship pipeline: Hybrid decomposition (blockwise
    # 8^3 local refactor + global remainder, reference
    # HybridHierarchyCompressor) with the BFP width-sorted prefix codec.
    # Finite-s / non-raw-backend requests transparently fall back to the
    # MultiDim transform with identical certified constants, and every
    # choice is recorded in the self-describing header.
    decomposition: decomposition_type = decomposition_type.Hybrid
    # The reference defaults to (GPU-)Huffman (Config.cpp:33-68); this
    # framework was first built for a device on which data-dependent
    # gathers made table-driven Huffman the slow path, so the gather-light
    # sorted-prefix codec is the default. Huffman/BFX remain selectable and
    # the format is self-describing either way.
    lossless: lossless_type = lossless_type.BFP

    # float64 fast path: when the L-inf error budget covers the exact
    # f64->f32 cast error (measured on device), compress the f32 image
    # through the flagship hybrid pipeline with the cast error deducted
    # from the tolerance — the certified end-to-end bound is unchanged.
    # The reference instantiates double natively everywhere
    # (reference: include/compress_x.hpp:31-159); the demotion halves the
    # bytes every stage moves. Tight tolerances (budget < 4x cast error)
    # keep the full f64 transform.
    f64_demote: bool = True

    # --- quantization / entropy knobs ---------------------------------
    estimate_outlier_ratio: float = 1.0
    # Monotone-canonical device Huffman (arithmetic zigzag-rank codes; see
    # lossless/huffman_mono.py) vs classic table-driven codec.
    huffman_mono: bool = True
    huff_dict_size: int = 8192
    huff_block_size: int = 1024
    block_delta_block_size: int = 256
    block_delta_mode: block_delta_mode_type = block_delta_mode_type.Delta
    zstd_compress_level: int = 3

    # --- hierarchy / shape handling ------------------------------------
    normalize_coordinates: bool = True
    reorder: int = 0
    max_larget_level: int = _UNLIMITED  # (sic) reference spelling
    adjust_shape: bool = False

    # --- domain decomposition ------------------------------------------
    domain_decomposition: domain_decomposition_type = domain_decomposition_type.MaxDim
    domain_decomposition_dim: int = 0
    domain_decomposition_sizes: Sequence[int] = dataclasses.field(default_factory=list)
    max_memory_footprint: int = _UNLIMITED

    # --- pipelining ------------------------------------------------------
    # Overlap subdomain i+1's device dispatch with subdomain i's host
    # serialization (reference: GPUPipelines.hpp double buffering).
    # (The reference's auto_pin_host_buffers / cpu_mode knobs have no
    # counterpart: JAX owns host staging and XLA owns host threading.)
    prefetch: bool = True

    # --- MDR -------------------------------------------------------------
    total_num_bitplanes: int = 32
    block_size: int = 256
    mdr_qoi_mode: bool = False
    mdr_qoi_num_variables: int = 3
    # Bitplane encoding: SignMagnitude (sign plane + magnitude planes) or
    # NegaBinary (no sign plane; reference ComposedRefactor.hpp:24).
    mdr_encoding: bitplane_encoding_type = bitplane_encoding_type.SignMagnitude
    # Basis for the MDR decomposition: hierarchical (default, reference
    # MGARDHierarchicalDecomposer) or L2-orthogonal (MGARDOrthoganalDecomposer).
    mdr_orthogonal_basis: bool = False
    # Per-bitplane level compressor (reference: MDR-X/LosslessCompressor/
    # Default/Hybrid/Adaptive/Null): "zlib" (host), "bfx" (device codec,
    # used for planes large enough to amortize), or "none".
    mdr_level_compressor: str = "zlib"
    # MDR interleaver (reference: MDR-X/Interleaver/): "direct" =
    # level-linearized nested-box slabs; "blocked" = 4^D spatial tiles
    # within each slab; "sfc" = Morton/Z-order within each slab (the
    # reference SFCInterleaver's locality-preserving curve). All are pure
    # reshape/transpose and recorded in the stream header.
    mdr_interleaver: str = "direct"


    # --- hybrid refactoring ----------------------------------------------
    # 3 local levels = the full 8 -> 5 -> 3 -> 2 in-block chain (reference
    # Decompose8x8x8); the benched flagship configuration.
    num_local_refactoring_level: int = 3
    # Group hybrid symbols by minor-axis position class before entropy
    # coding: +~6% compression ratio for -~6% throughput (one extra
    # relayout pass each way). Recorded in the blob header.
    hybrid_level_grouping: bool = True

    # --- misc -------------------------------------------------------------
    log_level: int = 0

    # --- additions of this framework -----------------------------------------
    # Maximum number of outliers the fixed-size device capture buffer holds,
    # as a fraction of total elements. Compression falls back to a larger
    # buffer (re-trace) if exceeded.
    outlier_capacity_ratio: float = 1.0 / 64.0
    # Name of the mesh axis subdomains are sharded over (parallel pipeline).
    mesh_axis: str = "subdomain"
    # BFX superblock size in 32-symbol blocks (None = size-based default;
    # set by utils.autotuner.apply_autotune from the persistent table).
    bfx_sb_blocks: Optional[int] = None
    # BFP (lossless/bfp.py) base plane count (0 = auto from the first
    # stream's width histogram, sticky per stream size) and residual plane
    # capacity (0 = default 8; valid explicit range 1..15 — residual
    # lengths are stored as 4-bit nibbles in the sidecar).
    bfp_base_planes: int = 0
    bfp_resid_planes: int = 0
    # BFP superblock size in 32-symbol blocks (None = size-based default;
    # set by utils.autotuner.apply_autotune from the persistent table).
    bfp_sb_blocks: Optional[int] = None
    # BFP sort-chunk size in blocks (0 = default 8). Bigger chunks make the
    # sort-gather rows wider and fewer but coarsen the chunk-max width,
    # trading ratio for speed. Recorded in each blob.
    bfp_chunk: int = 0
    # Consult the persistent autotuner table automatically on compress()
    # (the reference's AutoTuningTable lookup per kernel launch,
    # AutoTuner.h:46-118). Explicitly-set knobs are never overridden.
    autotune_lookup: bool = True

    def apply_autotune(self, shape, dtype):
        """Overwrite tunable knobs from the persistent autotuner table
        (reference: AutoTuner.h profiled tables + rebuild)."""
        from .utils.autotuner import apply_autotune

        apply_autotune(self, shape, dtype)
        return self
