"""MDR / MDR-X: progressive multi-precision refactoring and retrieval.

A re-design of the reference MDR-X component kit
(reference: include/mgard-x/MDR-X/, public API include/mdr_x.hpp:16-38):
decompose -> per-level interleave -> bitplane encode (+per-bitplane error
tables) -> size-interpreted, error-driven progressive retrieval ->
incremental reconstruction.
"""

from .api import (  # noqa: F401
    DecomposedMDR,
    MDReconstruct,
    MDReconstructDecomposed,
    MDRequest,
    MDRequestDecomposed,
    MDRefactor,
    MDRefactorDecomposed,
    ReconstructedData,
    RefactoredData,
    RefactoredMetadata,
    read_mdr_metadata,
    read_mdr_planes,
    retrieve_size,
    write_mdr,
)
