"""The paper's primary contribution, ported to PyTorch: (Decomposed)
Accelerated Projection-Based Consensus solvers on the dense and the
matrix-free paths."""
from repro_torch.core.partition import (
    Partition,
    PartitionPlan,
    block_rhs,
    partition_matrix,
    partition_system,
    resolve_mode,
)
from repro_torch.core.spectra import (
    block_spectra_dense,
    block_spectra_matfree,
    derive_dynamics,
)
from repro_torch.core.solver_api import (
    ColumnResult,
    PrepareConfig,
    PreparedSolver,
    SolveOptions,
    SolveResult,
    prepare,
    resolve_path,
    solve,
)
from repro_torch.core.matfree import MatrixFreePreparedSolver, prepare_matfree
from repro_torch.core.apc import solve_apc, setup_classical, classical_factors
from repro_torch.core.dapc import (
    solve_dapc,
    setup_decomposed,
    make_apply,
    qr_blocks,
    initial_from_factors,
)
from repro_torch.core.consensus import (
    block_residual_sq,
    evaluate_candidates,
    run_consensus,
    tune_hyperparams,
)

__all__ = [
    "Partition",
    "PartitionPlan",
    "block_spectra_dense",
    "block_spectra_matfree",
    "derive_dynamics",
    "evaluate_candidates",
    "partition_system",
    "partition_matrix",
    "block_rhs",
    "resolve_mode",
    "SolveResult",
    "SolveOptions",
    "ColumnResult",
    "PrepareConfig",
    "PreparedSolver",
    "MatrixFreePreparedSolver",
    "prepare",
    "prepare_matfree",
    "resolve_path",
    "solve",
    "solve_apc",
    "setup_classical",
    "classical_factors",
    "solve_dapc",
    "setup_decomposed",
    "make_apply",
    "qr_blocks",
    "initial_from_factors",
    "run_consensus",
    "tune_hyperparams",
    "block_residual_sq",
]
