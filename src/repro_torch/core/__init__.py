"""The paper's primary contribution, ported to PyTorch: (Decomposed)
Accelerated Projection-Based Consensus solvers on the dense and the
matrix-free paths, the DGD and CGNR baselines, streaming sessions, the
solve watchdog, and the multi-device solvers on ``torch.distributed`` (the
sharded matrix-free solver, ``solve_sharded``/``solve_sharded_2d``)."""
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
from repro_torch.core.session import DriftPredictor, Session
from repro_torch.core.matfree import MatrixFreePreparedSolver, prepare_matfree
from repro_torch.core.matfree_sharded import ShardedMatrixFreeSolver
from repro_torch.core.distributed import repartition, solve_sharded, solve_sharded_2d
from repro_torch.core.apc import solve_apc, setup_classical, classical_factors
from repro_torch.core.dapc import (
    solve_dapc,
    setup_decomposed,
    make_apply,
    qr_blocks,
    initial_from_factors,
)
from repro_torch.core.dgd import solve_dgd
from repro_torch.core.cg import solve_cgnr
from repro_torch.core.guard import SolveHealth, Watchdog
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
    "Session",
    "DriftPredictor",
    "PreparedSolver",
    "MatrixFreePreparedSolver",
    "ShardedMatrixFreeSolver",
    "solve_sharded",
    "solve_sharded_2d",
    "repartition",
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
    "solve_dgd",
    "solve_cgnr",
    "SolveHealth",
    "Watchdog",
    "run_consensus",
    "tune_hyperparams",
    "block_residual_sq",
]
