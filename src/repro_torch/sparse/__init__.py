from repro_torch.sparse.matrix import (
    COOMatrix,
    PlanMixer,
    RowMixer,
    block_rows,
    make_plan_mixer,
    make_row_mixer,
    matrix_stats,
)
from repro_torch.sparse.io import (
    generate_schenk_like,
    augment_system,
    load_matrix_market,
    save_matrix_market,
    make_problem,
)

__all__ = [
    "COOMatrix",
    "PlanMixer",
    "RowMixer",
    "block_rows",
    "make_plan_mixer",
    "make_row_mixer",
    "matrix_stats",
    "generate_schenk_like",
    "augment_system",
    "load_matrix_market",
    "save_matrix_market",
    "make_problem",
]
