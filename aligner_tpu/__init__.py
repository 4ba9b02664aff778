"""aligner-tpu — a GPU pairwise sequence-alignment framework in JAX.

A from-scratch reimplementation of the capabilities of ikramanop/aligner
(global/local DP alignment, PWM alignment, heuristic matrix-free alignment,
Karlin-Altschul statistics, latent-repeat search and a distributed
alignment service), built for accelerators: a batched Pallas GPU DP
kernel with one problem per thread, JAX/XLA host orchestration, and
device-mesh scaling via shard_map collectives.
"""

from .alphabet import DNA, Index, Protein, index_coord, rotate_indices
from .errors import (
    AlignerError,
    CalculationError,
    CharIsNotMatchable,
    MatrixShapeError,
    MissingArgument,
    ResultIsEmpty,
    UnnecessaryArgument,
    ValidationError,
    WrongMatrixSpecified,
)
from .matrices import (
    blosum50,
    blosum62,
    get_threshold,
    random_pwm,
    transform_matrix,
)
from .result import Alignment, AlignmentResult, PWMAlignment
from . import align, heuristic, statistics  # noqa: E402
from . import native, observability, search  # noqa: E402
from .search import SearchHit, search_database
from .align import (
    PWMAligner,
    SimpleGlobalAligner,
    SimpleLocalAligner,
    align_global,
    align_local,
    align_pwm,
    batch_align,
    batch_align_pwm,
    global_end_score,
    local_max_score,
)
from .heuristic import (
    Heuristics,
    HeuristicAligner,
    HeuristicPWMAligner,
    heuristic_align,
    heuristic_align_population,
    heuristic_align_pwm,
)
from .statistics import DistributionParams, calculate_distribution_params, calculate_p_value

__version__ = "0.1.0"

__all__ = [
    "native",
    "observability",
    "search",
    "SearchHit",
    "search_database",
    "align",
    "heuristic",
    "statistics",
    "SimpleGlobalAligner",
    "SimpleLocalAligner",
    "PWMAligner",
    "align_global",
    "align_local",
    "align_pwm",
    "batch_align",
    "batch_align_pwm",
    "global_end_score",
    "local_max_score",
    "Heuristics",
    "HeuristicAligner",
    "HeuristicPWMAligner",
    "heuristic_align",
    "heuristic_align_population",
    "heuristic_align_pwm",
    "DistributionParams",
    "calculate_distribution_params",
    "calculate_p_value",
    "DNA",
    "Protein",
    "Index",
    "index_coord",
    "rotate_indices",
    "blosum50",
    "blosum62",
    "get_threshold",
    "random_pwm",
    "transform_matrix",
    "Alignment",
    "PWMAlignment",
    "AlignmentResult",
    "AlignerError",
    "CharIsNotMatchable",
    "UnnecessaryArgument",
    "MissingArgument",
    "ResultIsEmpty",
    "CalculationError",
    "ValidationError",
    "MatrixShapeError",
    "WrongMatrixSpecified",
]
