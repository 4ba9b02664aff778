"""Latent-repeat search: windowed PWM scans with iterative matrix refinement.

Batched rebuild of aligner-core/src/bin/latent-repeat-search: the
window scan becomes batched scores-only kernel launches (all windows in
one launch per chunk), with full alignments computed only for the z-
filtered survivors.
"""

from .engine import (
    Task,
    TaskResult,
    calculate_cycle,
    calculate_starting_values,
    filter_tasks,
    generate_descendants,
    mutate,
    perform_calculation_per_sequence,
    run_csv_cmd,
    run_exploring_cmd,
    run_testing_cmd,
    windows_of,
)

__all__ = [
    "Task",
    "TaskResult",
    "windows_of",
    "calculate_starting_values",
    "calculate_cycle",
    "filter_tasks",
    "generate_descendants",
    "mutate",
    "perform_calculation_per_sequence",
    "run_testing_cmd",
    "run_exploring_cmd",
    "run_csv_cmd",
]
