"""Multi-chip scaling: device meshes, sharded batch alignment, collectives.

The reference's distribution story is thread fan-outs + a Kafka work queue
+ MariaDB aggregation (SURVEY.md §2.2).  The device-mesh equivalent here:

* the *problem batch* (shuffled alignments, chromosome windows, sequence
  pairs) shards over the mesh ``data`` axis;
* the *candidate-matrix population* (aligner-web's one-Kafka-message-per-
  matrix) shards over the mesh ``matrix`` axis;
* merging is done with XLA collectives between devices — ``psum`` for window
  statistics (mean/variance), ``pmax``/argmax for best-matrix promotion —
  instead of SQL aggregation.
"""

from .mesh import (
    make_mesh,
    matrix_population_step,
    sharded_scores,
    window_scan_step,
)
from .wavefront_sp import sharded_global_align, sharded_global_end_score

__all__ = [
    "make_mesh",
    "sharded_scores",
    "window_scan_step",
    "matrix_population_step",
    "sharded_global_align",
    "sharded_global_end_score",
]
