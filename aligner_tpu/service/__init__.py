"""Distributed alignment service.

Batched rebuild of aligner-web: the dispatcher HTTP API
(``/health/check``, ``/validate``, ``/progress``) is preserved, while
Kafka is replaced by a lease-based sqlite work queue and MariaDB by a
sqlite results store.  Workers claim whole batches of candidate-matrix
jobs and run them as one batched device launch per heuristic iteration
(heuristic_align_population) instead of one process per message.

Task-hash idempotency (models.rs:101-118), at-least-once delivery with
redelivery on lease expiry (Kafka auto-commit semantics), best-subtask
promotion and subtask cleanup (queries.rs:74-91, updater.rs:12-29) are
all kept — with the reference's best-subtask ``ORDER BY f_value ASC``
bug fixed to an actual max.
"""

from .models import AlignJob, AlignJobRequest, task_hash
from .queue import JobQueue
from .store import Store, get_population

__all__ = [
    "AlignJob",
    "AlignJobRequest",
    "task_hash",
    "JobQueue",
    "Store",
    "get_population",
]
