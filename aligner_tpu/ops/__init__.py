"""Device compute kernels: the batched DP-fill engines.

``scan_engine`` is the XLA (``lax.scan``) implementation; ``pallas_dp`` is
the GPU Pallas kernel (Triton route).  Both implement the exact reference semantics
(SURVEY.md §2.3) with the batch dimension as the parallel axis.
"""

from .scan_engine import FillResult, fill_batch, fill_pwm_batch

__all__ = ["FillResult", "fill_batch", "fill_pwm_batch"]
