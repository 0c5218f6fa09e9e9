"""Compute kernels (reference L2 inner loops, batched redesigns) and the
per-platform kernel choice (ops.kernels)."""
