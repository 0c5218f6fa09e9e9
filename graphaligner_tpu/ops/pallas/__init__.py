"""Pallas GPU kernels (Triton route) for the alignment hot loops."""
