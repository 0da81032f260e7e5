"""Acceleration: brute-force tier table build, trace kernels B1/B2 and the dispatcher."""
