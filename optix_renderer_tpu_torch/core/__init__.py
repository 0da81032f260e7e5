"""Core device math, RNG, and SoA tensor types."""
