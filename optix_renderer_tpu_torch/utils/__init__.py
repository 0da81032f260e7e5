"""Utilities: building the CUDA sources."""
