"""Integrators: g-buffer visualizations and the MIS path tracer."""
