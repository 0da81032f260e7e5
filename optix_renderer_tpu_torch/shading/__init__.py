"""Shading: Frostbite GGX BSDF and material dispatch."""
