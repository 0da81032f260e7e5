"""optix_renderer_tpu_torch — the path tracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``optix_renderer_tpu`` (JAX/Pallas), which stays beside it as the
reference.  The same subpackages and module names; plain functions on
tensors with an explicit ``device``.  The host-only modules (scene parsing,
OBJ loading and its native parser, procedural scenes, modes, LTC tables,
image IO, logging) are the port's own copies: it imports nothing of
``optix_renderer_tpu`` and never imports JAX.

On a CUDA tensor the ray/triangle traversal runs the kernels in ``csrc/``,
built by ``nvcc`` at first use into ``_build/``; on a CPU tensor it runs
their plain PyTorch versions.  Ported so far: the g-buffer modes, PATH,
LTC_BASELINE and RATIO with the denoiser, on the brute-force tier (at most
4096 triangles) and the cluster tier above it (ROADMAP.md lists what is
still to port).
"""

__version__ = "0.1.0"
