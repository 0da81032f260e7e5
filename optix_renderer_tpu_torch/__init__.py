"""optix_renderer_tpu_torch — the path tracer in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``optix_renderer_tpu`` (JAX/Pallas), which stays beside it as the
reference.  The same subpackages and module names; plain functions on
tensors with an explicit ``device``; host-only modules (scene parsing, OBJ
loading, modes, image IO, logging) are imported from ``optix_renderer_tpu``,
which does not import JAX for them.  The port itself never imports JAX.

On a CUDA tensor the ray/triangle traversal runs the kernels in ``csrc/``,
built by ``nvcc`` at first use into ``_build/``; on a CPU tensor it runs
their plain PyTorch versions.  Ported so far: PATH and the g-buffer modes
on scenes of at most 4096 triangles (ROADMAP.md lists what is still to
port).
"""

__version__ = "0.1.0"
