"""The benchmark of optix_renderer_tpu_torch: ``python3 portbench/run.py``."""
