"""torch_glue_ms_per_frame (.spp): device milliseconds a frame of
the kernels that are not the renderer's hand-written ones (PyTorch's:
camera and RNG, the cluster sweep and sort, the fused shading, the
integrators' glue, accumulation, the image's division)."""

from portbench.roofline.kernels import HAND, is_kernel, matches


def read(record):
    t = record["trace"]
    s = sum(sec for name, sec in t["ops"] if is_kernel(name) and not matches(name, HAND))
    return 1e3 * s / t["frames"] if s and t["frames"] else None
