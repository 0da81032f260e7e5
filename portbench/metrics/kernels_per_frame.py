"""kernels_per_frame (.spp): kernels launched on the card in the
traced window over its frames (graph replays, ``set_camera``'s zeroing and
rebake, the readback's kernels included; copies and fills excluded)."""

from portbench.roofline.kernels import is_kernel


def read(record):
    t = record["trace"]
    n = sum(1 for name, _s in t["ops"] if is_kernel(name))
    return n / t["frames"] if n and t["frames"] else None
