"""bounce_roofline (.spp): the bounce layer's (K1, K2, K3) share of its
roofline, in percent: the bytes at the layer's boundary (``roofline.bytes.
bounce_bytes``) over the HBM peak, divided by the kernels' summed device
time in the traced window.  None where none of them ran."""

from portbench.roofline.bytes import bounce_bytes
from portbench.roofline.kernels import BOUNCE, matches
from portbench.roofline.peaks import HBM_BYTES_PER_S


def read(record):
    t = record["trace"]
    sec = sum(s for name, s in t["ops"] if matches(name, BOUNCE))
    moved = bounce_bytes(t["frames"], t["alive_per_bounce"])
    if sec <= 0 or moved <= 0:
        return None
    return 100.0 * moved / HBM_BYTES_PER_S / sec
