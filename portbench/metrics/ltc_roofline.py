"""ltc_roofline (.spp): the LTC kernel's (B6) share of its roofline, in
percent: the bytes every implementation must move at its boundary in the
traced frames (``roofline.ltc.ltc_bytes``) over the HBM peak, divided by
B6's summed device time in the traced window.  None where B6 did not
run."""

from portbench.roofline.kernels import LTC, matches
from portbench.roofline.ltc import ltc_bytes
from portbench.roofline.peaks import HBM_BYTES_PER_S


def read(record):
    t = record["trace"]
    sec = sum(s for name, s in t["ops"] if matches(name, LTC))
    if sec <= 0 or not t["frames"]:
        return None
    moved = ltc_bytes(t["frames"], record["width"], record["height"], record["lights"])
    return 100.0 * moved / HBM_BYTES_PER_S / sec
