"""trace_roofline (.spp): the trace layer's share of its roofline,
in percent: the bytes at the layer's boundary (``roofline.bytes.
trace_bytes``) over the HBM peak, divided by the trace kernels' summed
device time in the traced window.  None where no trace kernel ran."""

from portbench.roofline.bytes import trace_bytes
from portbench.roofline.kernels import TRACE, TRACE_QUERIES, matches
from portbench.roofline.peaks import HBM_BYTES_PER_S


def read(record):
    t = record["trace"]
    sec = sum(s for name, s in t["ops"] if matches(name, TRACE))
    launches = sum(1 for name, _s in t["ops"] if matches(name, TRACE_QUERIES))
    if sec <= 0 or t["rays"] <= 0:
        return None
    return 100.0 * trace_bytes(t["rays"], launches, record["triangles"]) / HBM_BYTES_PER_S / sec
