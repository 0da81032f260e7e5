"""device_idle (.spp): the share of the traced window in which no
operation ran on the card, in percent: 1 - the union of the device
operations' intervals over the window's wall time."""


def read(record):
    t = record["trace"]
    if not t["ops"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
