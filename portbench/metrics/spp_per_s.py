"""spp_per_s: frames accumulated over the window's seconds (one sample a
pixel a frame at the cell's resolution), camera moves and readbacks
included: the offline user's rate at a fixed estimator."""


def read(record):
    return record["frames"] / record["window_s"]
