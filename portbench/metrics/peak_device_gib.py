"""peak_device_gib: ``torch.cuda.max_memory_allocated()`` over set-up and
window (frame graph pools included), in GiB; none off the card."""


def read(record):
    return record["peak_bytes"] / 2 ** 30 if record["peak_bytes"] else None
