"""setup_s: seconds from process start to the window's start: imports,
scene parse, trace tables, kernel builds or loads, the cell's warm-up."""


def read(record):
    return record["setup_s"]
