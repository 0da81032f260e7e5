"""Small shapes for the benchmark's CPU tests."""

TINY_CORNELL = {"config": {"width": 16, "height": 16},
                "traffic": {"frames_per_request": 4, "frames_per_call": 2},
                "check": {"pixels": 96, "requests": 2}}
TINY = {"cornell.path_progressive": TINY_CORNELL}  # every cell of BENCHMARK.json
