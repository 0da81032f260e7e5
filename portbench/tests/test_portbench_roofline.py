"""The yardstick's arithmetic on small shapes, and the readers on a
synthetic traced record."""

import pytest

from portbench.harness.manifest import metric_reader
from portbench.roofline import bytes as rb
from portbench.roofline import kernels
from portbench.roofline.peaks import HBM_BYTES_PER_S

B1 = "void (anonymous namespace)::closest_kernel<false>(float const*, int, float const*, float const*,"
B3 = "void (anonymous namespace)::closest_walk_kernel<false, (anonymous namespace)::BakedTri>((anonymo"
K1 = "(anonymous namespace)::path_sample_kernel(int, float const*, float const*, float const*, float c"
GLUE = "void at::native::vectorized_elementwise_kernel<4, at::native::BinaryFunctor<float, float, float,"


def test_byte_counts():
    assert rb.trace_bytes(10, 2, 5) == 10 * (28 + 4) + 2 * 5 * 36
    assert rb.bounce_bytes(2, [3, 1]) == 2 * 4 * (69 + 13 + 69 + 12)
    assert rb.bounce_bytes(3, []) == 0


def test_kernel_names_match_whole_identifiers():
    assert kernels.matches(B1, ("closest_kernel",)) and not kernels.matches(B3, ("closest_kernel",))
    assert kernels.matches(B3, ("closest_walk_kernel",))
    assert kernels.matches(K1, kernels.BOUNCE) and not kernels.matches(K1, kernels.TRACE)
    assert not kernels.matches(GLUE, kernels.HAND)
    assert not kernels.is_kernel("Memcpy DtoH (Device -> Pageable)") and kernels.is_kernel(GLUE)


def _record(ops, frames=2, rays=1000, alive=(100, 50)):
    return {"triangles": 10, "lights": 2, "width": 4, "height": 4, "trace": {"ops": ops, "frames": frames, "rays": rays, "alive_per_bounce": list(alive),
                                      "busy_s": 0.75, "window_s": 1.0}}


def test_readers_on_a_synthetic_trace():
    ops = [(B1, 1e-6), (B1, 1e-6), (K1, 2e-6), (GLUE, 3e-3), ("Memcpy DtoH (Device -> Pageable)", 1e-3)]
    rec = _record(ops)
    assert metric_reader("device_idle.spp").read(rec) == pytest.approx(25.0)
    assert metric_reader("kernels_per_frame.spp").read(rec) == pytest.approx(2.0)
    assert metric_reader("torch_glue_ms_per_frame.spp").read(rec) == pytest.approx(1.5)
    trace = rb.trace_bytes(1000, 2, 10) / HBM_BYTES_PER_S / 2e-6 * 100
    assert metric_reader("trace_roofline.spp").read(rec) == pytest.approx(trace)
    bounce = rb.bounce_bytes(2, [100, 50]) / HBM_BYTES_PER_S / 2e-6 * 100
    assert metric_reader("bounce_roofline.spp").read(rec) == pytest.approx(bounce)


def test_readers_find_nothing_where_nothing_ran():
    rec = _record([(GLUE, 1e-3)])
    assert metric_reader("trace_roofline.spp").read(rec) is None
    assert metric_reader("bounce_roofline.spp").read(rec) is None
    assert metric_reader("device_idle.spp").read(_record([])) is None


def test_end_to_end_readers():
    rec = {"setup_s": 12.5, "frames": 300, "window_s": 10.0, "latencies_ms": list(range(1, 101)),
           "peak_bytes": 2 ** 31}
    assert metric_reader("setup_s").read(rec) == 12.5
    assert metric_reader("spp_per_s").read(rec) == 30.0
    assert metric_reader("peak_device_gib").read(rec) == 2.0
    assert metric_reader("peak_device_gib").read({**rec, "peak_bytes": 0}) is None
