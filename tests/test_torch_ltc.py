"""The LTC shading layer: the port's polygon clip, LUT fetch and frames, and
the plain version of kernel B6, against the JAX package on the same numpy
inputs.

Tolerances:
- the clip: bit for bit on live slots and on the vertex count (the same
  f32 operations; the port's square root rounds to nearest, like XLA's);
- ``fetch_ltc_mat``, ``matrix_inverse_3x3``, ``spherical_theta`` and
  ``iso_frame_from_wo_local``: rtol 1e-6; ``integrate_edge_vec`` rtol 1e-6
  and atol 1e-6;
- ``ltc_integrate_plain`` (operands from ``fused_frames`` and
  ``pack_lights``) against the JAX pipeline and the Pallas kernel
  (interpret mode): the tolerance of ``tests/unit/test_ltc_pallas.py``
  (under 1 % of lanes above relative error 1e-3, 99th percentile below
  1e-3, max abs error below 5e-2), because a transformed vertex whose z
  lies within an ulp of 0 can fall into another clip case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.core import math as jcm
from optix_renderer_tpu.shading import ltc as jltc
from optix_renderer_tpu.shading import ltc_pallas as jpallas
from optix_renderer_tpu.shading import polygon_clip as jclip
from optix_renderer_tpu_torch.core import math as cm
from optix_renderer_tpu_torch.shading import ltc, ltc_kernel
from optix_renderer_tpu_torch.shading import polygon_clip as tclip
from tests.unit.test_ltc import random_polys
from tests.unit.test_ltc_pallas import _random_inputs

torch.set_num_threads(2)

RTOL = 1e-6


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_kernel_tolerance(got, want):
    """tests/unit/test_ltc_pallas.py:97-102."""
    assert np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-3)
    assert (rel > 1e-3).mean() < 0.01, f"too many divergent lanes: {(rel > 1e-3).mean()}"
    assert np.quantile(rel, 0.99) < 1e-3
    assert np.abs(got - want).max() < 5e-2


def test_case_tables_equal_jax():
    assert tclip._CASES == jclip._CASES
    for name in ("VC_TABLE", "OP_TABLE", "A_TABLE", "B_TABLE"):
        np.testing.assert_array_equal(getattr(tclip, name), getattr(jclip, name), err_msg=name)


@pytest.mark.parametrize("vcount,seed", [(3, 0), (3, 1), (4, 2), (4, 3)])
def test_clip_polygon_matches_jax_bit_for_bit(vcount, seed):
    """The oracle inputs of tests/unit/test_ltc.py:23-48."""
    polys = random_polys(512, vcount, seed)
    counts = np.full(512, vcount, np.int32)
    want_v, want_vc = (np.asarray(a) for a in jclip.clip_polygon(jnp.asarray(polys), jnp.asarray(counts)))
    got_v, got_vc = tclip.clip_polygon(_t(polys), _t(counts))
    assert got_vc.dtype == torch.int32
    np.testing.assert_array_equal(got_vc.numpy(), want_vc)
    live = np.arange(5)[None, :] < want_vc[:, None]
    assert live.sum() > 512, "the case must clip"
    np.testing.assert_array_equal(got_v.numpy()[live], want_v[live])
    # the iz0 helper of the (..., 3) layout
    np.testing.assert_array_equal(tclip.iz0(_t(polys[:, 0]), _t(polys[:, 1])).numpy(),
                                  np.asarray(jclip.iz0(jnp.asarray(polys[:, 0]), jnp.asarray(polys[:, 1]))))


def test_clip_core_matches_jax_static_select_clip():
    """The inputs of test_ltc_pallas.py::test_static_select_clip_matches_table_clip,
    against ltc_pallas._clip (the clip kernel B6 transcribes)."""
    rng = np.random.default_rng(1)
    n = 5000
    v = rng.normal(size=(3, 3, n)).astype(np.float32)
    cols = [[v[s, c] for s in (0, 1, 2, 0, 0)] for c in range(3)]
    for vals, cases in ((np.full(n, 3), jpallas._TRI_CASES), (rng.choice([0, 3, 4], size=n), jpallas._ALL_CASES)):
        vc_in = vals.astype(np.int32)
        kx, ky, kz, kvc = jpallas._clip(*([jnp.asarray(a) for a in c] for c in cols), jnp.asarray(vc_in), cases)
        rx, ry, rz, rvc = tclip.clip_polygon_c(*([_t(a) for a in c] for c in cols), _t(vc_in), tri_input=True)
        np.testing.assert_array_equal(rvc.numpy(), np.asarray(kvc))
        for s in range(5):
            live = s < np.asarray(kvc)
            for a, b in ((rx[s], kx[s]), (ry[s], ky[s]), (rz[s], kz[s])):
                np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])


def test_fetch_ltc_mat_and_inverse_match_jax():
    rng = np.random.default_rng(5)
    alpha = rng.uniform(0.0, 1.0, 4096).astype(np.float32)
    theta = (rng.uniform(0.0, 1.0, 4096) * np.pi / 2).astype(np.float32)
    alpha[:8] = [0.0, 1.0, -0.5, 1.5, 0.01, 0.999, 0.5, 0.0625]  # clamped and texel-center lanes
    want_m, want_a = jltc.fetch_ltc_mat(jnp.asarray(alpha), jnp.asarray(theta))
    got_m, got_a = ltc.fetch_ltc_mat(_t(alpha), _t(theta))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=RTOL, atol=1e-7)
    want_inv = np.asarray(jcm.matrix_inverse_3x3(want_m))
    np.testing.assert_allclose(cm.matrix_inverse_3x3(_t(np.asarray(want_m))).numpy(), want_inv, rtol=RTOL, atol=1e-6)


def test_spherical_theta_and_iso_frame_match_jax():
    rng = np.random.default_rng(6)
    wo = rng.normal(size=(2048, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    wo[:4] = [[0, 0, 1], [0, 0, -1], [1e-13, 0, 1], [0.6, 0.8, 0]]  # head-on, tiny xy and grazing lanes
    np.testing.assert_allclose(cm.spherical_theta(_t(wo)).numpy(), np.asarray(jcm.spherical_theta(jnp.asarray(wo))),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(ltc.iso_frame_from_wo_local(_t(wo)).numpy(),
                               np.asarray(jltc.iso_frame_from_wo_local(jnp.asarray(wo))), rtol=RTOL, atol=1e-7)


def test_integrate_edge_vec_matches_jax():
    rng = np.random.default_rng(7)
    v = rng.normal(size=(2, 4096, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    want = np.asarray(jltc.integrate_edge_vec(jnp.asarray(v[0]), jnp.asarray(v[1])))
    got = ltc.integrate_edge_vec(_t(v[0]), _t(v[1])).numpy()
    # jnp.cross rounds a cancelling component differently from the port's
    # written-out cross (up to ~6e-8 absolute), hence the atol
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    z = ltc._integrate_edge_z(*(_t(v[i][:, c]) for i in range(2) for c in range(3)))
    np.testing.assert_array_equal(z.numpy(), got[:, 2])


def _port_operands(inputs):
    """The operands of ltc_integrate_plain from the JAX test's setup outputs."""
    (p, diffuse, to_local, iso, ltc_mat_inv, amplitude, lv1, lv2, lv3, lnorm, lemit) = (_t(a) for a in inputs)
    mat_a, mat_b = ltc.fused_frames(iso, to_local, ltc_mat_inv)
    return p, diffuse, mat_a, mat_b, amplitude, ltc_kernel.pack_lights(lv1, lv2, lv3, lnorm, lemit)


@pytest.mark.parametrize("seed,L", [(0, 1), (1, 3), (2, 7)])
def test_plain_matches_jax_pipeline(seed, L):
    inputs = _random_inputs(seed, L=L)
    want = np.asarray(jltc.integrate_over_polygon(*(jnp.asarray(a) for a in inputs)))
    got = ltc_kernel.ltc_integrate_plain(*_port_operands(inputs))
    assert got.shape == want.shape and got.dtype == torch.float32
    _assert_kernel_tolerance(got.numpy(), want)


def test_plain_matches_pallas_kernel_interpret():
    inputs = _random_inputs(4, R=512, L=2)
    ops = _port_operands(inputs)
    want = np.asarray(jpallas.ltc_integrate_pallas(
        *(jnp.asarray(o.numpy()) for o in ops[:5]),
        jpallas.pack_lights(*(jnp.asarray(a) for a in inputs[6:])), interpret=True))
    np.testing.assert_array_equal(ops[5].numpy(), np.asarray(jpallas.pack_lights(*(jnp.asarray(a) for a in inputs[6:]))))
    _assert_kernel_tolerance(ltc_kernel.ltc_integrate_plain(*ops).numpy(), want)


def test_no_lights_or_rays_give_zeros():
    ops = _port_operands(_random_inputs(3, R=64, L=1))
    out = ltc_kernel.ltc_integrate_plain(*ops[:5], torch.zeros((0, 16)))
    assert out.shape == (64, 3) and float(out.abs().max()) == 0.0
    empty = [o[:0] for o in ops[:5]]
    assert ltc_kernel.ltc_integrate_plain(*empty, ops[5]).shape == (0, 3)


def test_cuda_wrapper_refuses_cpu_tensors_without_building(monkeypatch):
    from optix_renderer_tpu_torch.utils import cuda_build
    from optix_renderer_tpu_torch.utils.bench_rays import random_ltc_inputs

    def no_build(*_a, **_k):
        raise AssertionError("the wrapper must not build for a CPU tensor")

    monkeypatch.setattr(cuda_build, "build_library", no_build)
    monkeypatch.setattr(cuda_build, "load_library", no_build)
    args = random_ltc_inputs(64, 2, 3, "cpu")
    before = dict(ltc_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ltc_kernel.ltc_direct_cuda(*args)
    with pytest.raises(ValueError, match=r"\(L, 16\)"):
        ltc_kernel.ltc_direct_cuda(*args[:5], args[5][:, :12])
    with pytest.raises(ValueError, match="n_geom"):
        ltc_kernel.ltc_direct_cuda(args[0], args[1], args[2][:5], *args[3:])
    assert ltc_kernel.LAUNCHES == before
    ltc_kernel.reset_launch_counts()
    assert ltc_kernel.LAUNCHES == {"ltc": 0}
