"""Kernel B6 from the hit: ``ltc_kernel.ltc_direct_plain`` (the plain
version of the fused kernel), the routing of ``integrators.ltc_direct``,
the wrapper's refusals, the kernel's clip table, the light table packed
once a scene, the operation count of the kernel's bound
(``ltc_direct_ops``, exact), the bench tool's variants, and the frame as a
pure function of its state, against the JAX package on the same numpy
inputs.

Tolerances:
- ``ltc_direct_plain`` against the JAX composition (the JAX
  ``integrators.ltc_direct.ltc_direct``: shading frame, LUT fetch,
  inverse, iso frame, ``integrate_over_polygon``, ``where(upper)``): rtol
  1e-4, atol 1e-5, as tests/test_torch_ratio.py::test_ltc_direct_matches_jax,
  on all but at most 0.1 % of the rays, which stay within the max abs error
  5e-2 of tests/unit/test_ltc_pallas.py: on random hits a clip vertex
  within an ulp of the horizon can take another case, and at alpha 0.01 the
  LTC matrix is nearly singular, so its inverse magnifies a last-bit
  difference of XLA's CPU rounding (1 ray of each kind in these 6,144);
- against the port's own composition of the same functions in the order
  the port ran them before the kernel took the setup: bit for bit;
- the frame: what one frame adds to equal states' accumulators, relative
  RMSE 1e-4 for LTC_BASELINE and 5e-3 for PATH, the tolerances of
  tests/test_torch_render.py; the input states bit for bit unchanged.
"""

import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine import renderer as jrenderer
from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.integrators import ltc_direct as jltc_direct
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene
from optix_renderer_tpu_torch.core import math as cm
from optix_renderer_tpu_torch.core.types import RenderState
from optix_renderer_tpu_torch.engine import renderer as trenderer
from optix_renderer_tpu_torch.integrators import ltc_direct as tltc_direct
from optix_renderer_tpu_torch.shading import ltc, ltc_kernel
from optix_renderer_tpu_torch.shading import polygon_clip as tclip
from optix_renderer_tpu_torch.utils.bench_rays import LTC_EDGE_CASES, random_ltc_hits, random_ltc_inputs

torch.set_num_threads(2)

RAYS = 2048
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIT_KEYS = ("origin", "p", "n_geom", "alpha", "diffuse")


def _jax_ltc_direct(h):
    """The JAX integrator on the hits and lights of random_ltc_hits."""
    ds = SimpleNamespace(light_v1=h["v1"], light_v2=h["v2"], light_v3=h["v3"], light_normal=h["normal"],
                         light_emit=h["emit"])
    ds = SimpleNamespace(**{k: jnp.asarray(v) for k, v in vars(ds).items()})
    rays = SimpleNamespace(origin=jnp.asarray(h["origin"]))
    si = SimpleNamespace(**{k: jnp.asarray(h[k]) for k in ("p", "n_geom", "alpha", "diffuse")})
    return np.asarray(jltc_direct.ltc_direct(ds, rays, si))


@pytest.mark.parametrize("n_lights,seed", [(1, 11), (3, 12), (7, 13)])
def test_plain_matches_jax_composition(n_lights, seed):
    h = random_ltc_hits(RAYS, n_lights, seed)
    args = random_ltc_inputs(RAYS, n_lights, seed, "cpu")
    want = _jax_ltc_direct(h)
    got = ltc_kernel.ltc_direct_plain(*args)
    assert got.shape == (RAYS, 3) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    outside = ~np.isclose(got.numpy(), want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert outside.mean() <= 1e-3, f"{outside.sum()} of {RAYS} rays outside rtol 1e-4 / atol 1e-5"
    assert np.abs(got.numpy() - want).max() < 5e-2
    # every edge lane is there, and the lit and black ones both occur
    case = np.arange(RAYS) % 16
    assert set(LTC_EDGE_CASES) <= set(case.tolist())
    lit = np.abs(want).sum(-1) > 0
    assert not lit[case == 11].any(), "a hit whose ray origin is below its horizon is black"
    assert lit[case == 0].any() and lit[case == 14].any() and lit[case == 10].any()


def _parent_composition(origin, p, n_geom, alpha, diffuse, lights):
    """shading_frame -> ltc_inputs -> kernel_operands -> ltc_integrate_plain
    -> where(upper), as the port composed them before B6 took the setup."""
    wo = cm.normalize(origin - p, eps=1e-30)
    to_local, _ = cm.orthonormal_basis(n_geom)
    wo_local = cm.normalize(cm.apply_mat(to_local, wo), eps=1e-30)
    upper = wo_local[..., 2] >= 0.0
    ltc_mat, amplitude = ltc.fetch_ltc_mat(alpha, cm.spherical_theta(wo_local))
    ltc_mat_inv = cm.matrix_inverse_3x3(ltc_mat)
    iso = ltc.iso_frame_from_wo_local(wo_local)
    R = p.shape[0]
    mat_a = ltc._matmul33(iso, to_local)
    mat_b = ltc._matmul33(ltc_mat_inv, mat_a)
    color = ltc_kernel.ltc_integrate_plain(p.contiguous(), diffuse.contiguous(), mat_a.reshape(R, 9),
                                           mat_b.reshape(R, 9), amplitude.contiguous(), lights)
    return torch.where(upper[:, None], color, 0.0)


@pytest.mark.parametrize("n_lights,seed", [(1, 21), (3, 22), (7, 23)])
def test_plain_bit_equal_to_port_composition(n_lights, seed):
    args = random_ltc_inputs(RAYS, n_lights, seed, "cpu")
    got = ltc_kernel.ltc_direct_plain(*args)
    np.testing.assert_array_equal(got.numpy(), _parent_composition(*args).numpy())


def test_integrator_routes_cpu_hits_to_the_plain_version():
    h = random_ltc_hits(256, 3, 31)
    args = random_ltc_inputs(256, 3, 31, "cpu")
    ds = SimpleNamespace(**{f"light_{k}": torch.as_tensor(h[k]) for k in ("v1", "v2", "v3", "normal", "emit")})
    rays = SimpleNamespace(origin=args[0])
    si = SimpleNamespace(p=args[1], n_geom=args[2], alpha=args[3], diffuse=args[4])
    before = dict(ltc_kernel.LAUNCHES)
    got = tltc_direct.ltc_direct(ds, rays, si)
    np.testing.assert_array_equal(got.numpy(), ltc_kernel.ltc_direct_plain(*args).numpy())
    assert ltc_kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="no LTC implementation"):
        tltc_direct.ltc_direct(ds, rays, SimpleNamespace(**{**vars(si), "p": args[1].to("meta")}))
    # the light table the integrator passes is pack_lights of the scene's lights
    np.testing.assert_array_equal(args[5].numpy(), ltc_kernel.pack_lights(
        *(torch.as_tensor(h[k]) for k in ("v1", "v2", "v3", "normal", "emit"))).numpy())


def test_light_table_is_packed_once_per_scene():
    h = random_ltc_hits(8, 3, 34)
    src = [torch.as_tensor(h[k]).clone() for k in ("v1", "v2", "v3", "normal", "emit")]
    table = ltc_kernel.light_table(*src)
    np.testing.assert_array_equal(table.numpy(), ltc_kernel.pack_lights(*src).numpy())
    assert ltc_kernel.light_table(*src) is table, "the same, unchanged tensors are not packed again"
    src[4].mul_(2.0)  # an emission changed in place
    again = ltc_kernel.light_table(*src)
    assert again is not table
    np.testing.assert_array_equal(again.numpy(), ltc_kernel.pack_lights(*src).numpy())
    other = [t.clone() for t in src]  # another scene's tensors with equal values
    assert ltc_kernel.light_table(*other) is not again


def _one_hit(origin, p=(0.0, 0.0, 0.0), n=(0.0, 1.0, 0.0), alpha=0.5):
    f = lambda v: torch.tensor([v], dtype=torch.float32)  # noqa: E731
    return f(origin), f(p), f(n), torch.tensor([alpha], dtype=torch.float32), f((0.5, 0.5, 0.5))


def _light(v1, v2, v3):
    v = [torch.tensor([c], dtype=torch.float32) for c in (v1, v2, v3)]
    nrm = torch.linalg.cross(v[1] - v[0], v[2] - v[0])
    nrm = nrm / nrm.norm()
    return ltc_kernel.pack_lights(*v, nrm, torch.ones(1, 3))


# a small triangle straight above a hit whose normal is +y, facing down at it, and the same one facing up
_OVERHEAD = _light((-0.1, 2.0, -0.1), (0.1, 2.0, -0.1), (0.0, 2.0, 0.1))
_AWAY = _light((-0.1, 2.0, -0.1), (0.0, 2.0, 0.1), (0.1, 2.0, -0.1))
# a triangle across the hit's horizon (its third corner below), facing the hit
_ACROSS = _light((-1.0, 1.0, -1.0), (1.0, 1.0, -1.0), (0.0, -0.5, 1.0))
K = ltc_kernel


@pytest.mark.parametrize("case,origin,lights,want", [
    ("below the horizon: the frame only", (0.0, -1.0, 0.5), _OVERHEAD, K.OPS_FRAME),
    ("a light facing away: the frame and the back-face test", (0.0, 1.0, 0.5), _AWAY,
     K.OPS_FRAME + K.OPS_FACING),
    ("a light overhead, no edge crosses the horizon: both clips keep the triangle", (0.0, 1.0, 0.0), _OVERHEAD,
     K.OPS_FRAME + K.OPS_DIFFUSE_FRAME + K.OPS_LTC_FRAME + K.OPS_FACING + 2 * K.OPS_CORNERS + K.OPS_SUM
     + 6 * K.OPS_EDGE),
    # viewed head-on the LTC frame keeps the corners' sides of the horizon: in each clip two edges cross it;
    # the first clip makes a quad, and the second clips the triangle as [s0 s1 s2 s0] into a pentagon
    ("a light across the horizon: 2 intersections in each clip, 4 + 5 edges", (0.0, 1.0, 0.0), _ACROSS,
     K.OPS_FRAME + K.OPS_DIFFUSE_FRAME + K.OPS_LTC_FRAME + K.OPS_FACING + 2 * K.OPS_CORNERS + K.OPS_SUM
     + 4 * K.OPS_IZ0 + 9 * K.OPS_EDGE),
    ("no lights: the frame only", (0.0, 1.0, 0.0), _OVERHEAD[:0], K.OPS_FRAME),
])
def test_ltc_direct_ops_counts_what_one_hit_needs(case, origin, lights, want):
    hit = _one_hit(origin)
    assert ltc_kernel.ltc_direct_ops(*hit, lights) == want, case
    if lights.shape[0]:  # the count's premise: lit exactly where a light faces an upper hit
        assert (float(ltc_kernel.ltc_direct_plain(*hit, lights).abs().sum()) > 0) == (want > K.OPS_FRAME + K.OPS_FACING)


def test_ltc_direct_ops_on_random_hits():
    """Between the frame of every ray and the most a ray and a light can
    need (every clip at its largest count, two edges crossing a clip); a
    light that faces no hit adds exactly its back-face test to every upper
    ray; no rays count nothing."""
    n, n_lights = 1024, 7
    args = random_ltc_inputs(n, n_lights, 35, "cpu")
    ops = ltc_kernel.ltc_direct_ops(*args)
    most_per_pair = K.OPS_FACING + 2 * K.OPS_CORNERS + K.OPS_SUM + 4 * K.OPS_IZ0 + (4 + 5) * K.OPS_EDGE
    assert n * K.OPS_FRAME < ops < n * (K.OPS_FRAME + K.OPS_DIFFUSE_FRAME + K.OPS_LTC_FRAME
                                        + n_lights * most_per_pair)
    far = torch.tensor([[-1.0, 100.0, -1.0, 1.0, 100.0, -1.0, 0.0, 100.0, 1.0, 0.0, 1.0, 0.0, 1.0, 1.0, 1.0, 0.0]])
    with_far = torch.cat([args[5], far])
    _, wo_local = ltc.shading_frame(*args[:3])
    n_upper = int((wo_local[:, 2] >= 0.0).sum())
    assert 0 < n_upper < n
    np.testing.assert_array_equal(ltc_kernel.ltc_direct_plain(*args[:5], with_far).numpy(),
                                  ltc_kernel.ltc_direct_plain(*args).numpy())
    assert ltc_kernel.ltc_direct_ops(*args[:5], with_far) == ops + K.OPS_FACING * n_upper
    assert ltc_kernel.ltc_direct_ops(*(a[:0] for a in args[:5]), args[5]) == 0


def test_cuda_wrapper_refuses_dtypes_and_layouts_without_building(monkeypatch):
    from optix_renderer_tpu_torch.utils import cuda_build

    def no_build(*_a, **_k):
        raise AssertionError("the wrapper must not build for inputs it refuses")

    monkeypatch.setattr(cuda_build, "build_library", no_build)
    monkeypatch.setattr(cuda_build, "load_library", no_build)
    args = random_ltc_inputs(64, 2, 32, "cpu")
    before = dict(ltc_kernel.LAUNCHES)
    for k, name in enumerate(("origin", "p", "n_geom", "alpha", "diffuse", "lights")):
        bad = list(args)
        bad[k] = bad[k].double()
        with pytest.raises(ValueError, match=f"{name} must be float32"):
            ltc_kernel.ltc_direct_cuda(*bad)
    with pytest.raises(ValueError, match=r"alpha must be \(64,\)"):
        ltc_kernel.ltc_direct_cuda(*args[:3], args[3][:, None], *args[4:])
    with pytest.raises(ValueError, match=r"p must be \(R, 3\)"):
        ltc_kernel.ltc_direct_cuda(args[0], args[1].reshape(-1), *args[2:])
    with pytest.raises(ValueError, match="origin must be"):
        ltc_kernel.ltc_direct_cuda(args[0][:, :2], *args[1:])
    assert ltc_kernel.LAUNCHES == before


@pytest.mark.parametrize("rays,n_lights", [(0, 2), (64, 0), (0, 0)])
def test_no_rays_or_lights_give_zeros(rays, n_lights):
    args = random_ltc_inputs(max(rays, 1), max(n_lights, 1), 33, "cpu")
    args = tuple(a[:rays] for a in args[:5]) + (args[5][:n_lights],)
    out = ltc_kernel.ltc_direct_plain(*args)
    assert out.shape == (rays, 3) and out.dtype == torch.float32
    assert float(out.abs().sum()) == 0.0


def test_kernel_case_table_matches_clip_cases():
    """csrc/ltc.cu's clip table: for slots [s0 s1 s2 s0 s0] (slot 3 and 4
    are slot 0), each reachable case of polygon_clip._CASES by vertex count
    (3 or 4) and the corners' bits, its vertex count and the source of every
    slot below it."""
    with open(os.path.join(REPO, "optix_renderer_tpu_torch", "csrc", "ltc.cu")) as f:
        src = f.read()
    vc_table = [int(v) for v in re.search(r"kCaseVc\[16\] = \{([^}]*)\}", src).group(1).split(",")]
    slot_rows = re.search(r"kCaseSlot\[4\]\[16\] = \{(.*?)\};", src, re.S).group(1)
    slot_table = [[int(v) for v in row.split(",")] for row in re.findall(r"\{([^}]*)\}", slot_rows)]
    candidates = (("s0", "z01", "z20"), ("s1", "z01", "z12"), ("s2", "z20", "z12"), ("s0", "z20", "s2"))

    def source(op, a, b):
        a, b = (0 if k in (3, 4) else k for k in (a, b))  # slot 3 and 4 hold slot 0
        return f"s{a}" if op == tclip._COPY else f"z{a}{b}"

    checked = 0
    for idx in range(16):
        vcount, bits = (3 if idx < 8 else 4), [(idx >> k) & 1 for k in range(3)]
        mask = vcount + 8 * bits[0] + 16 * bits[1] + 32 * bits[2] + (64 * bits[0] if vcount == 4 else 0)
        vc, slots = tclip._CASES[mask]
        assert vc_table[idx] == vc, f"case {mask}"
        for j in range(vc):
            want = source(*slots[j])
            got = candidates[j][slot_table[j][idx]] if j < 4 else "s0"
            assert got == want, f"case {mask} slot {j}: {got} != {want}"
            checked += 1
    assert checked == 52


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    return parse_scene(procedural.write_cornell_scene(str(tmp_path_factory.mktemp("pure_frame"))))


@pytest.mark.parametrize("mode,tol", [(RendererType.LTC_BASELINE, 1e-4), (RendererType.PATH, 5e-3)])
def test_frame_is_a_pure_function_of_the_state(small_scene, mode, tol):
    """One frame through each package's _frame_impl from equal states (an
    accumulator of 3 earlier frames): both input states stay as they were
    and the new accumulators agree."""
    res, depth = 24, 4
    j = jrenderer.Renderer(small_scene, width=res, height=res, mode=mode, path_depth=depth)
    t = trenderer.Renderer(small_scene, width=res, height=res, mode=mode, path_depth=depth, device="cpu")
    start = np.random.default_rng(5).uniform(0.0, 3.0, size=(res, res, 3)).astype(np.float32)
    jstate = jrenderer.RenderState(accum=jnp.asarray(start), accum_id=3, camera=j.state.camera)
    tstate = RenderState(accum=torch.as_tensor(start.copy()), accum_id=3, camera=t.state.camera)
    kw = dict(mode=mode, width=res, height=res, path_depth=depth, ratio_samples=4)
    jnew, _, _ = jrenderer._frame_impl(jstate, j.device_scene, j.bvh, **kw)
    tnew, _, _ = trenderer._frame_impl(tstate, t.device_scene, t.bvh, **kw)
    np.testing.assert_array_equal(np.asarray(jstate.accum), start)
    np.testing.assert_array_equal(tstate.accum.numpy(), start)
    assert tnew.accum is not tstate.accum and tstate.accum_id == 3 and tnew.accum_id == 4 == int(jnew.accum_id)
    got, want = tnew.accum.numpy() - start, np.asarray(jnew.accum) - start
    assert float(np.abs(want).mean()) > 1e-3, "the frame must add light"
    rmse = float(np.sqrt(((got - want) ** 2).mean())) / float(np.abs(want).mean())
    assert rmse < tol, f"relative RMSE {rmse:.3g} (tests/goldens/test_goldens.py::_check's measure)"


def test_bench_builds_variants_of_the_kernel_source(tmp_path):
    """utils.brute_bench --kernel ltc: ``shipped`` is csrc/ltc.cu, any other
    source a file of the working directory, with the package's flags plus
    the variant's own; without a card the tool refuses to run."""
    from optix_renderer_tpu_torch.utils import brute_bench, cuda_build

    label, path, flags, _ = brute_bench.parse_variant("shipped=shipped", "ltc.cu")
    assert (label, path, flags) == ("shipped", os.path.join(cuda_build.CSRC_DIR, "ltc.cu"), cuda_build.NVCC_FLAGS)
    copy = tmp_path / "ltc_copy.cu"
    label, path, flags, _ = brute_bench.parse_variant(f"copy={copy},-DX=1,+fma", "ltc.cu")
    assert (label, path) == ("copy", str(copy))
    assert flags == tuple(f for f in cuda_build.NVCC_FLAGS if f != "--fmad=false") + ("-DX=1",)
    if not torch.cuda.is_available():
        assert brute_bench.main(["--kernel", "ltc", "--out", str(tmp_path / "out")]) == 1
