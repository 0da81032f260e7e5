"""The path bounce's plain versions (kernels K1 and K2) against the JAX
``path_color``, and their routing.

A PATH estimate is built here from the pieces the card runs as kernels:
``path_kernel.path_sample_plain`` (K1), the port's shadow and bounce traces
on K1's rays, then ``path_combine_plain`` (K2), once a bounce.  The same
primary rays, SurfaceInteraction, RNG state, DeviceScene and BVH go into it
and into the JAX ``integrators/path.py::path_color``, at depths 1 and 4 on
the Cornell box, the three-light Cornell and the textured Cornell of
``tests/test_torch_textures.py``.  Tolerances as ``tests/test_torch_path.py``:
relative RMSE 5e-3 on the image (a last-bit difference can flip a lobe or a
hemisphere test and change a whole path), the RNG state bit-exact; the
per-bounce alive/shadow/bounce counts here must be equal.  The port's
``path_color`` must equal the composition bit for bit and leave the primary
hit's tensors as they were.

On CPU tensors ``path_color`` runs the plain versions once a bounce; the
``*_cuda`` wrappers refuse CPU tensors before they build or launch
anything.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel.build import build_bvh as jbuild_bvh
from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.engine import camera as jcamera
from optix_renderer_tpu.engine.shade import trace_closest_si as jtrace_closest_si
from optix_renderer_tpu.integrators import path as jpath
from optix_renderer_tpu.scene import device as jdevice
from optix_renderer_tpu_torch.accel.build import bvh_from_numpy
from optix_renderer_tpu_torch.accel.traverse import trace_any
from optix_renderer_tpu_torch.core import math as cm
from optix_renderer_tpu_torch.core.types import Ray, SurfaceInteraction
from optix_renderer_tpu_torch.engine.shade import trace_closest_si
from optix_renderer_tpu_torch.integrators import path as tpath
from optix_renderer_tpu_torch.integrators import path_kernel as pk
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell3_scene, write_cornell_scene
from optix_renderer_tpu_torch.scene.device import device_scene_from_numpy
from optix_renderer_tpu_torch.shading.bsdf import EPS
from tests.test_torch_textures import textured_scene  # noqa: F401  (the fixture)

torch.set_num_threads(2)

RES = 32


def _setup(scene):
    """The JAX and the port's scene tables, BVH and the primaries' inputs."""
    jds, host = jdevice.build_device_scene(scene, return_host=True)
    tri_idx = host["tri_index"]
    norms = host["normals"][tri_idx].sum(axis=1)
    norms /= np.maximum(np.linalg.norm(norms, axis=-1, keepdims=True), 1e-20)
    kw = dict(tri_normal=norms, tri_mesh=host["tri_mesh"])
    jbvh = jbuild_bvh(host["vertices"][tri_idx], **kw)
    arrs = jbuild_bvh(host["vertices"][tri_idx], _as_arrays=True, **kw)
    fields = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds) if f.name != "textures"}
    fields["textures"] = {k: np.asarray(getattr(jds.textures, k)) for k in ("pixels", "offset", "width", "height")}
    cam = scene.cameras[0]
    jcam = jcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, RES, RES)
    lin = jnp.arange(RES * RES, dtype=jnp.uint32)
    rstate = jrng.make_rng(10007, lin)
    rstate, ju = jrng.lcg_randomf(rstate)
    rstate, jv = jrng.lcg_randomf(rstate)
    rays = jcamera.primary_rays(jcam, RES, RES, ju, jv)
    si, _ = jtrace_closest_si(jds, jbvh, rays)
    return dict(jds=jds, jbvh=jbvh, rays=rays, si=si, rstate=rstate,
                tds=device_scene_from_numpy(fields, "cpu"), tbvh=bvh_from_numpy(arrs, "cpu"))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory, textured_scene):  # noqa: F811
    d = str(tmp_path_factory.mktemp("bounce"))
    return {"cornell": parse_scene(write_cornell_scene(d, width=RES, height=RES)),
            "cornell3": parse_scene(write_cornell3_scene(str(tmp_path_factory.mktemp("bounce3")))),
            "textured": textured_scene}


_SETUPS: dict = {}


def _inputs(scenes, name):
    if name not in _SETUPS:
        _SETUPS[name] = _setup(scenes[name])
    return _SETUPS[name]


def _t(a):
    return torch.tensor(np.asarray(a))


def _port_inputs(s):
    si = SurfaceInteraction(**{f.name: _t(getattr(s["si"], f.name)) for f in dataclasses.fields(s["si"])})
    rays = Ray(_t(s["rays"].origin), _t(s["rays"].direction))
    return rays, si, _t(np.asarray(s["rstate"]).astype(np.int64))


def _composed(ds, bvh, rays, si, rng, depth):
    """path_color from the plain K1, the traces and the plain K2."""
    n = rays.origin.shape[0]
    state = pk.PathState(p=si.p, nrm=si.n_geom, v=cm.normalize(rays.origin - si.p, eps=1e-30), diffuse=si.diffuse,
                         alpha=si.alpha, tp=torch.ones((n, 3)), alive=si.hit & ~si.is_light)
    color = torch.zeros((n, 3))
    counts = torch.zeros((depth, 3), dtype=torch.int64)
    for d in range(depth):
        b = pk.path_sample_plain(ds, state, rng)
        rng = b.rng
        occluded = trace_any(bvh, Ray(b.origin, b.shadow_dir), t_max=b.shadow_t, coherent=False)
        bounce_si = trace_closest_si(ds, bvh, Ray(b.origin, b.bounce_dir), active=b.sample_ok, coherent=False,
                                     t_max=b.bounce_t)
        counts[d] = torch.stack([state.alive.sum(), b.shadow_needed.sum(), b.sample_ok.sum()])
        color, state = pk.path_combine_plain(ds.num_lights, color, state, b, occluded, bounce_si)
    out = torch.where(si.is_light[:, None], si.emit, torch.clamp(color, min=EPS))
    return torch.where(si.hit[:, None], out, ds.miss_color[None, :]), rng, counts


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("name", ["cornell", "cornell3", "textured"])
def test_composed_bounce_matches_jax(scenes, name, depth):
    s = _inputs(scenes, name)
    want, want_rng, want_counts, _ = jax.jit(functools.partial(jpath.path_color, max_depth=depth))(
        s["jds"], s["jbvh"], s["rays"], s["si"], s["rstate"])
    rays, si, rng = _port_inputs(s)
    before = {f.name: getattr(si, f.name).clone() for f in dataclasses.fields(si)}
    got, got_rng, got_counts = _composed(s["tds"], s["tbvh"], rays, si, rng, depth)

    want = np.asarray(want)
    assert np.isfinite(got.numpy()).all()
    rmse = float(np.sqrt(((got.numpy() - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)
    assert rmse <= 5e-3, f"relative RMSE {rmse:.3g}"
    np.testing.assert_array_equal(got_rng.numpy().astype(np.uint32), np.asarray(want_rng))
    want_counts = np.asarray(want_counts, np.int64)
    assert want_counts[:, 1:].sum() > 0
    np.testing.assert_array_equal(got_counts.numpy(), want_counts)

    # the port's path_color is this composition, and writes no primary tensor
    color, rng_out, counts = tpath.path_color(s["tds"], s["tbvh"], rays, si, rng, max_depth=depth)
    assert torch.equal(color, got) and torch.equal(rng_out, got_rng) and torch.equal(counts, got_counts)
    for k, v in before.items():
        assert torch.equal(getattr(si, k), v), k


def test_plain_split_keeps_its_inputs(scenes):
    """Both plain pieces are functional: the state, the sample and the color
    they were given are unchanged after the call."""
    s = _inputs(scenes, "cornell3")
    rays, si, rng = _port_inputs(s)
    n = rays.origin.shape[0]
    state = pk.PathState(p=si.p, nrm=si.n_geom, v=cm.normalize(rays.origin - si.p, eps=1e-30), diffuse=si.diffuse,
                         alpha=si.alpha, tp=torch.full((n, 3), 0.5), alive=si.hit & ~si.is_light)
    snap = {f.name: getattr(state, f.name).clone() for f in dataclasses.fields(state)}
    rng0 = rng.clone()
    b = pk.path_sample_plain(s["tds"], state, rng)
    assert torch.equal(rng, rng0) and not torch.equal(b.rng, rng0)
    assert b.shadow_needed.any() and b.sample_ok.any() and (b.shadow_t[~b.shadow_needed] == 0).all()
    assert (b.bounce_t[b.sample_ok] == 3e38).all() and (b.bounce_t[~b.sample_ok] == 0).all()
    color = torch.rand((n, 3), generator=torch.Generator().manual_seed(3))
    color0 = color.clone()
    occluded = torch.arange(n) % 2 == 0
    bounce_si = trace_closest_si(s["tds"], s["tbvh"], Ray(b.origin, b.bounce_dir), active=b.sample_ok,
                                 coherent=False, t_max=b.bounce_t)
    new_color, nxt = pk.path_combine_plain(s["tds"].num_lights, color, state, b, occluded, bounce_si)
    assert torch.equal(color, color0)
    for k, v in snap.items():
        assert torch.equal(getattr(state, k), v), k
    assert (new_color >= color).all()
    assert torch.equal(nxt.alive, b.sample_ok & bounce_si.hit & ~bounce_si.is_light)


def test_path_color_routes_cpu_tensors_to_the_plain_versions(scenes, monkeypatch):
    s = _inputs(scenes, "cornell")
    rays, si, rng = _port_inputs(s)
    calls = {"sample": 0, "combine": 0}
    sample, combine = pk.path_sample_plain, pk.path_combine_plain

    def counting_sample(*a, **k):
        calls["sample"] += 1
        return sample(*a, **k)

    def counting_combine(*a, **k):
        calls["combine"] += 1
        return combine(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached a path kernel")

    monkeypatch.setattr(pk, "path_sample_plain", counting_sample)
    monkeypatch.setattr(pk, "path_combine_plain", counting_combine)
    monkeypatch.setattr(pk, "path_sample_cuda", no_kernel)
    monkeypatch.setattr(pk, "path_combine_cuda", no_kernel)
    a = tpath.path_color(s["tds"], s["tbvh"], rays, si, rng, max_depth=3)
    b = tpath.path_color(s["tds"], s["tbvh"], rays, si, rng, max_depth=3, plain=True)
    assert calls == {"sample": 6, "combine": 6}
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
    with pytest.raises(ValueError, match="no path bounce for device"):
        tpath._bounce_fns(torch.device("meta"), False)


def test_cuda_wrappers_refuse_cpu_tensors(scenes, monkeypatch):
    def no_build():
        raise AssertionError("a path kernel's library was built for a CPU tensor")

    monkeypatch.setattr(pk, "kernel_library", no_build)
    s = _inputs(scenes, "cornell")
    rays, si, rng = _port_inputs(s)
    n = rays.origin.shape[0]
    state = pk.PathState(p=si.p, nrm=si.n_geom, v=si.n_geom, diffuse=si.diffuse, alpha=si.alpha,
                         tp=torch.ones((n, 3)), alive=si.hit)
    with pytest.raises(ValueError, match="CUDA"):
        pk.path_sample_cuda(s["tds"], state, rng)
    b = pk.path_sample_plain(s["tds"], state, rng)
    with pytest.raises(ValueError, match="CUDA"):
        pk.path_combine_cuda(s["tds"].num_lights, torch.zeros((n, 3)), state, b, torch.zeros(n, dtype=torch.bool), si)
    assert pk.LAUNCHES == {"path_sample": 0, "path_combine": 0}


def test_profile_stages_split_the_plain_bounce(scenes):
    """utils.profile_frames' stages on a CPU frame through the plain
    versions, read from the program's own spans: every piece of the bounce
    in its span, once a call, and no stage span inside another."""
    from optix_renderer_tpu_torch.engine.modes import RendererType
    from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
    from optix_renderer_tpu_torch.utils import profile_frames

    depth = 2
    r = Renderer(scenes["cornell"], width=16, height=16, mode=RendererType.PATH, path_depth=depth, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _frame_impl(r.state, r.device_scene, r.bvh, mode=r.mode, width=16, height=16, path_depth=depth,
                    ratio_samples=r.ratio_samples)
    stages = profile_frames.device_breakdown(prof, 1)["stages"]
    calls = {name: st["calls_per_frame"] for name, st in stages.items() if st["calls_per_frame"]}
    # camera_rng: one span a frame; shade: the primaries' and each bounce's; the shading frame and the
    # BSDF sample are two bsdf spans a bounce
    assert calls == {"camera_rng": 1, "shade": 1 + depth, "nee": depth, "bsdf": 2 * depth, "combine": depth}
    spans = sorted((e for e in prof.events() if e.name in profile_frames.SPAN_STAGES),
                   key=lambda e: e.time_range.start)
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start, f"{b.name} inside {a.name}"
