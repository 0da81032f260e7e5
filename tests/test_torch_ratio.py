"""The slice's integrators and its renderer modes: ``ltc_direct``, RATIO and
the denoiser of the port against the JAX package, plus the RATIO
renderer's own contract and the CLI.

The JAX ``Renderer`` renders RATIO at 32^2 on the procedural Cornell box
for 1 and 4 frames; the port's ``Renderer(device="cpu")`` renders the same
frames.  Tolerances (relative RMSE, as ``tests/goldens/test_goldens.py``):
the image (the LTC color) and aux ``ltc`` 1e-4, since LTC is the same
deterministic f32 arithmetic; ``sto_direct`` and ``sto_no_vis`` 5e-3, since
a last-bit difference in a light sample's direction can flip its shadow
ray's visibility.  ``ltc_direct`` rtol 1e-4 / atol 1e-5 (its clip can
take another case on a vertex within an ulp of the horizon); the denoiser
and ``ratio_combine`` rtol 1e-5 / atol 1e-6 (the same f32 operations,
with sums in another order).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.modes import RendererType
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.integrators import ltc_direct as jltc_direct
from optix_renderer_tpu.postprocess import denoise as jdenoise
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.integrators import ltc_direct as tltc_direct
from optix_renderer_tpu_torch.postprocess import denoise as tdenoise

torch.set_num_threads(2)

RES = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STO = ("sto_direct", "sto_no_vis")


def _rel_rmse(got, want) -> float:
    """Relative RMSE, as tests/goldens/test_goldens.py::_check."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return parse_scene(procedural.write_cornell_scene(str(tmp_path_factory.mktemp("ratio_scene"))))


@pytest.fixture(scope="module")
def jax_ratio(scene, tmp_path_factory):
    """The JAX renderer's RATIO results: 1 frame, a checkpoint after 2
    single frames, and a fresh 4-frame call."""
    one = JRenderer(scene, width=RES, height=RES, mode=RendererType.RATIO)
    one.render(1)
    res = {1: (one.image(), {k: np.asarray(v) for k, v in one.aux.items()})}
    one.render(1)
    ckpt = str(tmp_path_factory.mktemp("ratio_ckpt") / "jax2.npz")
    one.save_checkpoint(ckpt)
    four = JRenderer(scene, width=RES, height=RES, mode=RendererType.RATIO)
    four.render(4)
    res[4] = (four.image(), {k: np.asarray(v) for k, v in four.aux.items()})
    return res, ckpt


@pytest.mark.parametrize("frames", [1, 4])
def test_ratio_matches_jax(scene, jax_ratio, frames):
    want_img, want_aux = jax_ratio[0][frames]
    r = Renderer(scene, width=RES, height=RES, mode=RendererType.RATIO, device="cpu")
    r.render(frames)
    assert r.state.accum_id == frames
    assert _rel_rmse(r.image(), want_img) < 1e-4
    assert sorted(r.aux) == ["ltc", "sto_direct", "sto_no_vis"]
    assert _rel_rmse(r.aux["ltc"].numpy(), want_aux["ltc"]) < 1e-4
    for k in STO:
        err = _rel_rmse(r.aux[k].numpy(), want_aux[k])
        assert err < 5e-3, f"{k}: relative RMSE {err:.3g}"
    # honest count: primaries plus all ratio_samples visibility rays of every pixel
    assert r.metrics["rays_traced"] == frames * RES * RES * (1 + r.ratio_samples)


def test_ratio_aux_is_the_mean_over_a_call(scene):
    a = Renderer(scene, width=16, height=16, mode=RendererType.RATIO, device="cpu")
    b = Renderer(scene, width=16, height=16, mode=RendererType.RATIO, device="cpu")
    a.render(4)
    frames = []
    for _ in range(4):
        b.render(1)
        frames.append(b.aux)
    np.testing.assert_array_equal(a.state.accum.numpy(), b.state.accum.numpy())
    for k in ("ltc", *STO):
        mean = (((frames[0][k] + frames[1][k]) + frames[2][k]) + frames[3][k]) / 4
        np.testing.assert_array_equal(a.aux[k].numpy(), mean.numpy())
    # the accumulated color in RATIO mode is the LTC buffer
    np.testing.assert_allclose(a.aux["ltc"].numpy(), a.image(), rtol=1e-5, atol=1e-6)


def test_ratio_invariants(scene):
    """tests/integration/test_ratio_render.py:23-34 on the port."""
    r = Renderer(scene, width=RES, height=RES, mode=RendererType.RATIO, device="cpu")
    r.render(4)
    aux = r.aux
    assert aux["ltc"].shape == (RES, RES, 3) and aux["sto_direct"].shape == (RES, RES, 1)
    d, n = aux["sto_direct"].numpy(), aux["sto_no_vis"].numpy()
    assert np.isfinite(d).all() and np.isfinite(n).all()
    assert (n - d >= -1e-5).all()  # visibility only removes energy
    assert d.max() > 0.01 and n.max() > 0.01


def test_ratio_checkpoint_between_jax_and_port(scene, jax_ratio, tmp_path):
    (results, ckpt) = jax_ratio
    want = results[4][0]
    r = Renderer(scene, width=RES, height=RES, mode=RendererType.RATIO, device="cpu")
    r.load_checkpoint(ckpt)
    assert r.state.accum_id == 2
    r.render(2)
    assert _rel_rmse(r.image(), want) < 1e-4
    back = str(tmp_path / "port2.npz")
    p = Renderer(scene, width=RES, height=RES, mode=RendererType.RATIO, device="cpu")
    p.render(2)
    p.save_checkpoint(back)
    j = JRenderer(scene, width=RES, height=RES, mode=RendererType.RATIO)
    j.load_checkpoint(back)
    assert int(j.state.accum_id) == 2
    j.render(1)
    j.render(1)
    assert _rel_rmse(j.image(), want) < 1e-4


def test_ltc_direct_matches_jax(scene):
    """The integrator on Cornell primary hits, with the JAX DeviceScene and
    SurfaceInteraction carried across (as tests/test_torch_path.py)."""
    from optix_renderer_tpu.accel.build import build_bvh as jbuild_bvh
    from optix_renderer_tpu.core import rng as jrng
    from optix_renderer_tpu.engine import camera as jcamera
    from optix_renderer_tpu.engine.shade import trace_closest_si as jtrace_closest_si
    from optix_renderer_tpu.scene import device as jdevice
    from optix_renderer_tpu_torch.core.types import Ray, SurfaceInteraction
    from optix_renderer_tpu_torch.scene.device import device_scene_from_numpy

    jds, host = jdevice.build_device_scene(scene, return_host=True)
    tri_idx = host["tri_index"]
    jbvh = jbuild_bvh(host["vertices"][tri_idx])
    cam = scene.cameras[0]
    jcam = jcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, RES, RES)
    lin = jnp.arange(RES * RES, dtype=jnp.uint32)
    st, ju = jrng.lcg_randomf(jrng.make_rng(10007, lin))
    st, jv = jrng.lcg_randomf(st)
    rays = jcamera.primary_rays(jcam, RES, RES, ju, jv)
    si, _ = jtrace_closest_si(jds, jbvh, rays)
    fields = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds) if f.name != "textures"}
    fields["textures"] = {k: np.asarray(getattr(jds.textures, k)) for k in ("pixels", "offset", "width", "height")}
    tds = device_scene_from_numpy(fields, "cpu")
    tsi = SurfaceInteraction(**{f.name: torch.as_tensor(np.array(getattr(si, f.name)))
                                for f in dataclasses.fields(si)})
    trays = Ray(torch.as_tensor(np.array(rays.origin)), torch.as_tensor(np.array(rays.direction)))
    ports = {"ltc_direct": lambda: tltc_direct.ltc_direct(tds, trays, tsi),
             "ltc_baseline_color": lambda: tltc_direct.ltc_baseline_color(tds, trays, tsi)}
    for name, port in ports.items():
        want = np.asarray(getattr(jltc_direct, name)(jds, rays, si))
        got = port().numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)
        assert want.mean() > 0.01


@pytest.mark.parametrize("channels,sigma_color", [(1, None), (1, 0.1), (3, None), (3, 0.1)])
def test_denoise_matches_jax(channels, sigma_color):
    rng = np.random.default_rng(channels)
    h, w = 24, 20
    color = (0.5 + 0.05 * rng.normal(size=(h, w, channels))).astype(np.float32)  # a noisy flat signal
    normal = rng.normal(size=(h, w, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[: h // 2] = [0.0, 1.0, 0.0]  # a flat half, where the filter smooths
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    position = np.stack([xx, yy, np.zeros_like(xx)], axis=-1) * 0.5 + rng.normal(size=(h, w, 3)) * 0.01
    position = position.astype(np.float32)
    want = np.asarray(jdenoise.atrous_denoise(jnp.asarray(color), jnp.asarray(normal), jnp.asarray(position),
                                              sigma_color=sigma_color))
    got = tdenoise.atrous_denoise(torch.as_tensor(color), torch.as_tensor(normal), torch.as_tensor(position),
                                  sigma_color=sigma_color)
    assert got.shape == (h, w, channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want - color).max() > 1e-3, "the filter must change the input"


def test_ratio_combine_matches_jax():
    rng = np.random.default_rng(11)
    ltc = rng.uniform(0.0, 2.0, size=(16, 16, 3)).astype(np.float32)
    no_vis = rng.uniform(0.0, 1.0, size=(16, 16, 1)).astype(np.float32)
    no_vis[:2] = 0.0  # no light reaches: ratio 0
    direct = (no_vis * rng.uniform(0.0, 1.0, size=(16, 16, 1))).astype(np.float32)
    want = np.asarray(jdenoise.ratio_combine(jnp.asarray(ltc), jnp.asarray(direct), jnp.asarray(no_vis)))
    got = tdenoise.ratio_combine(torch.as_tensor(ltc), torch.as_tensor(direct), torch.as_tensor(no_vis))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert (want[:2] == 0).all()


def _cli(tmp_path, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    out_dir = tmp_path / "out"
    cmd = [sys.executable, "-m", "optix_renderer_tpu_torch.engine.cli", "--cpu", "--res", "16",
           "--out", str(out_dir), *args]
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out_dir


def test_cli_ratio_denoise_writes_outputs(tmp_path):
    scene = os.path.join(REPO, "scenes", "cornell3", "scene.json")
    # ratio_final.npy only under --save-npy, as the JAX CLI (tests/test_torch_cli.py holds the file sets)
    out_dir = _cli(tmp_path, "--scene", scene, "--renderer", "ratio", "--spp", "2", "--denoise-ratio", "--save-npy")
    for name in ("ratio", "ltc", "sto_direct", "sto_no_vis", "ratio_final"):
        assert (out_dir / f"{name}.png").exists(), name
    final = np.load(out_dir / "ratio_final.npy")
    assert final.shape == (16, 16, 3) and np.isfinite(final).all() and final.max() > 0


def test_cli_ltc_baseline(tmp_path):
    scene = os.path.join(REPO, "scenes", "cornell", "scene.json")
    out_dir = _cli(tmp_path, "--scene", scene, "--renderer", "ltc_baseline", "--save-npy")
    img = np.load(out_dir / "ltc_baseline.npy")
    assert (out_dir / "ltc_baseline.png").exists()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0
