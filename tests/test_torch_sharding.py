"""The port's multi-device split (``optix_renderer_tpu_torch.parallel.sharding``)
on the CPU, where a list of eight ``cpu`` entries stands for eight devices.

Held, at 32^2 on the procedural Cornell box:
- the row split against one device, bit for bit over two frames, in
  DIFFUSE, PATH depth 2, RATIO (its aux buffers too) and LTC_BASELINE, the
  g-buffers included;
- the grid-60 terrain (cluster tier) at 32 x 64 in NORMALS, bit for bit,
  on the CPU's plain walk and with the baked table forced on the CPU (every
  tile must get the table);
- the state's row shards are (4, 32, 3);
- the spp split against 8 sequential frames, bit for bit, ``accum_id`` + 8;
- ``render_rows`` against ``Renderer.render``: image, g-buffers, aux and
  the honest ray count;
- the port's split against the JAX package's 8-device split (conftest
  forces 8 host devices), to the goldens' tolerance: relative RMSE 1e-4
  for g-buffers and LTC, 5e-3 for PATH;
- the refusals: an empty device list, ``height % n``, a CUDA device when
  none exists.
"""

import numpy as np
import pytest
import torch

from optix_renderer_tpu.engine.modes import RendererType as JRendererType
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.parallel import sharding as jsharding
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.engine import RendererType
from optix_renderer_tpu_torch.engine import renderer as renderer_mod
from optix_renderer_tpu_torch.engine.renderer import Renderer, _frame_impl
from optix_renderer_tpu_torch.parallel import sharding
from optix_renderer_tpu_torch.scene import parse_scene, write_cornell_scene, write_terrain_scene

torch.set_num_threads(2)

RES, N_DEV = 32, 8
CPUS = ["cpu"] * N_DEV
TOL = {"gbuffer": 1e-4, "ltc": 1e-4, "path": 5e-3}  # tests/goldens/test_goldens.py


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_cornell_scene(str(tmp_path_factory.mktemp("cornell_split")), width=RES, height=RES)


@pytest.fixture(scope="module")
def terrain_path(tmp_path_factory):
    return write_terrain_scene(str(tmp_path_factory.mktemp("terrain_split")), grid=60, width=32, height=64)


def _single(r: Renderer, frames: int):
    """``frames`` frames of one device: (state, gbuffers, aux of the last)."""
    state = r.state
    for _ in range(frames):
        state, gb, aux = _frame_impl(state, r.device_scene, r.bvh, mode=r.mode, width=r.width, height=r.height,
                                     path_depth=r.path_depth, ratio_samples=r.ratio_samples, baked_tab=r.baked_tab)
    return state, gb, aux


def _split(r: Renderer, frames: int, devices=CPUS):
    """``frames`` frames of the row split: (ShardedState, per-tile gbuffers, per-tile aux)."""
    frame = sharding.make_sharded_frame_fn(devices, r.mode, r.width, r.height, r.path_depth, r.ratio_samples)
    ds, bvh, baked = (sharding.replicate(x, devices) for x in (r.device_scene, r.bvh, r.baked_tab))
    state = sharding.shard_render_state(r.state, devices)
    for _ in range(frames):
        state, gbs, auxs = frame(state, ds, bvh, baked)
    return state, gbs, auxs


def _assert_gbuffers_equal(got, want) -> None:
    for f in ("position", "normal", "albedo", "alpha", "uv", "material_id"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("mode,depth", [(RendererType.DIFFUSE, 1), (RendererType.PATH, 2),
                                        (RendererType.RATIO, 1), (RendererType.LTC_BASELINE, 1)],
                         ids=["diffuse", "path", "ratio", "ltc"])
def test_row_split_is_bit_identical(scene_path, mode, depth):
    r = Renderer(parse_scene(scene_path), width=RES, height=RES, mode=mode, path_depth=depth, device="cpu")
    want, want_gb, want_aux = _single(r, 2)
    state, gbs, auxs = _split(r, 2)
    got = sharding.gather_state(state, "cpu")
    assert got.accum_id == 2 and float(got.accum.abs().sum()) > 0
    assert torch.equal(got.accum, want.accum)
    _assert_gbuffers_equal(sharding.gather_rows(gbs, "cpu"), want_gb)
    aux = sharding.merge_aux(auxs, "cpu")
    assert sorted(aux) == sorted(want_aux)
    for k in want_aux:  # RATIO's ltc, sto_direct, sto_no_vis; PATH's per-bounce counts summed
        assert torch.equal(aux[k], want_aux[k]), k


@pytest.mark.parametrize("forced_bake", [False, True], ids=["lists", "baked"])
def test_row_split_terrain_is_bit_identical(terrain_path, monkeypatch, forced_bake):
    """BASELINE config 5's wiring at 32 x 64: every tile of the cluster tier
    gives the single-device image.  With the bake forced on the CPU, every
    tile's primary trace must get the baked table (the JAX split drops it,
    sharding.py:86)."""
    if forced_bake:
        monkeypatch.setattr(renderer_mod, "_bakes", lambda bvh: bvh.clustered)
    r = Renderer(parse_scene(terrain_path), width=32, height=64, mode=RendererType.NORMALS, device="cpu")
    assert r.bvh.clustered and (r.baked_tab is not None) == forced_bake
    want, _gb, _aux = _single(r, 1)
    tables = []
    trace = renderer_mod.trace_closest_si

    def recording(ds, bvh, rays, baked_tab=None, **kw):
        tables.append(baked_tab)
        return trace(ds, bvh, rays, baked_tab=baked_tab, **kw)

    monkeypatch.setattr(renderer_mod, "trace_closest_si", recording)
    state, _gbs, _auxs = _split(r, 1)
    assert len(tables) == N_DEV
    # each tile's buffers hold a copy of the renderer's table (a static input of its frame graph)
    assert all((np.array_equal(t.origin, r.baked_tab.origin) and torch.equal(t.tab, r.baked_tab.tab))
               if forced_bake else t is None for t in tables)
    assert torch.equal(sharding.gather_state(state, "cpu").accum, want.accum)


def test_row_shards_have_the_tile_shape(scene_path):
    r = Renderer(parse_scene(scene_path), width=RES, height=RES, mode=RendererType.MASK, device="cpu")
    state, gbs, _auxs = _split(r, 1)
    assert isinstance(state, sharding.ShardedState) and state.accum_id == 1
    assert {tuple(a.shape) for a in state.accum} == {(RES // N_DEV, RES, 3)}
    assert {tuple(g.position.shape) for g in gbs} == {(RES // N_DEV, RES, 3)}


def test_spp_split_matches_sequential_frames(scene_path):
    r = Renderer(parse_scene(scene_path), width=RES, height=RES, mode=RendererType.PATH, path_depth=2,
                 device="cpu")
    want, _gb, _aux = _single(r, N_DEV)
    frame = sharding.make_spp_sharded_frame_fn(CPUS, RendererType.PATH, RES, RES, path_depth=2)
    ds, bvh, baked = (sharding.replicate(x, CPUS) for x in (r.device_scene, r.bvh, r.baked_tab))
    got, gbs, auxs = frame(r.state, ds, bvh, baked)
    assert got.accum_id == r.state.accum_id + N_DEV == N_DEV
    assert len(gbs) == len(auxs) == N_DEV
    assert torch.equal(got.accum, want.accum)  # colors added in frame order: the same sums


@pytest.mark.parametrize("mode", [RendererType.PATH, RendererType.RATIO], ids=["path", "ratio"])
def test_render_rows_matches_render(scene_path, mode):
    """``render_rows`` leaves the renderer as ``render`` does: the image,
    the g-buffers, RATIO's aux (the mean over the frames) and the honest
    ray count (the tiles' per-bounce counts summed)."""
    scene = parse_scene(scene_path)
    one = Renderer(scene, width=RES, height=RES, mode=mode, path_depth=2, device="cpu")
    one.render(2)
    split = Renderer(scene, width=RES, height=RES, mode=mode, path_depth=2, device="cpu")
    sharding.render_rows(split, CPUS, 2)
    assert split.state.accum_id == 2
    np.testing.assert_array_equal(split.image(), one.image())
    _assert_gbuffers_equal(split.gbuffers, one.gbuffers)
    for k, v in one.aux.items():
        assert torch.equal(split.aux[k], v), k
    a, b = split.metrics, one.metrics
    assert a["frames"] == b["frames"] == 2
    assert a["rays_traced"] == b["rays_traced"] > 2 * RES * RES
    assert a["alive_per_bounce"] == b["alive_per_bounce"]


def _rmse(got, want) -> float:
    return float(np.sqrt(((got - want) ** 2).mean())) / max(float(np.abs(want).mean()), 1e-6)


@pytest.mark.parametrize("mode,depth,tol", [(RendererType.DIFFUSE, 1, TOL["gbuffer"]),
                                            (RendererType.LTC_BASELINE, 1, TOL["ltc"]),
                                            (RendererType.PATH, 2, TOL["path"])], ids=["diffuse", "ltc", "path"])
def test_split_matches_the_jax_split(scene_path, mode, depth, tol):
    jr = JRenderer(jparse_scene(scene_path), width=RES, height=RES, mode=JRendererType(int(mode)),
                   path_depth=depth)
    mesh = jsharding.make_mesh(N_DEV)
    jframe = jsharding.make_sharded_frame_fn(mesh, JRendererType(int(mode)), RES, RES, path_depth=depth)
    jstate = jsharding.shard_render_state(jr.state, mesh)
    jds, jbvh = jsharding.replicate(jr.device_scene, mesh), jsharding.replicate(jr.bvh, mesh)
    for _ in range(2):
        jstate, _gb, _aux = jframe(jstate, jds, jbvh)
    want = np.asarray(jstate.accum)

    r = Renderer(parse_scene(scene_path), width=RES, height=RES, mode=mode, path_depth=depth, device="cpu")
    state, _gbs, _auxs = _split(r, 2)
    got = sharding.gather_state(state, "cpu").accum.numpy()
    assert got.shape == want.shape and np.abs(want).mean() > 0
    assert _rmse(got, want) < tol


def test_refusals():
    with pytest.raises(ValueError, match="at least one device"):
        sharding.check_devices([])
    with pytest.raises(ValueError, match="divide into 3 row tiles"):
        sharding.make_sharded_frame_fn(["cpu"] * 3, RendererType.MASK, RES, RES)
    missing = f"cuda:{torch.cuda.device_count()}"  # the first index no card has
    with pytest.raises(RuntimeError, match="CUDA device"):
        sharding.check_devices(["cpu", missing])
