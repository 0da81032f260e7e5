"""Brute-force trace B1/B2 at the upper end of the brute tier: tables of
more than 1,024 rows (several shared-memory chunks of the CUDA kernels),
lanes that need no test, row order, and the tier boundary at 4,096
triangles.

The plain versions run here (the CUDA kernels are held against them on
the card by ``chip_smoke.py``); the Pallas kernels run in interpret mode.

Tolerances: tri_id and the occlusion bits exact against the Pallas
kernels (the same f32 operations in the same order); t, u, v within rtol
1e-4 / atol 1e-4 as in tests/unit/test_pallas_trace.py.  Against the JAX
brute-force tier on the terrain (556 units across, XLA's CPU lowering
contracts a*b + c*d into FMAs) t within rtol 1e-4 / atol 1e-3 and tri_id
equal on at least 99.9 % of rays, as tests/test_torch_cluster.py allows
for near-ties on shared edges.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel import pallas_trace as pt
from optix_renderer_tpu.accel import traverse as jtraverse
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu.engine.renderer import Renderer as JRenderer
from optix_renderer_tpu.scene import procedural
from optix_renderer_tpu.scene.config import parse_scene as jparse_scene
from optix_renderer_tpu_torch.accel import brute_trace as bt
from optix_renderer_tpu_torch.accel import traverse as ttraverse
from optix_renderer_tpu_torch.accel.build import BRUTE_MAX_TRIS
from optix_renderer_tpu_torch.core.types import Ray
from optix_renderer_tpu_torch.engine.modes import RendererType
from optix_renderer_tpu_torch.engine.renderer import Renderer
from optix_renderer_tpu_torch.scene.config import parse_scene

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
TERRAIN_T_TOL = dict(rtol=1e-4, atol=1e-3)
ID_AGREE_MIN = 0.999
T, N = 1100, 160  # rows 0..1099 random, row 1100 repeats row DUP_OF: a tie across the 1,024-row boundary
DUP_OF, DUP_ROW = 10, 1100


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    tris = (rng.normal(size=(T, 3, 3)) * 2).astype(np.float32)
    tris = np.concatenate([tris, tris[DUP_OF:DUP_OF + 1]])
    o = (rng.normal(size=(N, 3)) * 6).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # the first 32 rays start just off the duplicated triangle and head straight back at points inside it
    bary = rng.dirichlet([2.0, 2.0, 2.0], size=32).astype(np.float32)
    nrm = np.cross(tris[DUP_OF, 1] - tris[DUP_OF, 0], tris[DUP_OF, 2] - tris[DUP_OF, 0])
    nrm = (nrm / np.linalg.norm(nrm)).astype(np.float32)
    o[:32] = bary @ tris[DUP_OF] + 0.01 * nrm
    d[:32] = -nrm
    kind = rng.integers(0, 3, size=N)
    t_max = np.where(kind == 0, 0.0, np.where(kind == 1, 3.0e38, rng.uniform(0.5, 8.0, size=N)))
    t_max[:32] = 3.0e38
    v0 = tris[:, 0]
    tab = pt.pack_tri_table(v0, tris[:, 1] - v0, tris[:, 2] - v0, np.arange(T + 1), as_numpy=True)
    assert tab.shape[0] > 1024
    return o, d, t_max.astype(np.float32), tab


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jrays(o, d):
    return JRay(jnp.asarray(o), jnp.asarray(d))


def test_closest_plain_matches_pallas_kernel_over_several_chunks(case):
    o, d, t_max, tab = case
    want = pt.trace_closest_tiles(jnp.asarray(tab), _jrays(o, d), t_max=jnp.asarray(t_max), interpret=True)
    t, tri_id, u, v = (a.numpy() for a in bt.trace_closest_plain(*_torch(tab, o, d, t_max)))
    np.testing.assert_array_equal(tri_id, np.asarray(want.tri_id))
    hit = tri_id >= 0
    assert hit.sum() > 40 and (tri_id > 1024).any(), "the case must hit rows beyond the first 1,024"
    for got, ref in ((t, want.t), (u, want.bary_u), (v, want.bary_v)):
        np.testing.assert_allclose(got[hit], np.asarray(ref)[hit], **TOL)
    np.testing.assert_array_equal(t[~hit], t_max[~hit])  # a miss leaves t_max
    assert (u[~hit] == 0).all() and (v[~hit] == 0).all()


def test_any_plain_matches_pallas_kernel_over_several_chunks(case):
    o, d, t_max, tab = case
    want = np.asarray(pt.trace_any_tiles(jnp.asarray(tab), _jrays(o, d), t_max=jnp.asarray(t_max), interpret=True))
    got = bt.trace_any_plain(*_torch(tab, o, d, t_max)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 20 < want.sum() < N - 20
    # with the first 1,024 rows made degenerate (they never hit), only the later chunks occlude
    late = tab.copy()
    late[:1024, 3:9] = 0.0
    want = np.asarray(pt.trace_any_tiles(jnp.asarray(late), _jrays(o, d), t_max=jnp.asarray(t_max), interpret=True))
    got_late = bt.trace_any_plain(*_torch(late, o, d, t_max)).numpy()
    np.testing.assert_array_equal(got_late, want)
    assert got_late.any() and (got & ~got_late).any()


def test_closest_tie_lowest_row_wins_across_a_chunk_boundary(case):
    o, d, t_max, tab = case
    t, tri_id, _, _ = bt.trace_closest_plain(*_torch(tab, o, d, t_max))
    tri_id = tri_id.numpy()
    assert (tri_id[:32] == DUP_OF).sum() > 16, "aimed rays must reach the duplicated triangle"
    assert not (tri_id == DUP_ROW).any(), "a tie on equal t must go to the lowest table row"
    # with the first copy taken out, the same rays find the second at the same t
    alone = tab.copy()
    alone[DUP_OF, 3:9] = 0.0  # a degenerate triangle never hits
    t2, id2, _, _ = bt.trace_closest_plain(*_torch(alone, o, d, t_max))
    moved = tri_id == DUP_OF
    np.testing.assert_array_equal(id2.numpy()[moved], np.full(moved.sum(), DUP_ROW))
    np.testing.assert_array_equal(t2.numpy()[moved], t.numpy()[moved])


@pytest.mark.parametrize("fn", ["closest", "any"])
@pytest.mark.parametrize("dead", [0.0, -1.0, float("nan")], ids=["zero", "negative", "nan"])
def test_dead_lanes_return_the_miss_result(case, fn, dead):
    """A ray whose t_max is 0, negative or NaN can have no hit in (0, t_max):
    t_max comes back as it is with id -1 and u = v = 0, and the ray is not
    occluded; its neighbours are not disturbed."""
    o, d, t_max, tab = case
    tm = t_max.copy()
    tm[::3] = dead
    live = np.ones(N, bool)
    live[::3] = False
    if fn == "closest":
        t, tri_id, u, v = (a.numpy() for a in bt.trace_closest_plain(*_torch(tab, o, d, tm)))
        np.testing.assert_array_equal(t[~live], tm[~live])  # NaN equals NaN here
        assert (tri_id[~live] == -1).all() and (u[~live] == 0).all() and (v[~live] == 0).all()
        ref = [a.numpy() for a in bt.trace_closest_plain(*_torch(tab, o, d, t_max))]
        for got, want in zip((t, tri_id, u, v), ref):
            np.testing.assert_array_equal(got[live], want[live])
        want = pt.trace_closest_tiles(jnp.asarray(tab), _jrays(o, d), t_max=jnp.asarray(tm), interpret=True)
        np.testing.assert_array_equal(tri_id, np.asarray(want.tri_id))
        np.testing.assert_array_equal(t[~live], np.asarray(want.t)[~live])
    else:
        occ = bt.trace_any_plain(*_torch(tab, o, d, tm)).numpy()
        assert not occ[~live].any()
        np.testing.assert_array_equal(occ[live], bt.trace_any_plain(*_torch(tab, o, d, t_max)).numpy()[live])
        want = pt.trace_any_tiles(jnp.asarray(tab), _jrays(o, d), t_max=jnp.asarray(tm), interpret=True)
        np.testing.assert_array_equal(occ, np.asarray(want))


def test_any_does_not_depend_on_row_order(case):
    o, d, t_max, tab = case
    perm = np.random.default_rng(5).permutation(tab.shape[0])
    want = bt.trace_any_plain(*_torch(tab, o, d, t_max))
    got = bt.trace_any_plain(*_torch(np.ascontiguousarray(tab[perm]), o, d, t_max))
    assert torch.equal(got, want)
    assert want.any() and not want.all()


@pytest.fixture(scope="module", params=[46, 47], ids=["grid46_brute", "grid47_cluster"])
def tier(request, tmp_path_factory):
    grid = request.param
    path = procedural.write_terrain_scene(str(tmp_path_factory.mktemp(f"terrain{grid}")), grid=grid, width=16,
                                          height=16)
    jr = JRenderer(jparse_scene(path), width=16, height=16, mode=RendererType.MASK)
    tr = Renderer(parse_scene(path), width=16, height=16, mode=RendererType.MASK, device="cpu")
    return grid, jr.bvh, tr.bvh


def test_tier_boundary_and_closest_hits_match_jax_brute(tier):
    """grid 46 is the largest terrain of the brute tier and grid 47 the first
    of the cluster tier; on both the dispatcher's closest hits are those of
    the JAX package's brute-force trace."""
    grid, jb, tb = tier
    assert tb.num_tris == 2 * (grid - 1) ** 2 + 12
    assert tb.clustered == (grid == 47) and (tb.num_tris <= BRUTE_MAX_TRIS) == (grid == 46)
    rng = np.random.default_rng(grid)
    n = 384
    lo = np.asarray(jb.tri_v0).min(axis=0)
    hi = np.asarray(jb.tri_v0).max(axis=0)
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    o[: n // 2, 1] = hi[1] * 0.9  # half of the rays start high above the heightfield
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jtraverse.trace_closest_brute(jb, _jrays(o, d), 0.0, 3.0e38)
    hit = ttraverse.trace_closest(tb, Ray(*_torch(o, d)))
    want_id, got_id = np.asarray(want.tri_id), hit.tri_id.numpy()
    assert (got_id == want_id).mean() >= ID_AGREE_MIN
    same = (got_id == want_id) & (want_id >= 0)
    assert same.mean() > 0.8, "most rays must hit"
    np.testing.assert_allclose(hit.t.numpy()[same], np.asarray(want.t)[same], **TERRAIN_T_TOL)
    # a differing id is a tie: the same t on another triangle
    differ = got_id != want_id
    np.testing.assert_allclose(hit.t.numpy()[differ], np.asarray(want.t)[differ], **TERRAIN_T_TOL)


def test_coherent_flag_changes_no_hit(tier):
    """``coherent`` only picks how a tier traces (the brute tier's kernel B1
    lets the warps of a coherent batch vote to leave a test, the cluster
    tier sorts incoherent rays first); the hits are the same, bit for bit."""
    _grid, _jb, tb = tier
    rng = np.random.default_rng(3)
    n = 256
    lo, hi = tb.tri_v0.min(dim=0).values.numpy(), tb.tri_v0.max(dim=0).values.numpy()
    o = (lo + rng.random((n, 3)) * (hi - lo)).astype(np.float32)
    o[:, 1] = hi[1] * 0.9
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Ray(*_torch(o, d))
    a = ttraverse.trace_closest(tb, rays, coherent=True)
    b = ttraverse.trace_closest(tb, rays, coherent=False)
    assert (a.tri_id >= 0).float().mean() > 0.5
    for got, want in ((a.tri_id, b.tri_id), (a.t, b.t), (a.bary_u, b.bary_u), (a.bary_v, b.bary_v)):
        assert torch.equal(got, want)
