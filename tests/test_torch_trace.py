"""Brute-force trace B1/B2: the port's plain versions and dispatcher against
the Pallas kernels (interpret mode) and the JAX brute-force tier.

The random case of ``tests/unit/test_pallas_trace.py`` (T=53, N=700) plus
a duplicated triangle (an exact tie: the lowest table row must win), rays
aimed at it, and per-ray t_max with zeros and misses.  tri_id must be
exact; t, u, v within rtol 1e-4 / atol 1e-4 as in test_pallas_trace.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.accel import build as jbuild
from optix_renderer_tpu.accel import pallas_trace as pt
from optix_renderer_tpu.accel import traverse as jtraverse
from optix_renderer_tpu.core.types import Ray as JRay
from optix_renderer_tpu_torch.accel import brute_trace as bt
from optix_renderer_tpu_torch.accel import build as tbuild
from optix_renderer_tpu_torch.accel import traverse as ttraverse
from optix_renderer_tpu_torch.core.types import Ray

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
DUP_OF, DUP_ROW = 10, 53  # row 53 repeats triangle 10


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    T, N = 53, 700
    tris = (rng.normal(size=(T, 3, 3)) * 2).astype(np.float32)
    tris = np.concatenate([tris, tris[DUP_OF:DUP_OF + 1]])
    o = (rng.normal(size=(N, 3)) * 3).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # the first 64 rays start just off the duplicated triangle and head
    # straight back at points inside it
    bary = rng.dirichlet([2.0, 2.0, 2.0], size=64).astype(np.float32)
    target = bary @ tris[DUP_OF]
    nrm = np.cross(tris[DUP_OF, 1] - tris[DUP_OF, 0], tris[DUP_OF, 2] - tris[DUP_OF, 0])
    nrm = (nrm / np.linalg.norm(nrm)).astype(np.float32)
    o[:64] = target + 0.05 * nrm
    d[:64] = -nrm
    kind = rng.integers(0, 3, size=N)
    t_max = np.where(kind == 0, 0.0, np.where(kind == 1, 3.0e38, rng.uniform(0.5, 8.0, size=N)))
    t_max[:64] = 3.0e38
    t_max = t_max.astype(np.float32)
    v0 = tris[:, 0]
    tab = pt.pack_tri_table(v0, tris[:, 1] - v0, tris[:, 2] - v0, np.arange(T + 1), as_numpy=True)
    return tris, o, d, t_max, tab


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _assert_hits_match(got, want_t, want_id, want_u, want_v, t_max):
    t, tri_id, u, v = (np.asarray(a) for a in got)
    np.testing.assert_array_equal(tri_id, np.asarray(want_id))
    hit = tri_id >= 0
    assert hit.sum() > 50, "the case must exercise hits"
    np.testing.assert_allclose(t[hit], np.asarray(want_t)[hit], **TOL)
    np.testing.assert_allclose(u[hit], np.asarray(want_u)[hit], **TOL)
    np.testing.assert_allclose(v[hit], np.asarray(want_v)[hit], **TOL)
    np.testing.assert_array_equal(t[~hit], t_max[~hit])  # a miss leaves t_max
    assert (~hit).sum() > 50 and (t_max[~hit] == 0).any(), "the case must exercise misses and t_max = 0"


def test_closest_plain_matches_pallas_kernel(case):
    tris, o, d, t_max, tab = case
    want = pt.trace_closest_tiles(jnp.asarray(tab), JRay(jnp.asarray(o), jnp.asarray(d)),
                                  t_max=jnp.asarray(t_max), interpret=True)
    got = bt.trace_closest_plain(*_torch(tab, o, d, t_max))
    assert got[1].dtype == torch.int32
    _assert_hits_match(got, want.t, want.tri_id, want.bary_u, want.bary_v, t_max)


def test_closest_tie_lowest_row_wins(case):
    tris, o, d, t_max, tab = case
    _, tri_id, _, _ = bt.trace_closest_plain(*_torch(tab, o, d, t_max))
    tri_id = tri_id.numpy()
    assert (tri_id[:64] == DUP_OF).sum() > 20, "aimed rays must reach the duplicated triangle"
    assert not (tri_id == DUP_ROW).any(), "a tie on equal t must go to the lowest table row"


def test_any_plain_matches_pallas_kernel(case):
    tris, o, d, t_max, tab = case
    want = np.asarray(pt.trace_any_tiles(jnp.asarray(tab), JRay(jnp.asarray(o), jnp.asarray(d)),
                                         t_max=jnp.asarray(t_max), interpret=True))
    got = bt.trace_any_plain(*_torch(tab, o, d, t_max))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 50 < want.sum() < len(want) - 50


@pytest.fixture(scope="module")
def bvhs(case):
    tris = case[0]
    return jbuild.build_bvh(tris), tbuild.build_bvh(tris, "cpu")


@pytest.mark.parametrize("t_max_kind", ["per_ray", "scalar"])
def test_dispatcher_closest_matches_jax_brute_tier(case, bvhs, t_max_kind):
    tris, o, d, t_max, _ = case
    jbvh, tbvh = bvhs
    tm = t_max if t_max_kind == "per_ray" else np.full_like(t_max, 3.0e38)
    want = jtraverse.trace_closest_brute(jbvh, JRay(jnp.asarray(o), jnp.asarray(d)), 0.0, jnp.asarray(tm))
    arg = torch.as_tensor(tm) if t_max_kind == "per_ray" else 3.0e38
    hit = ttraverse.trace_closest(tbvh, Ray(*_torch(o, d)), t_max=arg)
    got = (hit.t, hit.tri_id, hit.bary_u, hit.bary_v)
    if t_max_kind == "scalar":
        assert (hit.tri_id.numpy() < 0).any()
        np.testing.assert_array_equal(np.asarray(want.tri_id), hit.tri_id.numpy())
        m = hit.tri_id.numpy() >= 0
        np.testing.assert_allclose(hit.t.numpy()[m], np.asarray(want.t)[m], **TOL)
        return
    _assert_hits_match(got, want.t, want.tri_id, want.bary_u, want.bary_v, tm)


def test_dispatcher_any_matches_jax_brute_tier(case, bvhs):
    tris, o, d, t_max, _ = case
    jbvh, tbvh = bvhs
    want = np.asarray(jtraverse.trace_any_brute(jbvh, JRay(jnp.asarray(o), jnp.asarray(d)), 0.0,
                                                jnp.asarray(t_max)))
    occ = ttraverse.trace_any(tbvh, Ray(*_torch(o, d)), t_max=torch.as_tensor(t_max))
    np.testing.assert_array_equal(occ.numpy(), want)


def test_packed_table_byte_equal_to_jax_build(case):
    tris = case[0]
    rng = np.random.default_rng(3)
    nrm = rng.normal(size=(len(tris), 3)).astype(np.float32)
    mesh = rng.integers(0, 5, size=len(tris)).astype(np.int32)
    want = jbuild.build_bvh(tris, tri_normal=nrm, tri_mesh=mesh, _as_arrays=True)
    got = tbuild.build_bvh(tris, "cpu", tri_normal=nrm, tri_mesh=mesh)
    assert got.tri_tab.shape == (56, 16) and got.tri_tab.dtype == torch.float32
    assert got.tri_tab.numpy().tobytes() == want["tri_tab"].tobytes()
    assert (got.tri_tab[len(tris):, 9] == -1.0).all()
    for key in ("tri_v0", "tri_e1", "tri_e2", "prim_id"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), want[key])
    # the JAX build products carry across as they are
    carried = tbuild.bvh_from_numpy(want, "cpu")
    assert carried.tri_tab.dtype == torch.float32 and carried.prim_id.dtype == torch.int32
    assert carried.tri_tab.numpy().tobytes() == want["tri_tab"].tobytes()


def test_guards_raise(case):
    tris, o, d, t_max, tab = case
    bvh = tbuild.build_bvh(tris, "cpu")
    rays = Ray(*_torch(o, d))
    with pytest.raises(ValueError, match="t_min"):
        ttraverse.trace_closest(bvh, rays, t_min=1e-3)
    with pytest.raises(ValueError, match="empty scene"):
        tbuild.build_bvh(np.zeros((0, 3, 3), np.float32), "cpu")
    # above the brute tier the cluster tier's shade rows need the attributes
    with pytest.raises(ValueError, match="tri_attr"):
        tbuild.build_bvh(np.zeros((4097, 3, 3), np.float32), "cpu")
    # a CUDA wrapper never runs the plain version: a CPU tensor is refused
    with pytest.raises(ValueError, match="CUDA"):
        bt.trace_closest_cuda(*_torch(tab, o, d, t_max))
    with pytest.raises(ValueError, match="CUDA"):
        bt.trace_any_cuda(*_torch(tab, o, d, t_max))
    with pytest.raises(ValueError, match=r"\(Tpad, 16\)"):
        bt.trace_closest_cuda(*_torch(tab[:, :9], o, d, t_max))
    with pytest.raises(ValueError, match="t_max"):
        bt.trace_any_cuda(*_torch(tab, o, d, t_max[:5]))


def test_empty_batch(case):
    tab = torch.as_tensor(case[4])
    e3, e1 = torch.zeros((0, 3)), torch.zeros((0,))
    t, tri_id, u, v = bt.trace_closest_plain(tab, e3, e3, e1)
    assert t.shape == tri_id.shape == u.shape == v.shape == (0,)
    assert bt.trace_any_plain(tab, e3, e3, e1).shape == (0,)
