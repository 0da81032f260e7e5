"""The port's LCG RNG against ``optix_renderer_tpu.core.rng``: bit-exact.

The generator is integer arithmetic (uint32 in the JAX package, int64
masked to 32 bits in the port), so states must be equal and the f32
draws equal bit for bit, including the round-to-nearest-even of the
uint32 -> f32 cast above 2^24.

A frame's camera and RNG head (``engine.camera_kernel.camera_rng_plain``,
the plain version of kernel K0) against the JAX renderer's sequence
(``optix_renderer_tpu/engine/renderer.py:89-96``) on K0's card-test
shapes: states and origins bit for bit, directions within the primary
rays' tolerance of ``tests/test_torch_shading.py`` (XLA's CPU lowering of
the division and ``jnp.linalg.norm`` differs by 1 ulp on about 1 % of the
lanes).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.engine import camera as jcamera
from optix_renderer_tpu.engine.renderer import _block_dim as jblock_dim
from optix_renderer_tpu_torch.core import rng as trng
from optix_renderer_tpu_torch.engine import camera_kernel as ck
from optix_renderer_tpu_torch.engine.camera import camera_from_lookat
from optix_renderer_tpu_torch.scene import parse_scene

torch.set_num_threads(2)

_EDGE_IDS = np.array([0, 1, 2**24 - 1, 2**24, 2**24 + 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint64)


def _ids(seed: int = 0, n: int = 4096) -> np.ndarray:
    rand = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    return np.concatenate([_EDGE_IDS, rand])


def _jax_u32(a: np.ndarray):
    return jnp.asarray(a.astype(np.uint32))


def _torch_u32(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a.astype(np.int64))


def _as_u32(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    assert a.min() >= 0 and a.max() < 2**32, "port state left [0, 2^32)"
    return a.astype(np.uint32)


@pytest.mark.parametrize("fn", ["murmur_hash3_mix", "murmur_hash3_finalize"])
def test_murmur_rounds_bit_exact(fn):
    a, b = _ids(1), _ids(2)
    if fn == "murmur_hash3_mix":
        want = np.asarray(jrng.murmur_hash3_mix(_jax_u32(a), _jax_u32(b)))
        got = trng.murmur_hash3_mix(_torch_u32(a), _torch_u32(b))
    else:
        want = np.asarray(jrng.murmur_hash3_finalize(_jax_u32(a)))
        got = trng.murmur_hash3_finalize(_torch_u32(a))
    np.testing.assert_array_equal(_as_u32(got), want)


@pytest.mark.parametrize("accum_id", [0, 1, 3, 255, 2**31 - 10008])
def test_make_rng_and_chained_draws_bit_exact(accum_id):
    """The renderer's seeding (frame id accum_id + 10007, absolute pixel
    ids) and 8 chained draws: states and f32 uniforms bit for bit."""
    ids = _ids(accum_id)
    fid = accum_id + 10007
    js = jrng.make_rng(fid, _jax_u32(ids))
    ts = trng.make_rng(fid, _torch_u32(ids))
    np.testing.assert_array_equal(_as_u32(ts), np.asarray(js))
    for _ in range(4):
        js, ju1, ju2 = jrng.lcg_randomf2(js)
        ts, tu1, tu2 = trng.lcg_randomf2(ts)
        for j, t in ((ju1, tu1), (ju2, tu2)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(j).view(np.uint32))
            assert float(t.min()) >= 0.0 and float(t.max()) < 1.0 + 1e-7
        np.testing.assert_array_equal(_as_u32(ts), np.asarray(js))


@pytest.mark.parametrize("target", [0, 1, 2**24 - 1, 2**24 + 1, 2**24 + 3, 2**25 + 1, 2**31 + 129,
                                    2**32 - 129, 2**32 - 128, 2**32 - 1])
def test_draw_rounds_like_uint32_to_f32(target):
    """Choose the state whose next LCG step is ``target``, so the draw
    converts exactly that uint32 to f32: it must round as numpy does."""
    a_inv = pow(1664525, -1, 2**32)
    state = np.array([((target - 1013904223) * a_inv) % 2**32], np.uint64)
    _, u = trng.lcg_randomf(_torch_u32(state))
    _, ju = jrng.lcg_randomf(_jax_u32(state))
    want = np.float32(np.uint32(target).astype(np.float32) * np.float32(2.0**-32))
    assert u.numpy()[0].view(np.uint32) == want.view(np.uint32)
    assert np.asarray(ju)[0].view(np.uint32) == want.view(np.uint32)


def test_lcg_step_bit_exact():
    s = _ids(9)
    np.testing.assert_array_equal(_as_u32(trng.lcg_step(_torch_u32(s))), np.asarray(jrng.lcg_step(_jax_u32(s))))


CORNELL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "cornell", "scene.json")


def _jax_camera_rng(cam, width, height, row_offset, rows, frame_id):
    """JAX renderer.py:89-96 on a tile: block-major pixel ids, the seeding
    at frame_id + 10007 (wrapping in uint32), two draws, the rays."""
    n = rows * width
    bh, bw = jblock_dim(rows), jblock_dim(width)
    jc = jcamera.camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, width, height)
    lin = jnp.arange(n, dtype=jnp.uint32) + jnp.asarray(row_offset, jnp.uint32) * jnp.uint32(width)
    lin = jnp.moveaxis(lin.reshape(rows // bh, bh, width // bw, bw), 1, 2).reshape(n)
    state = jrng.make_rng(jnp.uint32(frame_id) + jnp.uint32(10007), lin)
    state, ju = jrng.lcg_randomf(state)
    state, jv = jrng.lcg_randomf(state)
    rays = jcamera.primary_rays(jc, width, height, ju, jv, lin=lin)
    return np.asarray(rays.origin), np.asarray(rays.direction), np.asarray(state)


@pytest.mark.parametrize("width,height,row_offset,rows,frame_id",
                         [(1024, 1024, 0, 1024, 0), (1024, 1024, 0, 1024, 2**32 - 10000), (1024, 1024, 256, 256, 5),
                          (1000, 600, 0, 600, 3), (30, 17, 0, 17, 7)])
def test_camera_rng_plain_matches_the_jax_sequence(width, height, row_offset, rows, frame_id):
    cam = parse_scene(CORNELL).cameras[0]
    want_o, want_d, want_s = _jax_camera_rng(cam, width, height, row_offset, rows, frame_id)
    tcam = camera_from_lookat(cam.from_, cam.at, cam.up, cam.cos_fovy, width, height, "cpu")
    for fid in (frame_id, torch.tensor(frame_id, dtype=torch.int64)):
        rays, state = ck.camera_rng_plain(tcam, fid, width, height, row_offset, rows)
        np.testing.assert_array_equal(_as_u32(state), want_s)
        np.testing.assert_array_equal(rays.origin.numpy(), want_o)
        assert rays.direction.dtype == torch.float32 and rays.direction.is_contiguous()
        np.testing.assert_allclose(rays.direction.numpy(), want_d, rtol=1e-5, atol=1e-6)
