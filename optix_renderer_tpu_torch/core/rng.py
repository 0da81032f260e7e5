"""Bit-exact batched LCG RNG (counterpart of ``optix_renderer_tpu/core/rng.py``).

A 32-bit LCG (a=1664525, c=1013904223) seeded by MurmurHash3 of the linear
pixel index mixed with the frame id.  PyTorch on the CPU has no uint32 add
or shift, so every state is held in int64 in [0, 2^32) and each step masks
with 0xFFFFFFFF.  Products of two 32-bit values would overflow int64, so
multiplications split the constant into 16-bit halves.  The int64 -> f32
cast rounds to nearest even, as numpy's and CUDA's uint32 -> f32 casts do.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_LCG_A = 1664525  # lcg_random.cuh:43
_LCG_C = 1013904223  # lcg_random.cuh:44


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16  # < 2^32
    return (lo + hi) & _MASK


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def murmur_hash3_mix(hash_: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 mix round (lcg_random.cuh:11-28)."""
    k = _mul32(k, 0xCC9E2D51)
    k = _rotl32(k, 15)
    k = _mul32(k, 0x1B873593)
    hash_ = hash_ ^ k
    hash_ = _rotl32(hash_, 13)
    return (_mul32(hash_, 5) + 0xE6546B64) & _MASK


def murmur_hash3_finalize(hash_: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 finalizer (lcg_random.cuh:30-39)."""
    hash_ = hash_ ^ (hash_ >> 16)
    hash_ = _mul32(hash_, 0x85EBCA6B)
    hash_ = hash_ ^ (hash_ >> 13)
    hash_ = _mul32(hash_, 0xC2B2AE35)
    return hash_ ^ (hash_ >> 16)


def make_rng(frame_id: int | torch.Tensor, linear_pixel_idx: torch.Tensor) -> torch.Tensor:
    """Seed per-ray states (lcg_random.cuh:54-62).

    frame_id: an int, or a 0-d integer tensor on the pixels' device (the
    frame id that a captured CUDA graph reads, ``engine.frame_graph``): the
    same seeds either way; linear_pixel_idx: integer tensor of
    ``x + y * width``.  Returns int64 states in [0, 2^32).
    """
    idx = linear_pixel_idx.to(torch.int64) & _MASK
    state = murmur_hash3_mix(torch.zeros_like(idx), idx)
    if isinstance(frame_id, torch.Tensor):
        fid = frame_id.to(torch.int64) & _MASK  # 0-d, broadcast against the pixels
    else:
        fid = torch.full_like(idx, int(frame_id) & _MASK)
    state = murmur_hash3_mix(state, fid)
    return murmur_hash3_finalize(state)


def lcg_step(state: torch.Tensor) -> torch.Tensor:
    """Advance the LCG (lcg_random.cuh:41-47); the new state is also the sample."""
    return (_mul32(state, _LCG_A) + _LCG_C) & _MASK


def lcg_randomf(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw float32 uniforms in [0, 1); returns (new_state, floats).

    ldexp((float)u32, -32): the state rounds to f32 (nearest even above
    2^24), then scales exactly by 2^-32.
    """
    new_state = lcg_step(state)
    return new_state, new_state.to(torch.float32) * (2.0**-32)


def lcg_randomf2(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Draw two uniforms; returns (state, u1, u2)."""
    state, u1 = lcg_randomf(state)
    state, u2 = lcg_randomf(state)
    return state, u1, u2
