"""G-buffer-guided edge-avoiding denoiser (à-trous bilateral) and the ratio
combine (counterpart of ``optix_renderer_tpu/postprocess/denoise.py``).

The reference's ratio pipeline assumes denoised buffers
(ltc_ratio_estimator.py:5-6) but ships no denoiser.  This is an
edge-avoiding à-trous wavelet filter (Dammertz et al. 2010) guided by the
normal and position g-buffers, in plain PyTorch: shifts and weighted sums,
the glue the JAX package leaves to XLA.  Nothing here reads a value back
to the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# 5-tap B3-spline, separably applied as 25 2-D taps
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)
# the JAX package's defaults; no caller sets another value
ITERATIONS = 4
SIGMA_NORMAL = 0.25
SIGMA_POSITION = 0.05  # relative to the scene diagonal
RATIO_EPS = 1e-4


def atrous_denoise(
    color: torch.Tensor,  # (H, W, C) noisy buffer
    normal: torch.Tensor,  # (H, W, 3) g-buffer
    position: torch.Tensor,  # (H, W, 3) g-buffer
    sigma_color: float | None = None,
) -> torch.Tensor:
    """Edge-avoiding à-trous filtering; returns (H, W, C).

    Position differences are normalized by the buffer's extent, so
    SIGMA_POSITION works across scene scales.  sigma_color defaults to None
    (no color edge-stopping): the inputs are high-variance MC buffers where
    a color term only blocks the smoothing; edges are protected by the
    g-buffers.  Pass a value for low-noise inputs.

    A tap at offset (dy, dx) reads the edge-clamped neighbour
    ``x[clamp(i - dy), clamp(j - dx)]``: each iteration pads every buffer
    once by replication and takes the 25 taps as views of the padded copy.
    """
    pos_scale = torch.clamp(position.reshape(-1, 3).amax(dim=0) - position.reshape(-1, 3).amin(dim=0),
                            min=1e-6).amax()  # a 0-dim tensor: no host read
    out = color.permute(2, 0, 1)  # (C, H, W)
    nrm = normal.permute(2, 0, 1)  # (3, H, W)
    pos = position.permute(2, 0, 1) / pos_scale
    h, w = out.shape[1:]
    for it in range(ITERATIONS):
        step = 1 << it
        pad = 2 * step
        padded = [F.pad(a.contiguous(), (pad, pad, pad, pad), mode="replicate") for a in (out, nrm, pos)]
        accum = torch.zeros_like(out)
        wsum = out.new_zeros((h, w))
        sc = None if sigma_color is None else sigma_color * (2.0**-it)
        for iy, wy in enumerate(_B3):
            for ix, wx in enumerate(_B3):
                y0 = pad - (iy - 2) * step
                x0 = pad - (ix - 2) * step
                c_q, n_q, p_q = (a[:, y0:y0 + h, x0:x0 + w] for a in padded)
                d_n = ((nrm - n_q) ** 2).sum(dim=0)  # (H, W)
                d_p = ((pos - p_q) ** 2).sum(dim=0)
                wgt = (
                    (wy * wx)
                    * torch.exp(-d_n / (SIGMA_NORMAL * SIGMA_NORMAL))
                    * torch.exp(-d_p / (SIGMA_POSITION * SIGMA_POSITION))
                )
                if sc is not None:
                    d_c = ((out - c_q) ** 2).sum(dim=0)
                    wgt = wgt * torch.exp(-d_c / (sc * sc))
                accum = accum + wgt[None] * c_q
                wsum = wsum + wgt
        out = accum / torch.clamp(wsum, min=1e-10)[None]
    return out.permute(1, 2, 0)


def ratio_combine(
    ltc: torch.Tensor,  # (H, W, 3) analytic LTC direct
    sto_direct: torch.Tensor,  # (H, W, 1) shadowed stochastic (denoised)
    sto_no_vis: torch.Tensor,  # (H, W, 1) unshadowed stochastic (denoised)
) -> torch.Tensor:
    """final = ltc * D / N (ltc_ratio_estimator.py:4-10).

    Where the unshadowed estimate is ~0 (no light reaches the point even
    without occlusion) the ratio is defined as 0.
    """
    ratio = torch.where(sto_no_vis > RATIO_EPS, sto_direct / torch.clamp(sto_no_vis, min=RATIO_EPS), 0.0)
    return ltc * ratio


def denoise_and_combine(aux: dict, gbuffers) -> torch.Tensor:
    """The RATIO post stage of ``--denoise-ratio``: denoise both stochastic
    buffers of a RATIO ``Renderer.aux`` under its g-buffers, then
    ``ratio_combine``; returns (H, W, 3) on the buffers' device."""
    d = atrous_denoise(aux["sto_direct"], gbuffers.normal, gbuffers.position)
    n = atrous_denoise(aux["sto_no_vis"], gbuffers.normal, gbuffers.position)
    return ratio_combine(aux["ltc"], d, n)
