"""Chromatic (HLS) jitter and Gaussian noise, applied inside the train step.

Port of `posecnn_tpu/ops/chromatic.py:chromatic_device` and the noise field
of `posecnn_tpu/engine/train.py:173-194`. Works in float on the 0..255
scale with cv2's HLS conventions (H in [0, 180), L and S in [0, 255]).
"""

from __future__ import annotations

import torch


def bgr_to_hls(bgr: torch.Tensor) -> torch.Tensor:
    """BGR float in [0,255] -> HLS with cv2's uint8 scaling (H/2 in [0,180))."""
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    x = bgr / 255.0
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    l = (maxc + minc) * 0.5
    crng = maxc - minc
    one = torch.ones((), dtype=bgr.dtype, device=bgr.device)
    safe = torch.where(crng > 0, crng, one)
    denom = torch.where(l <= 0.5, maxc + minc, 2.0 - maxc - minc)
    s = torch.where(crng > 0, crng / torch.where(denom > 0, denom, one), 0.0)
    rf, gf, bf = r / 255.0, g / 255.0, b / 255.0
    h_r = 60.0 * (gf - bf) / safe
    h_g = 120.0 + 60.0 * (bf - rf) / safe
    h_b = 240.0 + 60.0 * (rf - gf) / safe
    h = torch.where(maxc == rf, h_r, torch.where(maxc == gf, h_g, h_b))
    h = torch.where(crng > 0, torch.remainder(h, 360.0), 0.0)
    return torch.stack([h * 0.5, l * 255.0, s * 255.0], dim=-1)


def _hue_component(m1: torch.Tensor, m2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    h = torch.remainder(h, 360.0)
    return torch.where(
        h < 60.0, m1 + (m2 - m1) * h / 60.0,
        torch.where(h < 180.0, m2, torch.where(h < 240.0, m1 + (m2 - m1) * (240.0 - h) / 60.0, m1)),
    )


def hls_to_bgr(hls: torch.Tensor) -> torch.Tensor:
    """HLS (cv2's uint8 scaling) -> BGR float in [0,255]."""
    h = hls[..., 0] * 2.0
    l = hls[..., 1] / 255.0
    s = hls[..., 2] / 255.0
    m2 = torch.where(l <= 0.5, l * (1.0 + s), l + s - l * s)
    m1 = 2.0 * l - m2
    r = _hue_component(m1, m2, h + 120.0)
    g = _hue_component(m1, m2, h)
    b = _hue_component(m1, m2, h - 120.0)
    return torch.stack([b, g, r], dim=-1) * 255.0


def chromatic_device(data: torch.Tensor, dhls: torch.Tensor) -> torch.Tensor:
    """Per-image HLS jitter of a (B,H,W,3) BGR float batch in [0,255].
    dhls (B,3): the deltas (d_h, d_l, d_s); hue wraps mod 180, L and S clip
    to [0,255]."""
    hls = bgr_to_hls(data)
    d = dhls[:, None, None, :]
    h = torch.remainder(hls[..., 0] + d[..., 0], 180.0)
    l = torch.clamp(hls[..., 1] + d[..., 1], 0.0, 255.0)
    s = torch.clamp(hls[..., 2] + d[..., 2], 0.0, 255.0)
    return torch.clamp(hls_to_bgr(torch.stack([h, l, s], dim=-1)), 0.0, 255.0)


def add_noise_field(data: torch.Tensor, sigma: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """data (B,H,W,3) in [0,255] plus sigma (B,) times one N(0,1) field
    (B,H,W) shared by the channels, clipped to [0,255] (`train.py:183-193`)."""
    return torch.clamp(data + sigma[:, None, None, None] * field[..., None], 0.0, 255.0)
