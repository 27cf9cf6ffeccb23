"""RoI max pooling (Fast R-CNN), batch-aligned.

Port of the semantics of `posecnn_tpu/ops/roi_pool.py:roi_pool_batched`: the
bin geometry of `_bin_edges` (the reference CUDA op's floor/ceil fractional
bins over `round(coord * scale)`, clipped to the map; empty bins give 0) and
an exact max over each bin. The TPU doubling table is a workaround for
batched gathers on the TPU and is not carried over: this plain version is a
separable masked max (over W per output column, then over H per output row).
JAX computes it in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import torch

NEG = -1e30


def bin_edges(rois: torch.Tensor, pooled: int, spatial_scale: float, H: int, W: int):
    """(R,7) rois -> integer bin edges (wstart, wend, hstart, hend), each
    (R, pooled), clipped to the map (`roi_pool.py:_bin_edges`). The geometry
    is float32 whatever the feature dtype; `torch.round` rounds half to even,
    as `jnp.round` does."""
    rois = rois.float()
    x1 = torch.round(rois[:, 2] * spatial_scale).to(torch.int32)
    y1 = torch.round(rois[:, 3] * spatial_scale).to(torch.int32)
    x2 = torch.round(rois[:, 4] * spatial_scale).to(torch.int32)
    y2 = torch.round(rois[:, 5] * spatial_scale).to(torch.int32)
    # divide by a tensor, not a Python number: on CUDA PyTorch turns division
    # by a scalar into a product with its reciprocal, and ceil(7 * (3 * (1/7)))
    # is then 4 where the reference op's ceil(7 * (3 / 7)) is 3
    div = torch.full_like(x1, pooled, dtype=torch.float32)
    bin_w = torch.clamp(x2 - x1 + 1, min=1).float() / div
    bin_h = torch.clamp(y2 - y1 + 1, min=1).float() / div
    pidx = torch.arange(pooled, dtype=torch.float32, device=rois.device)[None, :]

    def edges(lo, size, n):
        start = torch.floor(pidx * size[:, None]).to(torch.int32) + lo[:, None]
        end = torch.ceil((pidx + 1) * size[:, None]).to(torch.int32) + lo[:, None]
        return torch.clamp(start, 0, n), torch.clamp(end, 0, n)

    wstart, wend = edges(x1, bin_w, W)
    hstart, hend = edges(y1, bin_h, H)
    return wstart, wend, hstart, hend


def roi_pool_batched(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: int = 7,
    spatial_scale: float = 1.0 / 16.0,
) -> torch.Tensor:
    """feat (B,H,W,C), rois (B,D,7), where row (b, d) pools image b (its own
    batch column is ignored) -> (B, D, pooled, pooled, C) in feat's dtype."""
    B, H, W, C = feat.shape
    D = rois.shape[1]
    wstart, wend, hstart, hend = bin_edges(rois.reshape(B * D, 7), pooled, spatial_scale, H, W)
    wstart, wend = wstart.reshape(B, D, pooled), wend.reshape(B, D, pooled)
    hstart, hend = hstart.reshape(B, D, pooled), hend.reshape(B, D, pooled)
    ws = torch.arange(W, device=feat.device)
    hs = torch.arange(H, device=feat.device)
    neg = torch.tensor(NEG, dtype=feat.dtype, device=feat.device)
    out = []
    for b in range(B):
        f = feat[b]  # (H, W, C)
        cols = []
        for pw in range(pooled):  # W stage, one output column at a time
            wmask = (ws[None, :] >= wstart[b, :, pw, None]) & (ws[None, :] < wend[b, :, pw, None])  # (D, W)
            cols.append(torch.where(wmask[:, None, :, None], f[None], neg).amax(dim=2))  # (D, H, C)
        colmax = torch.stack(cols, dim=1)  # (D, pw, H, C)
        hmask = (hs[None, None, :] >= hstart[b, :, :, None]) & (hs[None, None, :] < hend[b, :, :, None])  # (D, ph, H)
        o = torch.where(hmask[:, :, None, :, None], colmax[:, None], neg).amax(dim=3)  # (D, ph, pw, C)
        empty = (hend[b] <= hstart[b])[:, :, None] | (wend[b] <= wstart[b])[:, None, :]
        out.append(torch.where(empty[..., None], torch.zeros((), dtype=feat.dtype, device=feat.device), o))
    return torch.stack(out)
