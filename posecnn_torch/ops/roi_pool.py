"""RoI max pooling (Fast R-CNN), batch-aligned.

Port of `posecnn_tpu/ops/roi_pool.py:roi_pool_batched`: the bin geometry
of `_bin_edges` (the reference CUDA op's floor/ceil fractional bins over
`round(coord * scale)`, clipped to the map; empty bins give 0) and an exact
max over each bin, separable: over W per output column by the doubling
table of `_range_colmax` (whose custom backward the port carries over, so
the training gradient splits ties as JAX's does), then a masked max over H
per output row. JAX computes it in XLA, not in a Pallas kernel. `crop_pool_batched`, the
flagship training pool (`USE_CROP_POOL`), is at the end, and after it the
one-image forms `roi_pool` (:126) and `crop_pool` (:317), which take rois
(R, 7) whose column 0 names the image, as wrappers over the batched ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _build_levels(x: torch.Tensor):
    """Doubling-max levels along axis 1 of (B, W, M): level k holds the max
    over [i, i + 2^k) (`roi_pool.py:_build_levels`)."""
    W = x.shape[1]
    levels = [x]
    k = 1
    while 2 * k <= W:
        prev = levels[-1]
        pad = torch.full((x.shape[0], min(k, W)) + tuple(x.shape[2:]), NEG, dtype=x.dtype, device=x.device)
        levels.append(torch.maximum(prev, torch.cat([prev[:, k:], pad], dim=1)))
        k *= 2
    return levels


def _query_indices(wstart: torch.Tensor, wend: torch.Tensor, L: int, W: int):
    """(B, Q) bin starts and ends -> each query's two taps into the (L, W)
    table (`roi_pool.py:_query_indices`)."""
    length = torch.clamp(wend - wstart, min=1)
    kq = torch.zeros_like(length)
    for j in range(1, L):
        kq = kq + (length >= (1 << j)).to(kq.dtype)
    p2 = torch.ones_like(kq) << kq
    return (kq * W + wstart).long(), (kq * W + torch.clamp(wend - p2, min=0)).long()


class _RangeColMax(torch.autograd.Function):
    """The W stage of `roi_pool_batched` (`roi_pool.py:_range_colmax`, a
    custom_vjp): feat_t (B, W, M), wstart and wend (B, Q) -> (B, Q, M), each
    query's max over [wstart, wend) as the larger of two taps of the
    doubling table. Its backward is JAX's: each tap's share of the
    cotangent (a tie of the two taps splits it in halves), rounded to the
    features' dtype, summed into the table in float32, then walked down the
    levels (each level's tie between a position and its shifted partner
    splits in halves), so the gradient of a bin reaches the features that
    JAX's reaches, in JAX's shares."""

    @staticmethod
    def forward(ctx, feat_t, wstart, wend):
        B, W, M = feat_t.shape
        levels = _build_levels(feat_t)
        L = len(levels)
        flat = torch.stack(levels, dim=1).reshape(B, L * W, M)
        idx1, idx2 = _query_indices(wstart, wend, L, W)
        Q = idx1.shape[1]
        t1 = torch.gather(flat, 1, idx1[..., None].expand(B, Q, M))
        t2 = torch.gather(flat, 1, idx2[..., None].expand(B, Q, M))
        if ctx.needs_input_grad[0]:  # the table, the taps and their values, for the backward
            ctx.save_for_backward(flat, idx1, idx2, t1, t2)
            ctx.levels = L
        return torch.maximum(t1, t2)

    @staticmethod
    def backward(ctx, g):
        flat, idx1, idx2, t1, t2 = ctx.saved_tensors
        L = ctx.levels
        B, LW, M = flat.shape
        W, Q = LW // L, idx1.shape[1]
        levels = flat.view(B, L, W, M)
        eq = (t1 == t2).to(g.dtype)
        d1 = g * ((t1 > t2).to(g.dtype) + 0.5 * eq)
        d2 = g * ((t1 < t2).to(g.dtype) + 0.5 * eq)
        # the taps' cotangents in the features' dtype, summed in float32
        dq = torch.cat([d1, d2], dim=1).to(flat.dtype).float()
        idx = torch.cat([idx1, idx2], dim=1)
        dtable = torch.zeros((B, L * W, M), dtype=torch.float32, device=flat.device)
        dtable.scatter_add_(1, idx[..., None].expand(B, 2 * Q, M), dq)
        dtable = dtable.reshape(B, L, W, M)
        dcur = dtable[:, L - 1]
        for j in range(L - 1, 0, -1):
            k = 1 << (j - 1)
            prev = levels[:, j - 1]
            pad = torch.full((B, min(k, W), M), NEG, dtype=prev.dtype, device=prev.device)
            shifted = torch.cat([prev[:, k:], pad], dim=1)
            eqj = (prev == shifted).to(dcur.dtype)
            da = dcur * ((prev > shifted).to(dcur.dtype) + 0.5 * eqj)
            db = dcur * ((prev < shifted).to(dcur.dtype) + 0.5 * eqj)
            db_up = torch.cat([torch.zeros_like(db[:, :k]), db[:, :W - k]], dim=1)  # db[i] is prev[i + k]'s
            dcur = da + db_up + dtable[:, j - 1]
        return dcur.to(flat.dtype), None, None


def roi_pool_batched(
    feat: torch.Tensor,
    rois: torch.Tensor,
    pooled: int = 7,
    spatial_scale: float = 1.0 / 16.0,
) -> torch.Tensor:
    """feat (B,H,W,C), rois (B,D,7), where row (b, d) pools image b (its own
    batch column is ignored) -> (B, D, pooled, pooled, C) in feat's dtype.
    The W stage is `_RangeColMax` (JAX's doubling table and its backward);
    the H stage a masked max, whose gradient splits among equal values as
    jnp.max's does."""
    B, H, W, C = feat.shape
    D = rois.shape[1]
    wstart, wend, hstart, hend = bin_edges(rois.reshape(B * D, 7), pooled, spatial_scale, H, W)
    feat_t = feat.permute(0, 2, 1, 3).reshape(B, W, H * C)
    colmax = _RangeColMax.apply(feat_t, wstart.reshape(B, D * pooled), wend.reshape(B, D * pooled))
    colmax = colmax.reshape(B, D, pooled, H, C)  # (b, d, pw, h, c)
    hstart, hend = hstart.reshape(B, D, pooled), hend.reshape(B, D, pooled)
    wstart, wend = wstart.reshape(B, D, pooled), wend.reshape(B, D, pooled)
    hs = torch.arange(H, device=feat.device)
    neg = torch.tensor(NEG, dtype=feat.dtype, device=feat.device)
    out = []
    for b in range(B):  # the H stage image by image: (D, ph, pw, H, C) at a time
        hmask = (hs[None, None, :] >= hstart[b, :, :, None]) & (hs[None, None, :] < hend[b, :, :, None])
        o = torch.where(hmask[:, :, None, :, None], colmax[b][:, None], neg).amax(dim=3)  # (D, ph, pw, C)
        empty = (hend[b] <= hstart[b])[:, :, None] | (wend[b] <= wstart[b])[:, None, :]
        out.append(torch.where(empty[..., None], torch.zeros((), dtype=feat.dtype, device=feat.device), o))
    return torch.stack(out)


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """`jnp.clip(x, 0, 1)`: maximum, then minimum, so that a value exactly
    on a bound passes half its gradient, as there (torch.clamp passes all:
    a zero roi, whose weights sit on 0, would get twice JAX's gradient)."""
    return torch.minimum(torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device)),
                         torch.ones((), dtype=x.dtype, device=x.device))


def crop_pool_batched(
    feat: torch.Tensor,
    rois: torch.Tensor,
    spatial_scale: float = 1.0 / 16.0,
    pool_size: int = 7,
) -> torch.Tensor:
    """Bilinear crop then 2x2 max pool (`roi_pool.py:crop_pool_batched`, the
    flagship training pool): feat (B,H,W,C), rois (B,D,7), row (b, d) crops
    image b -> (B, D, pool_size, pool_size, C).

    Each roi is sampled on a (2p, 2p) grid at the centres of its cells; a
    bf16 map times the f32 bilinear weights promotes to f32, as it does in
    JAX, so the crops and the output are f32. The backward is autograd's:
    the gathers scatter-add into the map, and the 2x2 max sends each cell's
    gradient to its first largest sample, as XLA's select-and-scatter does.
    """
    B, H, W, C = feat.shape
    D = rois.shape[1]
    n = 2 * pool_size
    r = rois.float()
    x1 = r[..., 2] * spatial_scale
    y1 = r[..., 3] * spatial_scale
    x2 = r[..., 4] * spatial_scale
    y2 = r[..., 5] * spatial_scale
    t = (torch.arange(n, dtype=torch.float32, device=feat.device) + 0.5) / n
    sx = x1[..., None] + t * (x2 - x1)[..., None]  # (B,D,n)
    sy = y1[..., None] + t * (y2 - y1)[..., None]
    x0 = torch.clamp(torch.floor(sx).long(), 0, W - 1)
    x1i = torch.clamp(x0 + 1, 0, W - 1)
    y0 = torch.clamp(torch.floor(sy).long(), 0, H - 1)
    y1i = torch.clamp(y0 + 1, 0, H - 1)
    ax = _clip01(sx - x0)[:, :, None, :, None]  # weights along a crop row
    ay = _clip01(sy - y0)[:, :, :, None, None]
    flat = feat.reshape(B, H * W, C)

    def corner(yy, xx):
        idx = (yy[..., :, None] * W + xx[..., None, :]).reshape(B, D * n * n, 1)
        return torch.gather(flat, 1, idx.expand(B, D * n * n, C)).reshape(B, D, n, n, C)

    top = corner(y0, x0) * (1 - ax) + corner(y0, x1i) * ax
    bot = corner(y1i, x0) * (1 - ax) + corner(y1i, x1i) * ax
    crops = top * (1 - ay) + bot * ay  # (B,D,n,n,C) f32
    pooled = F.max_pool2d(crops.reshape(B * D, n, n, C).permute(0, 3, 1, 2), 2, 2)
    return pooled.permute(0, 2, 3, 1).reshape(B, D, pool_size, pool_size, C)


def _by_image(feat: torch.Tensor, rois: torch.Tensor, pool) -> torch.Tensor:
    """`pool(feat[b:b+1], rois[None])[0]` for every image b, each roi taking
    its image's (column 0; a roi naming no image of the batch takes image
    0's, as JAX's selection does)."""
    roi_batch = rois[:, 0].long()
    out = None
    for b in range(feat.shape[0]):
        ob = pool(feat[b:b + 1], rois[None])[0]
        if out is None:
            out = ob
        else:
            out = torch.where((roi_batch == b).reshape(-1, *([1] * (ob.dim() - 1))), ob, out)
    return out


def roi_pool(feat: torch.Tensor, rois: torch.Tensor, pooled_height: int = 7, pooled_width: int = 7,
             spatial_scale: float = 1.0 / 16.0, pool_channel: bool = False) -> torch.Tensor:
    """RoI max pooling of (B,H,W,C) maps over rois (R,7) [batch, class, x1,
    y1, x2, y2, score] -> (R, p, p, C), or (R, p, p, 1) with `pool_channel`
    (the channel of each roi's class) (`roi_pool.py:roi_pool`). The bins
    are `bin_edges`' (ROADMAP Queue 3 item 12's division)."""
    if pooled_height != pooled_width:
        raise ValueError("square pooling only")
    out = _by_image(feat, rois, lambda f, r: roi_pool_batched(f, r, pooled_height, spatial_scale))
    if pool_channel:
        cls = rois[:, 1].long()
        out = torch.gather(out, -1, cls[:, None, None, None].expand(*out.shape[:3], 1))
    return out


def crop_pool(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float = 1.0 / 16.0,
              pool_size: int = 7) -> torch.Tensor:
    """The bilinear crop of each roi to (2p)^2 samples, then a 2x2 max pool
    (`roi_pool.py:crop_pool`): feat (B,H,W,C), rois (R,7) -> (R, p, p, C),
    in float32 (JAX's one-image form multiplies in feat's dtype: equal on
    float32 maps)."""
    return _by_image(feat, rois, lambda f, r: crop_pool_batched(f, r, spatial_scale, pool_size))
