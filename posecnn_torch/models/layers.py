"""Layer primitives of the port, as functions on tensors.

Port of `posecnn_tpu/models/layers.py`. Activations stay NHWC at every public
function, as in the JAX package; a convolution views its NHWC input as NCHW
with `permute`, which is PyTorch's channels_last layout, so cuDNN runs it in
NHWC without a copy. Weights are in PyTorch's layouts: convolutions OIHW,
fully connected (out, in).

Compute dtype policy (as in JAX): `conv2d`, `conv1x1_upsample` and `fc` cast
inputs and weights to `compute_dtype`, and the result to float32 before the
float32 bias; parameters stay float32.

Tensor parallelism: a weight that `parallel.mesh.shard_model` split over
the model axis (its output channels; tagged `tp_mesh`) runs between
`parallel/tp.py`'s f, on the input, and g, which gathers the channels
before the whole bias is added (a bias sliced before g would leave each
rank's bias gradient holding its own slice alone).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from posecnn_torch.ops.conv3x3 import conv3x3_raw, conv3x3_vjp, oihw_to_hwio
from posecnn_torch.parallel.mesh import tp_mesh
from posecnn_torch.parallel.tp import copy_to_model, gather_from_model


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    x: torch.Tensor,
    relu: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Stride-1 SAME convolution (odd kernel), NHWC in, float32 NHWC out
    (`layers.py:conv2d`)."""
    mesh = tp_mesh(weight)
    if mesh is not None:
        x = copy_to_model(x, mesh)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    y = _nhwc(F.conv2d(_nchw(x), weight, padding=weight.shape[-1] // 2)).float()
    if mesh is not None:
        y = gather_from_model(y, mesh, -1)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def same_pads(n: int, k: int, s: int):
    """TensorFlow SAME padding of one axis of size n under a k-wide window at
    stride s: (before, after), the odd pixel after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d_strided(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    x: torch.Tensor,
    stride: int,
    relu: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """`layers.py:conv2d` at any stride with TF SAME padding (`same_pads`:
    a 4x4/2 convolution of an even side pads 1 and 1, a 3x3/2 one 0 and
    1), NHWC in, float32 NHWC out."""
    k = weight.shape[-1]
    (t, b), (lft, r) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    y = F.conv2d(F.pad(_nchw(x), (lft, r, t, b)), weight, stride=stride)
    y = _nhwc(y).float()
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def conv_transpose(weight: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """A learned transposed convolution with TF SAME semantics
    (`jax.lax.conv_transpose(..., "SAME", transpose_kernel=True)`, as
    tf.nn.conv2d_transpose): output side n * stride. `weight` is the JAX
    (k, k, c_o, c_i) kernel in the port's layout (c_i, c_o, k, k). The full
    transposed convolution is cut to JAX's window: JAX pads the dilated
    input by pad_a = k - 1 when stride > k - 1, else ceil((k + stride -
    2) / 2), before it, so the first k - 1 - pad_a outputs are dropped."""
    k = weight.shape[-1]
    pad_len = k + stride - 2
    pad_a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    cut = k - 1 - pad_a
    B, H, W, _ = x.shape
    y = F.conv_transpose2d(_nchw(x.float()), weight.float(), stride=stride)
    return _nhwc(y[:, :, cut:cut + H * stride, cut:cut + W * stride])


def deconv_weights(weight: torch.Tensor, x: torch.Tensor, stride: int) -> torch.Tensor:
    """`layers.py:deconv` on a stored kernel (the port's (c_i, c_o, k, k)):
    where c_o == c_i and k <= 2 * stride, JAX takes its bilinear path and
    reads only the kernel's size, not its values (ROADMAP Queue 3 item 54),
    and so does this (`deconv`); elsewhere the learned `conv_transpose`."""
    c_i, c_o, k = weight.shape[0], weight.shape[1], weight.shape[-1]
    if c_o == c_i and k <= 2 * stride:
        return deconv(x, k, stride)
    return conv_transpose(weight, x, stride)


class _Conv3x3MB(torch.autograd.Function):
    """`layers.py:_conv3x3_mb` (custom_vjp): the bf16 conv body rounded to
    bf16, the bias added in bf16, then ReLU, all in one conv3x3 kernel launch
    (its trunk epilogue); backward `_conv3x3_mb_bwd`, dx by the same kernel."""

    @staticmethod
    def forward(ctx, xb, w, b):
        wb = oihw_to_hwio(w).to(torch.bfloat16)
        y = conv3x3_raw(xb, wb, b.float(), True, bf16_bias=True)
        ctx.save_for_backward(xb, wb, y)
        return y

    @staticmethod
    def backward(ctx, g):
        xb, wb, y = ctx.saved_tensors
        g = torch.where(y > 0, g.to(torch.bfloat16), torch.zeros((), dtype=torch.bfloat16, device=g.device))
        return conv3x3_vjp(xb, wb, g, ctx.needs_input_grad)


class _Conv3x3F32Bias(torch.autograd.Function):
    """`layers.py:conv2d` in bf16 with its bias and ReLU, the convolution on
    the conv3x3 kernel: its zero-bias launch gives the f32 sum rounded to
    bf16 once (what a bf16 conv returns); the f32 bias and the ReLU follow
    in f32. The backward is XLA's autodiff of it: db sums the f32 cotangent;
    dx (the kernel's dgrad) and dw (rounded to bf16) come from the
    cotangent rounded to bf16."""

    @staticmethod
    def forward(ctx, xb, w, b):
        wb = oihw_to_hwio(w).to(torch.bfloat16)
        y = torch.relu(conv3x3_raw(xb, wb, torch.zeros_like(b, dtype=torch.float32), False).float() + b)
        ctx.save_for_backward(xb, wb, y)
        return y

    @staticmethod
    def backward(ctx, g):
        xb, wb, y = ctx.saved_tensors
        g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        dx, dw, _ = conv3x3_vjp(xb, wb, g.to(torch.bfloat16), ctx.needs_input_grad[:2] + (False,))
        if dw is not None:
            dw = dw.to(torch.bfloat16).float()
        db = g.float().sum(dim=(0, 1, 2)) if ctx.needs_input_grad[2] else None
        return dx, dw, db


def _refuse_split(weight: torch.Tensor) -> None:
    # the conv3x3 kernel takes 64 or 128 output channels; a split conv1_2
    # (36,864 elements, below any threshold a shipped run sets) is not run
    if tp_mesh(weight) is not None:
        raise NotImplementedError("a conv3x3-kernel layer split over the model axis is not ported")


def conv3x3_bf16_conv2d(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`conv2d(..., relu=True, compute_dtype=bf16)` of a 64 -> 64 3x3 layer
    with the convolution and its dgrad on the conv3x3 kernel (float32 NHWC
    out, as conv2d): the trunk's conv1_2 below 128 rows, where the JAX trunk
    runs the plain conv2d (`backbone.py:69-76`)."""
    _refuse_split(weight)
    return _Conv3x3F32Bias.apply(x.to(torch.bfloat16).contiguous(), weight, bias)


def conv3x3_bf16_bias_relu(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The trunk's bf16 3x3 branch (`layers.py:conv3x3_manual_bwd`): a bf16
    convolution, then the bias added in bf16, then ReLU; the output stays
    bf16. The convolution and its dgrad run on the conv3x3 kernel. The cast
    to bf16 sits outside the autograd function, as in JAX, so dx comes back
    in the caller's dtype."""
    _refuse_split(weight)
    return _Conv3x3MB.apply(x.to(torch.bfloat16).contiguous(), weight, bias)


def max_pool(x: torch.Tensor, k: int = 2, stride: int = 2) -> torch.Tensor:
    """SAME max pool. For k == stride, SAME pads only past the end, which is
    what `ceil_mode=True` does."""
    if k != stride:
        raise NotImplementedError("max_pool supports k == stride only")
    return _nhwc(F.max_pool2d(_nchw(x), k, stride, ceil_mode=True))


def avg_pool(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """SAME average pool (`layers.py:avg_pool`): each window's mean over its
    pixels inside the map (`same_pads`' padding is not counted)."""
    (t, b), (lft, r) = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k, stride)
    pad = (lft, r, t, b)
    total = F.avg_pool2d(F.pad(_nchw(x), pad), k, stride, divisor_override=1)
    ones = torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype, device=x.device)
    count = F.avg_pool2d(F.pad(ones, pad), k, stride, divisor_override=1)
    return _nhwc(total / count)


def make_deconv_filter(k: int, channels: int) -> np.ndarray:
    """Bilinear upsampling filter, layout (k, k, c_o, c_i), diagonal in
    channels (`layers.py:make_deconv_filter`)."""
    f = math.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    bilinear = np.zeros((k, k))
    for x in range(k):
        for y in range(k):
            bilinear[x, y] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
    weights = np.zeros((k, k, channels, channels), dtype=np.float32)
    for i in range(channels):
        weights[:, :, i, i] = bilinear
    return weights


def bilinear_matrix(n_in: int, k: int, stride: int) -> np.ndarray:
    """Dense (n_in*stride, n_in) 1-D interpolation matrix of a TF SAME
    bilinear transposed convolution (`layers.py:_bilinear_matrix`): the 2-D
    filter of `make_deconv_filter` is the outer product of this 1-D one."""
    f = math.ceil(k / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    k1 = [1 - abs(t / f - c) for t in range(k)]
    lo = max(k - stride, 0) // 2
    n_out = n_in * stride
    m = np.zeros((n_out, n_in), np.float32)
    for j in range(n_in):
        for t in range(k):
            o = j * stride - lo + t
            if 0 <= o < n_out:
                m[o, j] = k1[t]
    return m


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, k: int, stride: int, device: torch.device) -> torch.Tensor:
    # cached on the device: a fresh host-to-device copy per call would stall
    # the stream behind the work already queued. Made outside inference mode:
    # a cached inference tensor, made by a first call under
    # torch.inference_mode, could not be saved for a later backward.
    with torch.inference_mode(False):
        return torch.from_numpy(bilinear_matrix(n_in, k, stride)).to(device)


def deconv(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Fixed bilinear transposed convolution (TF SAME), NHWC.

    Factorized as in `layers.py:deconv`: two matrix products against the
    per-axis interpolation matrices (a plain product, outside any kernel).
    """
    B, H, W, C = x.shape
    mh = _interp_matrix(H, k, stride, x.device).to(x.dtype)
    mw = _interp_matrix(W, k, stride, x.device).to(x.dtype)
    y = torch.matmul(mh, x.reshape(B, H, W * C))  # (B, Ho, W*C)
    Ho = y.shape[1]
    y = torch.matmul(mw, y.reshape(B * Ho, W, C))  # (B*Ho, Wo, C)
    return y.reshape(B, Ho, W * stride, C)


def conv1x1_upsample(
    weight: torch.Tensor,
    bias: Optional[torch.Tensor],
    x: torch.Tensor,
    k: int,
    stride: int,
    relu: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """`conv1x1(deconv(x))` computed as `deconv(conv1x1(x)) + bias`, then
    ReLU (`layers.py:conv1x1_upsample`): the two linear maps commute, so the
    channel reduction runs at low resolution."""
    y = conv2d(weight, None, x, relu=False, compute_dtype=compute_dtype)
    y = deconv(y, k, stride)
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def fc(
    weight: torch.Tensor,
    bias: torch.Tensor,
    x: torch.Tensor,
    relu: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Dense layer; a 4-D input is flattened in NHWC order (`layers.py:fc`)."""
    if x.dim() == 4:
        x = x.reshape(x.shape[0], -1)
    mesh = tp_mesh(weight)
    if mesh is not None:
        x = copy_to_model(x, mesh)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        weight = weight.to(compute_dtype)
    y = F.linear(x, weight).float()
    if mesh is not None:
        y = gather_from_model(y, mesh, -1)
    y = y + bias
    if relu:
        y = torch.relu(y)
    return y


def dropout(
    x: torch.Tensor,
    keep_prob: float,
    generator: Optional[torch.Generator] = None,
    uniform: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tf.nn.dropout (`layers.py:dropout`): keeps x / keep_prob where a
    U[0,1) draw is below keep_prob, else 0. The draws come from `generator`
    (on x's device), or are handed in as `uniform` (a replayed step)."""
    if keep_prob >= 1.0:
        return x
    if uniform is None:
        uniform = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(uniform < keep_prob, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def softmax_hd(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def log_softmax_hd(x: torch.Tensor) -> torch.Tensor:
    d = x - x.amax(dim=-1, keepdim=True)
    return d - torch.log(torch.exp(d).sum(dim=-1, keepdim=True))


def argmax_2d(x: torch.Tensor) -> torch.Tensor:
    """Argmax over channels of (B,H,W,C); the first maximum wins on ties."""
    return torch.argmax(x, dim=3).to(torch.int32)


def l2_normalize(x: torch.Tensor, dim: int = 1, eps: float = 1e-12) -> torch.Tensor:
    """tf.nn.l2_normalize: x * rsqrt(max(sum(x^2), eps))."""
    sq = (x * x).sum(dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))
