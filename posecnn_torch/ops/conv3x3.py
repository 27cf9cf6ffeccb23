"""Fused 3x3 convolution: the CUDA kernel's wrapper, its plain version, and
the convolution with its backward.

Port of `posecnn_tpu/ops/pallas/conv3x3.py`. The TPU kernel `_conv_kernel`
becomes `posecnn_torch/csrc/conv3x3.cu` (wgmma fed by TMA on a persistent
grid), built at first use by `posecnn_torch/_build.py` and called through
ctypes. `conv3x3_raw` has the Pallas kernel's interface
(`_conv3x3_pallas_raw`):

  x (B, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO, b (Cout,) f32
  -> relu?(sum over the 9 taps of x_shift @ w_tap + b), summed in f32 and
     rounded once to bf16, (B, H, W, Cout)

and one more epilogue, the trunk's (`bf16_bias=True`): the sum rounded to
bf16, the bias added in bf16, then ReLU. `conv3x3_dgrad` is the same kernel
on the flipped, transposed weights with no bias (dx of the convolution).

`conv3x3_bias_relu` is the Pallas module's custom_vjp as a
`torch.autograd.Function`, on the port's OIHW weights: the kernel forward,
and the backward of `_conv3x3_bwd` (the ReLU mask from the saved output, dx
by `conv3x3_dgrad`, dw as nine shifted tall-K contractions, db as a sum).
`conv3x3_vjp` is shared with `models.layers.conv3x3_bf16_bias_relu`, which
runs the trunk's conv1_2.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# Kernel launches by `conv3x3_raw` and `conv3x3_dgrad` since the count was last reset.
CONV3X3_LAUNCHES = 0

_FLAG_RELU, _FLAG_BF16_BIAS = 1, 2


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool,
                  bf16_bias: bool = False) -> torch.Tensor:
    """The kernel's math in plain PyTorch: the nine taps as f32 products of
    the bf16-valued operands, summed in f32, then the bias, ReLU and one
    rounding to bf16; with `bf16_bias`, the sum rounded to bf16 first and the
    bias added in bf16 (the trunk's conv1_2)."""
    B, H, W, Cin = x.shape
    Cout = w.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, Cin) @ wf[dy, dx]
            acc = tap if acc is None else acc + tap
    if bf16_bias:
        y = acc.to(torch.bfloat16) + b.to(torch.bfloat16)
        y = torch.relu(y) if relu else y
    else:
        y = acc + b.float()
        y = (torch.relu(y) if relu else y).to(torch.bfloat16)
    return y.reshape(B, H, W, Cout)


@functools.lru_cache(maxsize=32)
def _pack_index(cin: int, cout: int, dgrad: bool, device: torch.device) -> torch.Tensor:
    """Flat indices into HWIO weights (3, 3, cin, cout) of every slot of the
    kernel's weight image (see `pack_weights`). Made outside inference mode,
    so a first call under torch.inference_mode caches a tensor that later
    training can use."""
    with torch.inference_mode(False):
        n_in, n_out = (cout, cin) if dgrad else (cin, cout)  # the channels of the convolution run
        ar = torch.arange
        cb = ar(n_out // 64).view(-1, 1, 1, 1, 1, 1)
        tap = ar(9).view(1, -1, 1, 1, 1, 1)
        kb = ar(n_in // 64).view(1, 1, -1, 1, 1, 1)
        n = ar(64).view(1, 1, 1, -1, 1, 1)
        chunk = ar(8).view(1, 1, 1, 1, -1, 1)
        e = ar(8).view(1, 1, 1, 1, 1, -1)
        k = kb * 64 + (chunk ^ (n % 8)) * 8 + e  # the input channel held in this 128-byte-swizzled slot
        o = cb * 64 + n
        # dgrad weights flip_transpose(w)[tap, k, o] = w[8 - tap, o, k]
        idx = ((8 - tap) * cin + o) * cout + k if dgrad else (tap * cin + k) * cout + o
        return idx.reshape(n_out // 64, 9, n_in // 64, 64, 64).to(device)


def pack_weights(w: torch.Tensor, dgrad: bool = False) -> torch.Tensor:
    """The kernel's weight image of HWIO weights w (3, 3, Cin, Cout), as
    bf16 (Cout/64, 9, Cin/64, 64, 64): for each block of 64 output channels,
    tap and block of 64 input channels, B^T (64 out x 64 in), K-major, with
    the 16-byte chunk c of row n stored at chunk c ^ (n % 8), which is the
    128-byte swizzle that wgmma's descriptor reads. With `dgrad`, the image
    of `flip_transpose(w)` (the channels swap: Cout/64 blocks of K), made in
    the same gather."""
    cin, cout = w.shape[2], w.shape[3]
    idx = _pack_index(cin, cout, dgrad, w.device)
    return torch.take(w, idx).to(torch.bfloat16)


def _check(x: torch.Tensor, w: torch.Tensor, b=None) -> None:
    """x (B,H,W,Cin) and w (3,3,Cin,Cout) bf16, b (Cout,) f32 or None, all on one device."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or (b is not None and b.dtype != torch.float32):
        raise TypeError(f"conv3x3 takes bf16 x and w and an f32 bias, got {x.dtype}, {w.dtype}, "
                        f"{None if b is None else b.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 takes x (B,H,W,Cin) and w (3,3,Cin,Cout), got {tuple(x.shape)}, {tuple(w.shape)}")
    if b is not None and b.shape != (w.shape[3],):
        raise ValueError(f"bias must be ({w.shape[3]},), got {tuple(b.shape)}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError(f"x on {x.device}, w on {w.device}, b on {None if b is None else b.device}")


def _kernel_channels(cin: int, cout: int) -> None:
    if cin not in (64, 128) or cout not in (64, 128):
        raise ValueError(f"the conv3x3 kernel takes Cin and Cout of 64 or 128, got {cin} -> {cout}")


def _launch(x: torch.Tensor, wp: torch.Tensor, b, flags: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream with the weight image
    `wp` (`pack_weights`) and the bias `b` (f32, or None for zero); counts
    the launch."""
    global CONV3X3_LAUNCHES
    from posecnn_torch._build import conv3x3_lib

    B, H, W, Cin = x.shape
    Cout = wp.shape[0] * 64
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the conv3x3 kernel's tensor map needs x 16-byte aligned")
    y = torch.empty((B, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    b = None if b is None else b.contiguous()
    with torch.cuda.device(x.device):
        err = conv3x3_lib().conv3x3_launch(x.data_ptr(), wp.data_ptr(), None if b is None else b.data_ptr(),
                                           y.data_ptr(), B, H, W, Cin, Cout, flags,
                                           torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_launch failed: CUDA error {err}")
    CONV3X3_LAUNCHES += 1
    return y


def conv3x3_raw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool,
                bf16_bias: bool = False) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv + bias + optional ReLU, bf16 out (w HWIO); with
    `bf16_bias`, the bias is added in bf16 after the sum's rounding. A CUDA
    tensor goes to the kernel (or raises); a CPU tensor goes to the plain
    version."""
    _check(x, w, b)
    if x.device.type == "cuda":
        _kernel_channels(w.shape[2], w.shape[3])
        return _launch(x, pack_weights(w), b, (_FLAG_RELU if relu else 0) | (_FLAG_BF16_BIAS if bf16_bias else 0))
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu, bf16_bias)
    raise ValueError(f"conv3x3: unsupported device {x.device}")


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights (`conv3x3.py:_flip_transpose`): spatial flip and in/out
    transpose of HWIO weights."""
    return torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()


def conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (B, H, W, Cin) bf16 of a stride-1 SAME 3x3 conv with HWIO bf16
    weights w (3, 3, Cin, Cout) for the bf16 cotangent g (B, H, W, Cout): the
    same convolution of g with `flip_transpose(w)`, no bias, no ReLU. A CUDA
    tensor goes to the kernel (the flip folded into the weight image), a CPU
    tensor to the plain version."""
    _check(g, w.transpose(2, 3))
    if g.device.type == "cuda":
        _kernel_channels(w.shape[3], w.shape[2])
        return _launch(g, pack_weights(w, dgrad=True), None, 0)
    if g.device.type == "cpu":
        return conv3x3_plain(g, flip_transpose(w), torch.zeros((w.shape[2],)), False)
    raise ValueError(f"conv3x3: unsupported device {g.device}")


def conv3x3_wgrad(xb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw (3, 3, Cin, Cout) f32 of a stride-1 SAME 3x3 conv: per tap, the
    shifted input contracted with the cotangent over every pixel (a tall-K
    product outside the kernel, as JAX leaves it to XLA). Both operands hold
    bf16 values, so their f32 products are exact."""
    B, H, W, Cin = xb.shape
    xp = F.pad(xb.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float().reshape(-1, g.shape[-1])
    rows = []
    for dy in range(3):
        rows.append(torch.stack([xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, Cin).t() @ gf for dx in range(3)]))
    return torch.stack(rows)


def oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0)


def conv3x3_vjp(xb: torch.Tensor, wb: torch.Tensor, g: torch.Tensor, needs_input_grad):
    """(dx, dw OIHW, db) of a stride-1 SAME 3x3 conv for the bf16 cotangent
    `g` (the ReLU mask already applied), as `_conv3x3_bwd` computes them: dx
    by `conv3x3_dgrad`, dw by `conv3x3_wgrad`, db as a sum. A gradient not
    needed is None."""
    dx = dw = db = None
    if needs_input_grad[0]:
        dx = conv3x3_dgrad(g, wb)
    if needs_input_grad[1]:
        dw = conv3x3_wgrad(xb, g).permute(3, 2, 0, 1)
    if needs_input_grad[2]:
        db = g.float().sum(dim=(0, 1, 2))
    return dx, dw, db


class Conv3x3BiasRelu(torch.autograd.Function):
    """`conv3x3.py:conv3x3_bias_relu` (custom_vjp) on the port's weights."""

    @staticmethod
    def forward(ctx, x, w, b, relu: bool):
        xb = x.to(torch.bfloat16)
        wb = oihw_to_hwio(w).to(torch.bfloat16)
        y = conv3x3_raw(xb, wb, b.float(), relu)
        ctx.save_for_backward(xb, wb, y)
        ctx.relu = relu
        return y

    @staticmethod
    def backward(ctx, g):
        xb, wb, y = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        return (*conv3x3_vjp(xb, wb, g, ctx.needs_input_grad), None)


def conv3x3_bias_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + optional ReLU, bf16 in and out, f32
    accumulation. x (B,H,W,Cin); w (Cout,Cin,3,3) OIHW, any float (cast to
    bf16); b (Cout,) f32. Returns (B,H,W,Cout) bf16."""
    return Conv3x3BiasRelu.apply(x, w, b, relu)
