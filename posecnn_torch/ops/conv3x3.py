"""Fused 3x3 convolution: the CUDA kernel's wrapper, its plain version, and
the convolution with its backward.

Port of `posecnn_tpu/ops/pallas/conv3x3.py`. The TPU kernel `_conv_kernel`
becomes `posecnn_torch/csrc/conv3x3.cu`, built at first use by
`posecnn_torch/_build.py` and called through ctypes. `conv3x3_raw` has the
Pallas kernel's interface (`_conv3x3_pallas_raw`):

  x (B, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO, b (Cout,) f32
  -> relu?(sum over the 9 taps of x_shift @ w_tap + b), summed in f32 and
     rounded once to bf16, (B, H, W, Cout)

`conv3x3_bias_relu` is the Pallas module's custom_vjp as a
`torch.autograd.Function`, on the port's OIHW weights: the kernel forward,
and the backward of `_conv3x3_bwd` (the ReLU mask from the saved output, dx
by the same kernel on flipped, transposed weights with zero bias, dw as nine
shifted tall-K contractions, db as a sum). `conv3x3_vjp` is shared with
`models.layers.conv3x3_bf16_bias_relu`, which runs the trunk's conv1_2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Kernel launches by `conv3x3_raw` since the count was last reset.
CONV3X3_LAUNCHES = 0


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """The kernel's math in plain PyTorch: the nine taps as f32 products of
    the bf16-valued operands, summed in f32, plus the bias, ReLU, one
    rounding to bf16."""
    B, H, W, Cin = x.shape
    Cout = w.shape[3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, Cin) @ wf[dy, dx]
            acc = tap if acc is None else acc + tap
    y = acc + b.float()
    if relu:
        y = torch.relu(y)
    return y.to(torch.bfloat16).reshape(B, H, W, Cout)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or b.dtype != torch.float32:
        raise TypeError(f"conv3x3 takes bf16 x and w and an f32 bias, got {x.dtype}, {w.dtype}, {b.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3 takes x (B,H,W,Cin) and w (3,3,Cin,Cout), got {tuple(x.shape)}, {tuple(w.shape)}")
    if b.shape != (w.shape[3],):
        raise ValueError(f"bias must be ({w.shape[3]},), got {tuple(b.shape)}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"x on {x.device}, w on {w.device}, b on {b.device}")


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; counts the launch."""
    global CONV3X3_LAUNCHES
    from posecnn_torch._build import conv3x3_lib

    B, H, W, Cin = x.shape
    Cout = w.shape[3]
    if Cin % 16 or not 16 <= Cin <= 128 or Cout % 64:
        raise ValueError(f"the conv3x3 kernel takes Cin a multiple of 16 in [16, 128] and Cout a multiple of 64, "
                         f"got {Cin} -> {Cout}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    y = torch.empty((B, H, W, Cout), dtype=torch.bfloat16, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, w, y)):
        raise ValueError("the conv3x3 kernel reads and writes 16-byte vectors: x, w and y must be 16-byte aligned")
    lib = conv3x3_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3x3_launch(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), B, H, W, Cin, Cout, int(relu), stream
        )
    if err != 0:
        raise RuntimeError(f"conv3x3_launch failed: CUDA error {err}")
    CONV3X3_LAUNCHES += 1
    return y


def conv3x3_raw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv + bias + optional ReLU, bf16 out (w HWIO). A
    CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
    plain version."""
    _check(x, w, b)
    if x.device.type == "cuda":
        return _launch(x, w, b, relu)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b, relu)
    raise ValueError(f"conv3x3: unsupported device {x.device}")


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """dgrad weights (`conv3x3.py:_flip_transpose`): spatial flip and in/out
    transpose of HWIO weights."""
    return torch.flip(w, dims=(0, 1)).transpose(2, 3).contiguous()


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
    by the kernel on flipped, transposed weights with zero bias and no ReLU,
    dw by `conv3x3_wgrad`, db as a sum. A gradient not needed is None."""
    dx = dw = db = None
    if needs_input_grad[0]:
        zeros = torch.zeros((xb.shape[-1],), dtype=torch.float32, device=g.device)
        dx = conv3x3_raw(g.contiguous(), flip_transpose(wb), zeros, False)
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
        wb = oihw_to_hwio(w).to(torch.bfloat16).contiguous()
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
