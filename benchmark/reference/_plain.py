"""Plain PyTorch pieces both references share: NHWC convolutions, pooling,
the fixed bilinear upsampling, softmax, dropout, momentum SGD and the
weights' parameter specs. Float32 with TF32 off; no kernel of the
program, no cache, no batching tricks.

`Quant` is the control's lower precision, fp8 training as it is usually
done: every convolution and dense layer takes its input and its weights
rounded to float8 e4m3, and in the backward the gradient of its output
rounded to float8 e5m2, each with one scale a tensor (its amax mapped to
the format's largest value).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _GradE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def strict_float32() -> None:
    """Float32 products and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Quant:
    """The operand rounding of convolutions and dense layers: None (float32)
    or "fp8" (e4m3, a per-tensor scale)."""

    def __init__(self, mode: Optional[str] = None):
        if mode not in (None, "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """An operand, rounded (straight through in the backward)."""
        if self.mode is None:
            return x
        return x + (_round(x.detach(), torch.float8_e4m3fn, E4M3_MAX) - x).detach()

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output: its gradient rounded in the backward."""
        return y if self.mode is None else _GradE5M2.apply(y)


F32 = Quant(None)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(w: torch.Tensor, b: Optional[torch.Tensor], x: torch.Tensor, relu: bool, q: Quant = F32) -> torch.Tensor:
    """Stride-1 SAME convolution of an odd kernel, NHWC; w is OIHW."""
    y = nhwc(q.out(F.conv2d(nchw(q(x)), q(w), padding=w.shape[-1] // 2)))
    if b is not None:
        y = y + b
    return torch.relu(y) if relu else y


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool at stride 2, SAME (the odd row or column pooled alone)."""
    return nhwc(F.max_pool2d(nchw(x), 2, 2, ceil_mode=True))


def bilinear_matrix(n_in: int, k: int, stride: int) -> np.ndarray:
    """(n_in * stride, n_in) 1-D weights of a TF SAME bilinear transposed
    convolution of size k (the FCN upsampling filter's separable factor)."""
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


def upsample(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """The fixed bilinear upsampling (B,H,W,C) -> (B,H*s,W*s,C)."""
    B, H, W, C = x.shape
    mh = torch.from_numpy(bilinear_matrix(H, k, stride)).to(x.device)
    mw = torch.from_numpy(bilinear_matrix(W, k, stride)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x)
    return torch.einsum("pw,bowc->bopc", mw, y)


def linear(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor, relu: bool, q: Quant = F32) -> torch.Tensor:
    """Dense layer; a 4-D input is flattened in NHWC order."""
    if x.dim() == 4:
        x = x.reshape(x.shape[0], -1)
    y = q.out(q(x) @ q(w).t()) + b
    return torch.relu(y) if relu else y


def dropout(x: torch.Tensor, keep: float, u: torch.Tensor) -> torch.Tensor:
    """x / keep where the U[0,1) draw u < keep, else 0."""
    if keep >= 1.0:
        return x
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def cross_entropy_onehot(logp: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy over the one-hot mass (+1e-10)."""
    return -(onehot * logp).sum() / (onehot.sum() + 1e-10)


def l2_term(params: Dict[str, torch.Tensor], weight_reg: float) -> torch.Tensor:
    """weight_reg * sum(p^2) / 2 over every parameter."""
    return weight_reg * 0.5 * sum((p * p).sum() for p in params.values())


# --------------------------------------------------------------- parameters


def he_std(shape: Sequence[int]) -> float:
    """sqrt(2 / fan_in) of an OIHW conv or (out, in) dense weight."""
    fan_in = int(np.prod(shape[1:]))
    return math.sqrt(2.0 / fan_in)


def conv_spec(name: str, ci: int, co: int, k: int, std: Optional[float] = None) -> List[Tuple[str, Tuple, float]]:
    shape = (co, ci, k, k)
    return [(name + ".weight", shape, he_std(shape) if std is None else std), (name + ".bias", (co,), 0.0)]


def fc_spec(name: str, ci: int, co: int, std: Optional[float] = None) -> List[Tuple[str, Tuple, float]]:
    shape = (co, ci)
    return [(name + ".weight", shape, he_std(shape) if std is None else std), (name + ".bias", (co,), 0.0)]


VGG16 = [
    ("conv1_1", 3, 64, False), ("conv1_2", 64, 64, True),
    ("conv2_1", 64, 128, False), ("conv2_2", 128, 128, True),
    ("conv3_1", 128, 256, False), ("conv3_2", 256, 256, False), ("conv3_3", 256, 256, True),
    ("conv4_1", 256, 512, False), ("conv4_2", 512, 512, False), ("conv4_3", 512, 512, True),
    ("conv5_1", 512, 512, False), ("conv5_2", 512, 512, False), ("conv5_3", 512, 512, False),
]


def scaled(c: int, scale: float) -> int:
    """A channel width under a width multiplier (min 8, a multiple of 8);
    the cells run at 1.0, the CPU tests at less."""
    if scale >= 1.0:
        return c
    return max(8, int(round(c * scale / 8)) * 8)


def trunk_defs(scale: float = 1.0) -> List[Tuple[str, int, int, bool]]:
    return [(n, ci if ci == 3 else scaled(ci, scale), scaled(co, scale), pool) for n, ci, co, pool in VGG16]


def trunk_specs(prefix: str, scale: float, input_std: float = 1.0) -> List[Tuple[str, Tuple, float]]:
    """He init; the first layer's std divided by the input's std, so that
    a layer's output starts at the scale He init assumes of its input."""
    out = []
    for name, ci, co, _ in trunk_defs(scale):
        std = he_std((co, ci, 3, 3)) / (input_std if ci == 3 else 1.0)
        out += conv_spec(f"{prefix}{name}", ci, co, 3, std)
    return out


def trunk(params: Dict[str, torch.Tensor], x: torch.Tensor, scale: float, q: Quant = F32,
          prefix: str = "trunk.") -> Dict[str, torch.Tensor]:
    """VGG16 conv1_1 .. conv5_3 with ReLUs and four 2x2 pools."""
    out, h = {}, x
    for name, _, _, pool in trunk_defs(scale):
        h = conv2d(params[f"{prefix}{name}.weight"], params[f"{prefix}{name}.bias"], h, True, q)
        out[name] = h
        if pool:
            h = max_pool2(h)
    return out


def make_weights(specs: Iterable[Tuple[str, Tuple, float]], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter from `seed` in one draw on `device`: a float32
    N(0, 1) vector of all the weights' elements, cut into the specs' shapes
    in order and scaled by each spec's std (biases at std 0 are zeros)."""
    specs = list(specs)
    sizes = [int(np.prod(s)) if std > 0 else 0 for _, s, std in specs]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=torch.float32)
    out, o = {}, 0
    for (name, shape, std), n in zip(specs, sizes):
        if n:
            out[name] = flat[o:o + n].view(shape) * std
        else:
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        o += n
    return out


class MomentumSGD:
    """Momentum SGD after global-norm clipping (clip 0: none): trace = g +
    momentum * trace; p -= lr * trace."""

    def __init__(self, params: Dict[str, torch.Tensor], momentum: float, clip: float):
        self.params = params
        self.momentum = momentum
        self.clip = clip
        self.trace = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = 1.0 if self.clip <= 0 or float(norm) < self.clip else self.clip / float(norm)
        for k, p in self.params.items():
            t = self.trace[k]
            t.mul_(self.momentum).add_(grads[k] * scale)
            p.add_(t, alpha=-lr)
        return float(norm)


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def train_steps(params: Dict[str, torch.Tensor], loss_fn, n_steps: int, lr, momentum: float,
                clip: float) -> Dict:
    """Run `loss_fn(params, step) -> (loss, terms, extra)` n_steps times with
    momentum SGD on `params` (updated in place). Returns the readings: each
    step's loss terms and gradient norm, the first gradient's norm a leaf
    as the optimizer took it (its trace after one step), the parameters'
    change a leaf after the n steps, and each step's `extra`."""
    p0 = {k: v.detach().clone() for k, v in params.items()}
    opt = MomentumSGD(params, momentum, clip)
    out = {"terms": [], "grad_norm": [], "extra": []}
    for s in range(n_steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss, terms, extra = loss_fn(leaves, s)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k])) for k, g in zip(leaves, grads)}
        out["grad_norm"].append(opt.step(grads, lr(s)))
        out["terms"].append(dict({k: float(v) for k, v in terms.items()}, grad_norm=out["grad_norm"][-1]))
        out["extra"].append(extra)
        if s == 0:
            out["grad1"] = leaf_norms(opt.trace)
    out["move"] = leaf_norms({k: params[k] - p0[k] for k in params})
    return out
