"""Hough vote accumulation: the CUDA kernel's wrapper and its plain version.

Port of `posecnn_tpu/ops/pallas/voting.py`. The TPU kernel `_vote_kernel`
becomes `posecnn_torch/csrc/hough_vote.cu`, built at first use by
`posecnn_torch/_build.py` and called through ctypes.

Layout (as in the JAX package):
  samples (S, 8, P) f32 rows: px, py, u, v, depth, box_thr, (t*|uv|)^2, valid
  centers (1, 2, NC) f32 (one grid shared by every slot: the coarse grid) or
          (S, 2, NC) f32 (one set per slot: the refine window)
  returns votes (S, NC) f32 and dsum (S, NC) f32

No centre padding is needed: the kernel bounds-checks NC itself, where the
TPU kernel padded NC to its block with centres at -1e9. `grid_w`, the width
of a row-major centre grid (the coarse pass's), lets the kernel tile the
grid in 2-D, which prunes more samples a block; the result does not depend
on it, and the plain version ignores it.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Kernel launches by `accumulate_votes` since the count was last reset.
VOTE_LAUNCHES = 0

# centres per chunk of the plain version: bounds its (S, chunk, P) temporaries
_PLAIN_ELEMS = 1 << 24


def accumulate_votes_plain(samples: torch.Tensor, centers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch broadcast-reduce, the math of `_votes_jax`.

    Chunked over centres only, so every (slot, centre) sum runs over all P
    samples in one reduction, as in the JAX reference.
    """
    px, py, u, v, d, thr, tsq, val = [samples[:, i, :, None] for i in range(8)]  # (S,P,1)
    S, _, P = samples.shape
    nc = centers.shape[2]
    chunk = max(1, _PLAIN_ELEMS // max(1, S * P))
    votes, dsum = [], []
    for c0 in range(0, nc, chunk):
        cx = centers[:, 0, None, c0:c0 + chunk]  # (Sc,1,n)
        cy = centers[:, 1, None, c0:c0 + chunk]
        dx = cx - px  # (S,P,n)
        dy = cy - py
        dot = u * dx + v * dy
        n2sq = dx * dx + dy * dy
        ok = (
            (dot > 0.0)
            & (dot * dot > tsq * n2sq)
            & (dx.abs() < thr)
            & (dy.abs() < thr)
            & (val > 0.0)
        )
        okf = ok.to(torch.float32)
        votes.append(okf.sum(dim=1))
        dsum.append((okf * d).sum(dim=1))
    return torch.cat(votes, dim=1), torch.cat(dsum, dim=1)


def _check(samples: torch.Tensor, centers: torch.Tensor, grid_w: int) -> None:
    if samples.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"accumulate_votes takes float32, got {samples.dtype} and {centers.dtype}")
    if samples.dim() != 3 or samples.shape[1] != 8:
        raise ValueError(f"samples must be (S, 8, P), got {tuple(samples.shape)}")
    if centers.dim() != 3 or centers.shape[1] != 2 or centers.shape[0] not in (1, samples.shape[0]):
        raise ValueError(
            f"centers must be (1, 2, NC) or (S, 2, NC) with S={samples.shape[0]}, got {tuple(centers.shape)}"
        )
    if samples.device != centers.device:
        raise ValueError(f"samples on {samples.device}, centers on {centers.device}")
    if not (samples.is_contiguous() and centers.is_contiguous()):
        raise ValueError("accumulate_votes takes contiguous tensors")
    if not isinstance(grid_w, int) or grid_w < 0:
        raise ValueError(f"grid_w must be an int >= 0, got {grid_w!r}")


def _launch(samples: torch.Tensor, centers: torch.Tensor, grid_w: int = 0,
            split: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream; counts the launch.
    `split` is the kernel's number of sample chunks (1, 2, 4 or 8), 0 to let
    it choose; the votes do not depend on it."""
    global VOTE_LAUNCHES
    from posecnn_torch._build import hough_vote_lib

    S, _, P = samples.shape
    nc = centers.shape[2]
    votes = torch.empty((S, nc), dtype=torch.float32, device=samples.device)
    dsum = torch.empty_like(votes)
    lib = hough_vote_lib()
    with torch.cuda.device(samples.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hough_vote_launch(
            samples.data_ptr(), centers.data_ptr(), votes.data_ptr(), dsum.data_ptr(),
            S, P, nc, int(centers.shape[0] != 1), grid_w, split, stream,
        )
    if err != 0:
        raise RuntimeError(f"hough_vote_launch failed: CUDA error {err}")
    VOTE_LAUNCHES += 1
    return votes, dsum


def accumulate_votes(samples: torch.Tensor, centers: torch.Tensor,
                     grid_w: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """votes/dsum (S, NC). A CUDA tensor goes to the kernel (or raises); a CPU
    tensor goes to the plain version. `grid_w`: the width of the row-major
    centre grid, 0 for none (module docstring)."""
    _check(samples, centers, grid_w)
    if samples.device.type == "cuda":
        return _launch(samples, centers, grid_w)
    if samples.device.type == "cpu":
        return accumulate_votes_plain(samples, centers)
    raise ValueError(f"accumulate_votes: unsupported device {samples.device}")
