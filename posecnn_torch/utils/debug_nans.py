"""TPU.DEBUG_NANS: stop at the first operation whose output holds a NaN.

The JAX package sets `jax_debug_nans` (`posecnn_tpu/core/config.py:385-389`).
JAX then checks every primitive it runs eagerly, a constant such as
`jnp.full((2,), jnp.nan)` included, and raises FloatingPointError at the
first whose output holds a NaN; an inf passes. A jitted function it checks
only at its outputs: where one holds a NaN, it runs the function again op
by op and raises at the first primitive whose output held one (a NaN that
never reaches the outputs, such as a 0/0 that a later select drops, raises
nothing).

The port's counterpart is a dispatch mode (`DebugNans`, entered by
`debug_nans()`): every aten operation's floating outputs are checked, in
the forward and in the backward (the autograd engine carries the mode into
its threads). Outside a region an operation raises at once, naming it.
The calls that the JAX package jits run as regions (`jitted`: the train
steps through `engine.train.Solver` and `make_video_train_step`, the
inference functions of `engine.test`, the ICP, the video step of
`test_net_video`): there each operation's NaN test is kept on the device,
and at the call's end its outputs (and, for a train step, the parameters it
updated) are read; where one holds a NaN, FloatingPointError names the
region's first operation whose output held one. The allocations that hold
no values yet (`empty` and its kin) and tensors on the meta device are not
checked.

The cost: two small kernels (isnan, any) for every floating output, and a
read back to the host at each operation outside a region and at each
region's end, where the card waits for the work queued before it.
`TPU.DEBUG_DISABLE_JIT` has nothing to do here: eager torch runs no jit.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

# allocations whose memory is not yet written
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "resize_", "set_"}


def _valued(t) -> bool:
    """A floating tensor that holds values (not one of shapes alone, on the
    meta device)."""
    return (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and t.numel() > 0
            and t.device.type != "meta")


def _any_nan(leaves) -> bool:
    """Whether a tensor, array or float of `leaves` holds a NaN (one read
    back a device)."""
    by_device = {}
    for x in leaves:
        if _valued(x):
            by_device.setdefault(x.device, []).append(torch.isnan(x).any())
        elif isinstance(x, np.ndarray) and x.dtype.kind in "fc" and np.isnan(x).any():
            return True
        elif isinstance(x, float) and x != x:
            return True
    return any(bool(torch.stack(v).any()) for v in by_device.values())


class DebugNans(TorchDispatchMode):
    """Raises FloatingPointError at the first aten operation with a NaN in a
    floating output (in a region, at its end, where its outputs hold one);
    counts the outputs it checked (`checked`)."""

    def __init__(self):
        super().__init__()
        self.checked = 0
        self._flags: Optional[List[Tuple[object, torch.Tensor]]] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNWRITTEN:
            return out
        for t in tree_leaves(out):
            if _valued(t):
                self.checked += 1
                nan = torch.isnan(t).any()
                if self._flags is not None:
                    self._flags.append((func, nan))
                elif bool(nan):
                    raise FloatingPointError(f"invalid value (nan) encountered in {func}")
        return out

    @contextlib.contextmanager
    def region(self, what: str):
        """A call checked at its outputs: yields `check(*outputs)`, which
        raises naming the region's first NaN operation where an output
        (tensors, arrays, floats, nested in dicts, lists or tuples) holds a
        NaN."""
        outer, self._flags = self._flags, []
        flags = self._flags

        def check(*outputs):
            if not _any_nan(tree_leaves(list(outputs))):
                return
            hit = torch.stack([f.cpu() for _, f in flags]) if flags else torch.zeros(0, dtype=torch.bool)
            first = int(torch.nonzero(hit)[0]) if bool(hit.any()) else None
            where = f"{flags[first][0]}" if first is not None else "an operation outside the dispatcher"
            raise FloatingPointError(f"invalid value (nan) encountered in {where} (the first NaN of {what}, "
                                     "whose outputs hold one)")

        try:
            yield check
        finally:
            self._flags = outer


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """The DEBUG_NANS scope (a no-op when not `enabled`); yields the mode
    (None when off)."""
    if not enabled:
        yield None
        return
    with DebugNans() as mode:
        yield mode


def jitted(fn: Callable, what: str, extra: Optional[Callable] = None) -> Callable:
    """`fn` checked as the JAX package checks a jitted function while a
    DEBUG_NANS scope is active (and called as it is otherwise): its return
    value, and `extra(*args)` (say, the parameters a step updates in place),
    at the call's end."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        # this thread's innermost DEBUG_NANS scope, if any
        mode = next((m for m in reversed(_get_current_dispatch_mode_stack()) if isinstance(m, DebugNans)), None)
        if mode is None:
            return fn(*args, **kwargs)
        with mode.region(what) as check:
            out = fn(*args, **kwargs)
            check(out, *(extra(*args) if extra is not None else ()))
        return out

    return call
