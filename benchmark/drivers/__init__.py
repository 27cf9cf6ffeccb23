"""The program's paths the cells drive, one module a kind of step.

A driver's `Cell(spec, seed, device, log)` builds the program's training
step, its state, its Solver and its data from the seed, runs the check
steps through the Solver with the benchmark's draws, names the inputs the
reference needs, and plants the faults the calibration of the limits uses.
Only drivers import the program, and only inside their functions.
"""

import contextlib
from typing import Dict, List

import torch


def leaf_norms(named) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named}


def param_snapshot(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


@contextlib.contextmanager
def frozen_optimizer():
    """The fault "a step that returns its state unchanged": the update
    computes the gradient norm and moves nothing."""
    from posecnn_torch.engine import train as T

    orig = T.MomentumSGD.step

    @torch.no_grad()
    def step(self, lr):
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        return self.global_norm(grads)

    T.MomentumSGD.step = step
    try:
        yield
    finally:
        T.MomentumSGD.step = orig


def trace_leaves(state) -> List:
    """(name, momentum trace) of each parameter: after one step from a zero
    trace, the first gradient as the optimizer took it."""
    names = [k for k, _ in state.model.named_parameters()]
    return list(zip(names, state.optimizer.trace))
