"""Device ms a traced step of the flow warp: the kernels under the
`bench:flow_warp` span (ops/compute_flow.py forward) and those of its
autograd node `_WindowMeanBackward` (the window mean's backward)."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    us = tr.owned_us(["bench:flow_warp", "autograd:_WindowMeanBackward"])
    return us / 1e3 / tr.steps if us > 0 else None
