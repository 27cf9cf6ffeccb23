"""Device ms a traced step of the kernels autograd's engine launched, by
the profiler's autograd nodes, but the flow warp's `_WindowMeanBackward`
(read by device_ms.flow_warp)."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    us = tr.autograd_us(exclude=["_WindowMeanBackward"])
    return us / 1e3 / tr.steps if us > 0 else None
