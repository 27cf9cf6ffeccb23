"""Device ms a traced step of the kernels launched under the
`bench:proposals` span: the detection network's anchor targets, proposal
layer (decode, top-k, the NMS kernel, the first kept) and proposal targets
(the workload's span map names what it wraps)."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    us = tr.owned_us(["bench:proposals"])
    return us / 1e3 / tr.steps if us > 0 else None
