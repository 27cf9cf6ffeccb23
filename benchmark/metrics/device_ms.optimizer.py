"""Device ms a traced step of the kernels launched under the `bench:optimizer`
span (the workload's span map names what it wraps)."""


def read(run):
    tr = run.trace
    if tr is None or tr.steps == 0:
        return None
    us = tr.owned_us(["bench:optimizer"])
    return us / 1e3 / tr.steps if us > 0 else None
