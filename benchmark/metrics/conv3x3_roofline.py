"""The conv3x3 kernel's share of its roofline, %: the traced launches'
bounds (counts/kernels.py: conv_bound at the cell's conv1_2 shape, the
forward and the dgrad alike) over the traced `conv3x3_kernel` times."""

from benchmark.counts import conv_bound


def read(run):
    tr = run.trace
    if tr is None:
        return None
    kernels = [k for k in tr.kernels if "conv3x3_kernel" in k.name]
    if not kernels:
        return None
    bound = conv_bound(*run.cell.conv3x3_shape())[0]
    return 100.0 * bound * len(kernels) / (sum(k.dur for k in kernels) * 1e-6)
