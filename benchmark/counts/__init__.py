"""The yardstick's arithmetic: the H100's published peaks, the least time a
kernel could take (`bound_s`), the vote and conv3x3 kernels' bounds, and
the model FLOPs of a training step.

Every count is of the work the algorithm needs at the cell's shapes, not
of what an implementation happens to do, so a later kernel that does less
work reads against the same yardstick.
"""

from benchmark.counts.peaks import PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S, PEAK_F32_FLOP_PER_S, bound_s
from benchmark.counts.kernels import VOTE_TEST_OPS, conv_bound, vote_bound, vote_bytes, vote_pairs
from benchmark.counts.flops import posecnn_step_flops, trunk_layers, video_step_flops

__all__ = [
    "PEAK_BF16_FLOP_PER_S", "PEAK_BYTES_PER_S", "PEAK_F32_FLOP_PER_S", "VOTE_TEST_OPS", "bound_s", "conv_bound",
    "posecnn_step_flops", "trunk_layers", "video_step_flops", "vote_bound", "vote_bytes", "vote_pairs",
]
