"""K1 (csrc/compact_lane.cu)'s share of its roofline in the dfdx calls.

Reads the device kernels named ``compact_lane_kernel`` in the traced
sub-window, one a call, against K1's launch counter in derivative mode.
Least work of a launch: the field read once and the derivative written
once (8 bytes a point), 26 operations a point.
"""

import re

from ..counts import BYTES_PER_POINT, FLOPS_PER_POINT
from ..readers import single_kernel_share

COUNTER = ("lane", "MODE_LAUNCHES", "derivative")
PATTERN = re.compile(r"\bcompact_lane_kernel\b")


def read(r):
    return single_kernel_share(r, "k1_roofline_pct", PATTERN,
                               BYTES_PER_POINT["compact_lane"] * r.points,
                               FLOPS_PER_POINT["compact_lane"] * r.points, per_unit=1)
