"""K2 (csrc/compact_strided.cu)'s share of its roofline in the gradient
calls, where it takes df/dz.

Reads the device kernels named ``compact_strided_kernel`` in the traced
sub-window, one a call, against K2's launch counter in derivative mode.
Least work of a launch: 8 bytes and 26 operations a point.
"""

import re

from ..counts import BYTES_PER_POINT, FLOPS_PER_POINT
from ..readers import single_kernel_share

COUNTER = ("strided", "MODE_LAUNCHES", "derivative")
PATTERN = re.compile(r"\bcompact_strided_kernel\b")


def read(r):
    return single_kernel_share(r, "k2_roofline_pct", PATTERN,
                               BYTES_PER_POINT["compact_strided"] * r.points,
                               FLOPS_PER_POINT["compact_strided"] * r.points, per_unit=1)
