"""K7 (csrc/pair.cu)'s share of its roofline in the gradient calls.

Reads the device kernels named ``pair_kernel`` (df/dx and df/dy of a field
in one launch) in the traced sub-window, one a call, against the gradient
pair's launch counter. Least work of a launch: one read, two writes (12
bytes a point), 52 operations a point.
"""

import re

from ..counts import BYTES_PER_POINT, FLOPS_PER_POINT
from ..readers import single_kernel_share

COUNTER = ("pair", "GRADIENT_LAUNCHES", None)
PATTERN = re.compile(r"\bpair_kernel\b")


def read(r):
    return single_kernel_share(r, "k7_roofline_pct", PATTERN,
                               BYTES_PER_POINT["gradient_pair"] * r.points,
                               FLOPS_PER_POINT["gradient_pair"] * r.points, per_unit=1)
