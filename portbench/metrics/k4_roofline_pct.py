"""K4 (csrc/rk3_mega.cu)'s share of its roofline in the Navier-Stokes steps.

Reads the device kernels named ``rk3_mega_kernel``, nine a step (three
stages of three components, in that order), against K4's launch counter.
Least bytes of each launch from ``counts.k4_launch_bytes`` (by stage and
component: 20 to 28 bytes a point), 44 operations a point.
"""

import re

from ..counts import FLOPS_PER_POINT, bound_s, k4_launch_bytes
from ..readers import kernel_share

COUNTER = ("megastep", "LAUNCHES", None)
PATTERN = re.compile(r"\brk3_mega_kernel\b")


def read(r):
    flops = FLOPS_PER_POINT["rk3_mega"] * r.points
    bounds = [bound_s(k4_launch_bytes(r.points, s, c), flops) for s in range(3) for c in range(3)]
    events = r.timeline.matching(PATTERN)
    launches = [(bounds[i % 9], b - a) for i, (_, a, b) in enumerate(events)]
    return kernel_share(r, "k4_roofline_pct", launches, 9 * r.traced_units)
