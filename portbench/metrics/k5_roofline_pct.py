"""K5 (csrc/adv_lap3.cu on xy_phase.cuh)'s share of its roofline in the
Navier-Stokes steps.

A launch of K5 is two device kernels: ``xy_y_kernel`` (the y phase, a
template that K6 shares) directly followed by the paired chained x phase
``xy_chain_x_kernel`` of kind XY_PAIR (K6's x phase is of kind XY_RHS).
Their durations are summed a launch; the launches are held against K5's
launch counter, three a step. Least work of a launch: three velocity
components read, axy and the z right-hand side of each written (36 bytes
a point), 381 operations a point.
"""

import re

from ..counts import BYTES_PER_POINT, FLOPS_PER_POINT, bound_s
from ..readers import kernel_share, paired

COUNTER = ("adv_lap", "LAUNCHES3", None)
Y_PHASE = re.compile(r"\bxy_y_kernel\b")
X_PHASE = re.compile(r"\bxy_chain_x_kernel<\d+, (2|XY_PAIR)>")  # XYChainKind XY_PAIR is 2


def read(r):
    bound = bound_s(BYTES_PER_POINT["adv_lap3"] * r.points, FLOPS_PER_POINT["adv_lap3"] * r.points)
    launches = [(bound, s) for s in paired(r.timeline.events, Y_PHASE, X_PHASE)]
    return kernel_share(r, "k5_roofline_pct", launches, 3 * r.traced_units)
