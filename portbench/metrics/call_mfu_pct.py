"""A whole derivative call's share of the card's roofline.

The least time one call needs, counted from the grid alone and not from
the kernels that run (the field read once and each derivative written
once, 4 + 4 n bytes a point for n derivatives; 26 operations a point a
derivative), over the measured time of a call: the traced sub-window's
length over its calls.
"""

from ..counts import DERIVS_A_CALL, FLOPS_PER_POINT, bound_s


def read(r):
    n = DERIVS_A_CALL[r.mix["op"]]
    least = bound_s(4 * (1 + n) * r.points, n * FLOPS_PER_POINT["compact_lane"] * r.points)
    return 100.0 * least / (r.timeline.window_s / r.traced_units)
