"""A whole distributed dfdx call's share of its cards' roofline.

The least time one call needs, counted from the global grid alone and not
from the kernels that run: the field read once and its derivative written
once (8 bytes a point), 26 operations a point, the work shared evenly by
the mix's ``cards``, each at the card's peaks. Over the measured time of a
call: the traced sub-window's length over its calls.
"""

from ..counts import FLOPS_PER_POINT, bound_s


def read(r):
    least = bound_s(8 * r.points, FLOPS_PER_POINT["compact_lane"] * r.points) / r.mix["cards"]
    return 100.0 * least / (r.timeline.window_s / r.traced_units)
