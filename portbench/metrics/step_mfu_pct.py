"""The whole Navier-Stokes step's share of the card's roofline.

The least time one RK3 step's mathematics needs (``counts.ns_step_bytes``
over the memory rate or ``counts.ns_step_flops`` over the float32 peak,
the larger), counted from the grid and the schemes and not from the
kernels that run, over the measured time of a step: the traced
sub-window's length over its steps, diagnostics included.
"""

from ..counts import bound_s, ns_step_bytes, ns_step_flops


def read(r):
    step_s = r.timeline.window_s / r.traced_units
    return 100.0 * bound_s(ns_step_bytes(r.points), ns_step_flops(r.shape)) / step_s
