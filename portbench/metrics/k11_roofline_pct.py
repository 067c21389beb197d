"""K11 (csrc/lane_dist.cu)'s share of its roofline in the distributed dfdx
calls.

Reads the device kernels named ``lane_dist_kernel`` in the traced
sub-window, one a card a call (the mix's ``cards``, one block a card),
against K11's launch counter. Least work of a launch: its shard's field read once and its
derivative written once, 8 bytes and 26 operations a point of the shard
(K1's least work on a whole line; the halo lanes and the interface weights
it also reads are left out). The constants are kept here and not in
``counts/``, which holds the per-point tables of the kernels as first
written.
"""

import re

from ..counts import bound_s
from ..readers import kernel_share

COUNTER = ("dist", "LAUNCHES", "lane_dist")
PATTERN = re.compile(r"\blane_dist_kernel\b")
BYTES_PER_POINT = 8
FLOPS_PER_POINT = 26


def read(r):
    cards = r.mix["cards"]
    points = r.points // cards  # a launch's shard
    bound = bound_s(BYTES_PER_POINT * points, FLOPS_PER_POINT * points)
    launches = [(bound, b - a) for _, a, b in r.timeline.matching(PATTERN)]
    return kernel_share(r, "k11_roofline_pct", launches, cards * r.traced_units)
