"""Device milliseconds a distributed dfdx call spends in the exchange.

Every activity on the traced timeline that is neither a
``lane_dist_kernel`` (K11) nor a copy within one card (``Memcpy DtoD``:
the graph replay's copies of the shards into its input buffers and of the
outputs out of its own; the exchange moves nothing within a card by
memcpy): the halo slabs and face gathers between cards (``Memcpy PtoP``),
the faces' copy kernels and dots, the reduced solve and the small PyTorch
kernels around them; the durations summed over the cards (the timeline
keeps no card id), over the traced calls.
"""

import re

PATTERN = re.compile(r"\blane_dist_kernel\b|^Memcpy DtoD\b")


def read(r):
    seconds = sum(b - a for name, a, b in r.timeline.events if not PATTERN.search(name))
    return 1e3 * seconds / r.traced_units
