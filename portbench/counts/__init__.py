"""Least bytes and operations of the work the cells do, counted from shapes.

Each input array is counted as read once and each output array as written
once, whatever a kernel reads again; float32 values. The per-point tables
of the kernels are a frozen copy of ``chip_smoke.py``'s ``BYTES_PER_POINT``
and ``FLOPS_PER_POINT`` at the time this benchmark was written; they do not
follow later edits there. The card's peaks are the H100 SXM's published
dense rates at its 700 W limit.
"""

from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS_PER_S", "BYTES_PER_POINT", "FLOPS_PER_POINT",
           "bound_s", "k4_launch_bytes", "ns_step_bytes", "ns_step_flops", "DERIVS_A_CALL"]

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores

# K1 compact_lane, K2 compact_strided (derivative mode), K7 gradient_pair
# (1 read, 2 writes), K5 adv_lap3 (3 reads; axy and r of each of three
# components written), with the operations each does per point: a line's
# right-hand side, its forward and backward sweep (26 a derivative)
BYTES_PER_POINT = {"compact_lane": 8, "compact_strided": 8, "gradient_pair": 12,
                   "adv_lap3": 36}
FLOPS_PER_POINT = {"compact_lane": 26, "compact_strided": 26, "gradient_pair": 52,
                   "adv_lap3": 381, "rk3_mega": 44}


# The derivatives one call of each derivative op returns: the least bytes
# of a call read the field once and write each derivative once.
DERIVS_A_CALL = {"dfdx": 1, "gradient": 3}


def bound_s(nbytes: float, flops: float) -> float:
    """The least seconds the card needs for this work: the larger of its
    bytes over the memory rate and its operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def k4_launch_bytes(points: int, stage: int, component: int) -> int:
    """Least bytes of one K4 (rk3_mega) launch of a Navier-Stokes step.

    It reads f, r (the Laplacian's z right-hand side), axy and uz, and q
    after the first stage; it writes f' and q', but not q' in the last
    stage. The third component's f is uz itself: one read.
    """
    reads = 3 + (component != 2) + (stage > 0)
    writes = 1 + (stage < 2)
    return 4 * points * (reads + writes)


def ns_step_bytes(points: int) -> int:
    """Least bytes of one RK3 step of three velocity components: each stage
    reads u (and q after the first) and writes u (and q before the last),
    since the projection needs the whole stage velocity in memory."""
    floats = (3 + 6) + (6 + 6) + (6 + 3)
    return 4 * points * floats


def ns_step_flops(shape) -> float:
    """Operations of one RK3 step of the compact scheme, from the grid.

    A stage: 18 compact derivatives (the advection term's 9 first and the
    Laplacian's 9 second) at 26 a point, the advection products (15), the
    viscous term and the update (21); the projection's divergence and
    gradient (6 first derivatives and 5 sums or differences) and one real
    FFT each way (2.5 N log2 N each), with the solve's multiply (2).
    """
    points = math.prod(shape)
    fft = 2 * 2.5 * math.log2(points)
    stage = 18 * 26 + 15 + 21 + 6 * 26 + 5 + fft + 2
    return 3 * stage * points
