"""Single-device ops: factor tables, the dense plain path, the CUDA kernels'
wrappers (``lane``: K1, ``strided``: K2, ``adv_lap``: K3, ``megastep``: K4),
the derivative API and the fused RK3 substep."""

from .derivatives import (
    d2fdx2,
    d2fdy2,
    d2fdz2,
    dense_operator,
    derivative,
    dfdx,
    dfdy,
    dfdz,
    gradient,
    laplacian,
    resolve_method,
)
from .fused_step import make_fused_substep

__all__ = [
    "dense_operator",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "d2fdx2",
    "d2fdy2",
    "d2fdz2",
    "gradient",
    "laplacian",
    "make_fused_substep",
    "resolve_method",
]
