"""Single-device ops: factor tables, the dense plain path, the CUDA kernels'
wrappers (``lane``: K1, ``strided``: K2, ``adv_lap``: K3 and K5,
``megastep``: K4, ``vec``: K6, ``pair``: K1 + K2 epilogues), the derivative
API, the fused RK3 substeps and the spectral Poisson solve."""

from .derivatives import (
    d2fdx2,
    d2fdy2,
    d2fdz2,
    dense_operator,
    derivative,
    dfdx,
    dfdy,
    dfdz,
    divergence,
    gradient,
    laplacian,
    resolve_method,
)
from .fused_step import make_fused_substep, make_fused_substep_vec
from .poisson import laplacian_eigenvalues, project, solve_poisson, spectral_multipliers

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
    "divergence",
    "laplacian",
    "make_fused_substep",
    "make_fused_substep_vec",
    "resolve_method",
    "solve_poisson",
    "project",
    "spectral_multipliers",
    "laplacian_eigenvalues",
]
