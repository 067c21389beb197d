"""Single-device ops: factor tables, the dense plain path, the CUDA kernels'
wrappers (``lane``: K1, ``strided``: K2 with its modes, ``rk`` included,
``adv_lap``: K3, K5 and K9, ``megastep``: K4, ``vec``: K6 and K10,
``pair``: K7, K8, K13 and K1 + K2 epilogues, ``dist``: K11 and K12), the derivative API with filters and the vector calculus, the
fused RK3 substeps, the spectral Poisson solve and the spectral
diagnostics."""

from .derivatives import (
    curl,
    d2fdx2,
    d2fdy2,
    d2fdz2,
    dense_operator,
    derivative,
    dfdx,
    dfdy,
    dfdz,
    divergence,
    filter_field,
    gradient,
    laplacian,
    resolve_method,
)
from .fused_step import make_fused_substep, make_fused_substep_vec
from .pair import advection_pair
from .poisson import laplacian_eigenvalues, project, solve_poisson, spectral_multipliers
from .spectra import dissipation, energy_spectrum, enstrophy, scalar_spectrum, spectrum_shells
from .strided import rk3_solve_update

__all__ = [
    "dense_operator",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "d2fdx2",
    "d2fdy2",
    "d2fdz2",
    "filter_field",
    "gradient",
    "divergence",
    "curl",
    "laplacian",
    "make_fused_substep",
    "make_fused_substep_vec",
    "advection_pair",
    "rk3_solve_update",
    "resolve_method",
    "solve_poisson",
    "project",
    "spectral_multipliers",
    "laplacian_eigenvalues",
    "spectrum_shells",
    "scalar_spectrum",
    "energy_spectrum",
    "enstrophy",
    "dissipation",
]
