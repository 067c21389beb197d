"""cfd_tpu_torch — the PyTorch/CUDA port of cfd_tpu.

Compact (Padé) first and second derivatives and compact filters of 3-D
fields, the gradient, divergence, curl and compact-d2 Laplacian, the
spectral Poisson solve and Helmholtz projection, the spectral diagnostics
(``ops.spectra``), and the RK3 advection–diffusion, Burgers and
Navier–Stokes steppers with their fused substeps, and the distributed
layer (``parallel``: meshes of devices, the distributed compact solver and
the distributed RK3 substep), on PyTorch with
hand-written CUDA kernels for Hopper (``csrc/``). The JAX package
``cfd_tpu`` beside it is the reference the port is held against; this
package never imports it or ``jax``.
"""

from . import models, ops, oracle, parallel, schemes, utils
from .ops import (
    curl,
    d2fdx2,
    d2fdy2,
    d2fdz2,
    derivative,
    dfdx,
    dfdy,
    dfdz,
    divergence,
    filter_field,
    gradient,
    laplacian,
    project,
    solve_poisson,
)
from .parallel import DistributedCompactSolver, Grid, make_mesh
from .schemes import (
    SCHEME4,
    SCHEME4_D2,
    SCHEME4_D2_PERIODIC,
    SCHEME4_PERIODIC,
    SCHEME6,
    SCHEME6_D2,
    SCHEME6_D2_PERIODIC,
    SCHEME6_PERIODIC,
    CompactScheme,
    get_filter,
    get_scheme,
    scheme_from_dict,
)

__all__ = [
    "models",
    "ops",
    "oracle",
    "parallel",
    "schemes",
    "utils",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "gradient",
    "divergence",
    "curl",
    "filter_field",
    "solve_poisson",
    "project",
    "d2fdx2",
    "d2fdy2",
    "d2fdz2",
    "laplacian",
    "DistributedCompactSolver",
    "Grid",
    "make_mesh",
    "SCHEME4",
    "SCHEME4_PERIODIC",
    "SCHEME6",
    "SCHEME6_PERIODIC",
    "SCHEME4_D2",
    "SCHEME4_D2_PERIODIC",
    "SCHEME6_D2",
    "SCHEME6_D2_PERIODIC",
    "CompactScheme",
    "get_filter",
    "get_scheme",
    "scheme_from_dict",
]
