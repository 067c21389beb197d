"""Float64 numpy/scipy oracles for the port's compute paths: the banded
full-line solve and the LANL phi/psi distributed solve."""

from .banded import compact_rhs_np, derivative_np, solve_line_np
from .lanl import lanl_derivative_np, lanl_solve_np, precompute_beta

__all__ = [
    "compact_rhs_np",
    "derivative_np",
    "solve_line_np",
    "precompute_beta",
    "lanl_solve_np",
    "lanl_derivative_np",
]
