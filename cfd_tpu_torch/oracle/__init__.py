"""Float64 numpy/scipy oracle for the port's compute paths."""

from .banded import compact_rhs_np, derivative_np, solve_line_np

__all__ = ["compact_rhs_np", "derivative_np", "solve_line_np"]
