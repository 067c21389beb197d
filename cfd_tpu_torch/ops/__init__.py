"""Single-device ops: factor tables, the dense plain path, the CUDA kernels'
wrappers (``lane``: K1, ``strided``: K2) and the derivative API."""

from .derivatives import (
    dense_operator,
    derivative,
    dfdx,
    dfdy,
    dfdz,
    gradient,
    resolve_method,
)

__all__ = [
    "dense_operator",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "gradient",
    "resolve_method",
]
