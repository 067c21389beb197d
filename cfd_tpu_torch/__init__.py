"""cfd_tpu_torch — the PyTorch/CUDA port of cfd_tpu.

Compact (Padé) first derivatives of 3-D scalar fields and the RK3
advection–diffusion stepper, on PyTorch with hand-written CUDA kernels for
Hopper (``csrc/``). The JAX package ``cfd_tpu`` beside it is the reference
the port is held against; this package never imports it or ``jax``.
"""

from . import models, ops, oracle, schemes, utils
from .ops import derivative, dfdx, dfdy, dfdz, gradient
from .schemes import (
    SCHEME4,
    SCHEME4_PERIODIC,
    SCHEME6,
    SCHEME6_PERIODIC,
    CompactScheme,
    get_scheme,
    scheme_from_dict,
)

__all__ = [
    "models",
    "ops",
    "oracle",
    "schemes",
    "utils",
    "derivative",
    "dfdx",
    "dfdy",
    "dfdz",
    "gradient",
    "SCHEME4",
    "SCHEME4_PERIODIC",
    "SCHEME6",
    "SCHEME6_PERIODIC",
    "CompactScheme",
    "get_scheme",
    "scheme_from_dict",
]
