"""Model layer: analytic fields and the RK3 steppers (advection–diffusion,
Burgers, Navier–Stokes)."""

from .advection_diffusion import AdvectionDiffusion, Derivs, state_from_numpy, tensors_from_numpy
from .burgers import Burgers
from .fields import benchmark_field, coordinates, sine_field, taylor_green, taylor_green_2d
from .navier_stokes import NavierStokes

__all__ = [
    "AdvectionDiffusion",
    "Burgers",
    "Derivs",
    "NavierStokes",
    "state_from_numpy",
    "tensors_from_numpy",
    "benchmark_field",
    "coordinates",
    "sine_field",
    "taylor_green",
    "taylor_green_2d",
]
