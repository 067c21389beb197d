"""Model layer: analytic fields and the advection–diffusion RK3 stepper."""

from .advection_diffusion import AdvectionDiffusion, Derivs, state_from_numpy
from .fields import benchmark_field, coordinates, sine_field, taylor_green

__all__ = [
    "AdvectionDiffusion",
    "Derivs",
    "state_from_numpy",
    "benchmark_field",
    "coordinates",
    "sine_field",
    "taylor_green",
]
