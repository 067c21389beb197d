"""Traffic kind ``ns_steps``: Navier-Stokes steps of a periodic box, with
diagnostics logged on a schedule.

A closed loop: the host issues step after step and runs ahead of the card
until the window's time is up, then waits once for the card; the logged
diagnostics stay on the card until the window has closed.

The configuration gives the grid, the box, the schemes, ``nu``, ``dt``
and the initial field: the Taylor-Green vortex plus a solenoidal
perturbation of the given rms from the seed, over the wavenumbers up to
``perturbation_kmax``. The mix gives:

- ``log_every``: {diagnostic: every how many steps}, of
  ``kinetic_energy``, ``enstrophy``, ``dissipation``, ``energy_spectrum``;
  a diagnostic is logged of the velocity a step starts from;
- ``samples``, ``sample_below``: the steps the check compares, step 0 and
  ``samples - 1`` more drawn from the seed below ``sample_below``, all at
  steps where every diagnostic is logged;
- ``warm_steps``: steps of the warm-up, which logs every diagnostic;
- ``trace_lead``, ``trace_units``: the traced sub-window, steps that fill
  the queue and then the steps it measures; its markers split each step
  into its diagnostics and the step itself.

The check follows the program's own state: at each sampled step the
reference takes the velocity the program stepped from, runs the same step
in float64 and compares what the program made of it, and the diagnostics
the program logged there. Step 0 starts from the benchmark's own field.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List

import numpy as np
import torch

from ..reference.ops import FLOAT64, TF32, Periodic
from . import scheme_named

# the name of each diagnostic's number in the check
GAPS = {"kinetic_energy": "ke_gap", "enstrophy": "enstrophy_gap",
        "dissipation": "dissipation_gap", "energy_spectrum": "spectrum_gap"}


def _grid(cfg):
    shape = tuple(int(n) for n in cfg["grid"])
    return shape, float(cfg["box"]) / shape[-1]


def sample_steps(mix, seed: int) -> List[int]:
    every = math.lcm(*mix["log_every"].values())
    choices = range(every, int(mix["sample_below"]), every)
    return [0] + sorted(random.Random(seed).sample(choices, int(mix["samples"]) - 1))


def make_inputs(cfg, mix, seed: int, device) -> dict:
    """The initial velocity, float32 on ``device``, and the sampled steps."""
    shape, h = _grid(cfg)
    init = cfg["initial"]
    c = torch.arange(shape[-1], dtype=torch.float64, device=device) * h
    z, y, x = c[:, None, None], c[None, :, None], c[None, None, :]
    base = (torch.sin(x) * torch.cos(y) * torch.cos(z),
            -torch.cos(x) * torch.sin(y) * torch.cos(z),
            torch.zeros(shape, dtype=torch.float64, device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    noise = torch.randn((3, *shape), generator=gen, device=device, dtype=torch.float32)
    ops = Periodic(shape, h, FLOAT64, device)
    kmax = float(init["perturbation_kmax"])
    kz, ky, kx = (torch.as_tensor(m, device=device) for m in _wavenumbers(shape, h))
    keep = (kz**2 + ky**2 + kx**2) <= kmax**2
    low = [torch.fft.irfftn(torch.fft.rfftn(n.double()) * keep, s=shape) for n in noise]
    pert = ops.project(tuple(low))
    rms = math.sqrt(sum(float(torch.mean(p * p)) for p in pert) / 3)
    scale = float(init["perturbation_rms"]) / rms
    u0 = tuple((b + scale * p).to(torch.float32).contiguous() for b, p in zip(base, pert))
    return {"u0": u0, "samples": sample_steps(mix, seed)}


def _wavenumbers(shape, h):
    nz, ny, nx = shape
    return (2 * np.pi * np.fft.fftfreq(nz, d=h)[:, None, None],
            2 * np.pi * np.fft.fftfreq(ny, d=h)[None, :, None],
            2 * np.pi * np.fft.rfftfreq(nx, d=h)[None, None, :])


class Program:
    """The system under test: ``cfd_tpu_torch``'s Navier-Stokes model and
    spectral diagnostics."""

    def __init__(self, cfg, mix, device):
        from cfd_tpu_torch.models import NavierStokes
        from cfd_tpu_torch.ops import spectra

        shape, h = _grid(cfg)
        self.h, self.nu, self.dt = h, float(cfg["nu"]), float(cfg["dt"])
        self.scheme = scheme_named(cfg["schemes"]["d1"])
        self.model = NavierStokes.single_device(h, self.scheme, nu=self.nu, method=cfg["method"])
        self.spectra = spectra

    def step(self, u):
        return self.model.step(u, self.dt)

    def kinetic_energy(self, u):
        return self.model.kinetic_energy(u)

    def enstrophy(self, u):
        return self.spectra.enstrophy(u, self.h, self.scheme)

    def dissipation(self, u):
        return self.spectra.dissipation(u, self.h, self.scheme, self.nu)

    def energy_spectrum(self, u):
        return self.spectra.energy_spectrum(u, self.h)


class Control:
    """The reference in the program's place, in TF32 (see reference/ops.py)."""

    def __init__(self, cfg, mix, device):
        shape, h = _grid(cfg)
        self.nu, self.dt = float(cfg["nu"]), float(cfg["dt"])
        self.ops = Periodic(shape, h, TF32, device)

    def step(self, u):
        return self.ops.step(u, self.dt, self.nu)

    def kinetic_energy(self, u):
        return self.ops.kinetic_energy(u)

    def enstrophy(self, u):
        return self.ops.enstrophy(u)

    def dissipation(self, u):
        return self.ops.dissipation(u, self.nu)

    def energy_spectrum(self, u):
        return self.ops.energy_spectrum(u)


def warm_up(sut, inputs, mix) -> None:
    u = inputs["u0"]
    for _ in range(int(mix["warm_steps"])):
        for d in mix["log_every"]:
            getattr(sut, d)(u)
        u = sut.step(u)


@dataclasses.dataclass
class Window:
    units: int
    seconds: float
    held: dict
    logs: dict
    state: dict


def _steps(sut, u, k, mix, logs, held, samples, more, marker=lambda label: None):
    """Steps from ``u`` (step index ``k``) while ``more(k)``, each step's
    diagnostics logged first where due, ``marker`` called before the
    diagnostics and before the step; the last velocity and step index."""
    every = mix["log_every"]
    while more(k):
        due = [d for d, n in every.items() if k % n == 0]
        if due:
            marker("diagnostics")
            for d in due:
                logs[d][k] = getattr(sut, d)(u)
        marker("step")
        nxt = sut.step(u)
        if k in samples:
            held[k] = (u, nxt)
        u, k = nxt, k + 1
    return u, k


def run_window(sut, inputs, mix, seconds: float, sync) -> Window:
    samples = set(inputs["samples"])
    last = max(samples)
    logs = {d: {} for d in mix["log_every"]}
    held = {}
    t0 = time.perf_counter()
    more = lambda k: k <= last or time.perf_counter() - t0 < seconds
    u, k = _steps(sut, inputs["u0"], 0, mix, logs, held, samples, more)
    sync()
    return Window(k, time.perf_counter() - t0, held, logs, {"u": u, "k": k})


def run_marked(sut, window: Window, inputs, mix, marker, start) -> int:
    """The traced sub-window's steps, continuing the window's traffic: a
    marker before each step's diagnostics, before the step and after the
    last step, and ``start()`` once the lead steps are issued; returns the
    measured steps."""
    lead, measured = int(mix["trace_lead"]), int(mix["trace_units"])
    logs = {d: {} for d in mix["log_every"]}
    state = window.state
    first, stop = state["k"] + lead, state["k"] + lead + measured

    def more(k):
        if k == first:
            start()
        return k < stop

    state["u"], state["k"] = _steps(sut, state["u"], state["k"], mix, logs, {}, (), more,
                                    marker)
    marker("end")
    return measured


def end_to_end(window: Window, cfg, mix) -> dict:
    return {"step_ms": 1e3 * window.seconds / window.units}


def check(window: Window, inputs, cfg, mix, device) -> Dict[int, Dict[str, float]]:
    """Each sampled step's gaps from the float64 reference: the stepped
    velocity's largest gap over its largest value, a scalar's relative gap,
    the spectrum's largest gap over its largest shell."""
    shape, h = _grid(cfg)
    nu, dt = float(cfg["nu"]), float(cfg["dt"])
    ref = Periodic(shape, h, FLOAT64, device)
    out: Dict[int, Dict[str, float]] = {}
    for k, (u, got) in sorted(window.held.items()):
        want = ref.step(u, dt, nu)
        gap = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
        top = max(float(w.abs().max()) for w in want)
        del want
        gaps = out[k] = {"step_gap": gap / top}
        for d, logged in window.logs.items():
            if k not in logged:
                continue
            w = ref.dissipation(u, nu) if d == "dissipation" else getattr(ref, d)(u)
            g = logged[k].double()
            key = GAPS[d]
            if g.shape != w.shape:
                gaps[key] = math.inf
            elif d == "energy_spectrum":
                gaps[key] = float((g - w).abs().max() / w.abs().max())
            else:
                gaps[key] = float((g - w).abs() / w.abs())
    return out
