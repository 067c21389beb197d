"""RK3 model steps, fused against generic, by the device timeline.

The port of ``benchmarks/diag_rk3.py``. The advection–diffusion step
(SCHEME4_PERIODIC with the compact-d2 Laplacian, Taylor–Green velocity,
f0 = sin x, dt = nu = 1e-3) runs on its fused substep (``Derivs``'s
``fused_substep``: K3 + K4 at 256^3) and on its generic form (the same
bundle without it); the fused step is held to the generic one first, at
1e-3 of what the step changed, then both are timed, and so are the fused
route's dispatches one by one: ``advection_pair`` (K13), ``lap_rhs`` (K9),
``adv_lap_rhs`` (K3, merged, where its x-lines fit), ``rk3_mega`` (K4),
K2's mul + acc mode (dfdz * uz + acc) and K2's ``rk`` mode
(``rk3_solve_update``). Then Burgers (nu = 1e-2), fused against generic
at the same gate, and both steps timed.

    python -m cfd_tpu_torch.benchmarks.diag_rk3 [--n 256] [--out FILE]
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models import AdvectionDiffusion, Burgers, Derivs, taylor_green
from ..ops import adv_lap, megastep, pair, strided
from ..schemes import SCHEME4_PERIODIC, get_scheme
from . import Report, device_of, parser, timeline_ms

GATE = 1e-3  # fused against generic, relative to the step's increment
DT = 1e-3
CAPTURES = 3  # profiler captures a case, the least kept (the JAX script's)


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("diag_rk3", dev)
    n = args.n
    dx = 2 * math.pi / n
    c = torch.arange(n, dtype=torch.float32, device=dev) * dx
    u = taylor_green(c, c, c)
    f0 = torch.sin(c)[None, None, :] * torch.ones((n, n, 1), device=dev)
    s1, s2 = SCHEME4_PERIODIC, get_scheme(4, True, derivative=2)
    derivs = Derivs.single_device(dx, s1, method="auto", second_derivative=True)
    fused = AdvectionDiffusion(derivs, nu=1e-3)
    generic = AdvectionDiffusion(dataclasses.replace(derivs, fused_substep=None), nu=1e-3)

    def time_case(name, fn, x):
        try:
            ms, floor_ms, clock = timeline_ms(fn, x, captures=CAPTURES)
        except Exception as exc:  # a case that raises fails the run, after the others
            report.error(name, exc)
            return
        report.emit({"case": name, "grid": f"{n}^3", "ms": ms, "gpts_per_s": n**3 / ms / 1e6,
                     "copy_floor_ms": floor_ms, "clock": clock})

    def gate(name, fused_out, generic_out, start):
        inc = max((g - s).abs().max().item() for g, s in zip(generic_out, start))
        err = max((a - b).abs().max().item() for a, b in zip(fused_out, generic_out)) / inc
        row = {"case": name, "grid": f"{n}^3", "rel_err_vs_increment": err}
        if not err < GATE:
            report.fail(row, f"fused vs generic: {err:.3e} of the increment > {GATE}")
            return False
        report.emit(row)
        return True

    if gate("advection-diffusion fused vs generic step", [fused.step(f0, u, DT)],
            [generic.step(f0, u, DT)], [f0]):
        time_case("generic step", lambda f: generic.step(f, u, DT), f0)
        time_case("fused step", lambda f: fused.step(f, u, DT), f0)
        ux, uy, uz = u
        mid = dict(a=-5.0 / 9.0, b=15.0 / 16.0, dt=DT, nu=1e-3)
        time_case("advection_pair (K13)", lambda f: pair.advection_pair(f, ux, uy, dx, dx, s1), f0)
        time_case("lap_rhs (K9)", lambda f: adv_lap.lap_rhs(f, dx, dx, dx, s2), f0)
        if adv_lap.adv_lap_fits(f0.shape, f0.device):
            time_case("adv_lap_rhs merged (K3)",
                      lambda f: adv_lap.adv_lap_rhs(f, ux, uy, dx, dx, dx, s1, s2)[1], f0)
        time_case("rk3_mega (K4)",
                  lambda f: megastep.rk3_mega(f, f0, f0, uz, f0, s1, s2, dx, **mid)[1], f0)
        time_case("dfdz mul + acc (K2)",
                  lambda f: strided.strided_derivative(f, dx, s1, 0, mul=uz, acc=f0), f0)
        time_case("rk3 solve + update (K2 rk)",
                  lambda f: strided.rk3_solve_update(f, f0, f0, f0, s2, **mid)[1], f0)

    bf = Burgers(derivs, nu=1e-2)
    bg = Burgers(dataclasses.replace(derivs, fused_substep=None, fused_substep_vec=None), nu=1e-2)
    if gate("burgers fused vs generic step", bf.step(u, DT), bg.step(u, DT), u):
        for name, model in (("burgers generic step", bg), ("burgers fused step", bf)):
            time_case(name, lambda ux, m=model: m.step((ux, u[1], u[2]), DT)[0], u[0])
    return report.finish(args.out)


if __name__ == "__main__":
    main()
