"""Navier–Stokes step: the step and its projection, by the device timeline.

The port of ``benchmarks/diag_ns.py``. Gates first: after one step of
``NavierStokes.single_device`` (SCHEME4_PERIODIC, nu = dt = 1e-3, the
Taylor–Green velocity) max|div u| / max|u| of the compact divergence
stays under 1e-4, and the float32 spectral Poisson solve
(``ops.solve_poisson``, ``torch.fft``) agrees with a host float64 FFT on a
seeded random right-hand side to 1e-5 of max|p|. Then the step, one
projection and the Poisson solve are timed by the profiler's device
timeline. The JAX package's matmul-DFT Poisson stage (its TPU route) is
not ported: the port's Poisson solve and projection run ``torch.fft``
(cuFFT on the card), and its row says so.

    python -m cfd_tpu_torch.benchmarks.diag_ns [--n 256] [--out FILE]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import NavierStokes, taylor_green
from ..ops.poisson import laplacian_eigenvalues, solve_poisson
from ..schemes import SCHEME4_PERIODIC
from . import Report, device_of, parser, timeline_ms

DIV_GATE = 1e-4
POISSON_GATE = 1e-5
DT = 1e-3
CAPTURES = 3  # profiler captures a case, the least kept (the JAX script's)


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("diag_ns", dev)
    n, sch = args.n, SCHEME4_PERIODIC
    dx = 2 * math.pi / n
    c = torch.arange(n, dtype=torch.float32, device=dev) * dx
    u = taylor_green(c, c, c)
    ns = NavierStokes.single_device(dx, sch, nu=1e-3)

    def gate(name, fn, limit):
        try:
            err = fn()
        except Exception as exc:  # a case that raises fails the run, after the others
            report.error(name, exc)
            return False
        row = {"case": name, "grid": f"{n}^3", "value": err, "gate": limit}
        if not err < limit:
            report.fail(row, f"{err:.3e} >= {limit}")
            return False
        report.emit(row)
        return True

    def divergence():
        u1 = ns.step(u, DT)
        speed = torch.sqrt(sum(ci * ci for ci in u1)).max().item()
        return ns.divergence(u1).abs().max().item() / speed

    rhs_np = np.random.default_rng(0).standard_normal((n, n, n))
    rhs_np -= rhs_np.mean()
    rhs = torch.as_tensor(rhs_np, dtype=torch.float32, device=dev)

    def poisson():
        lam = laplacian_eigenvalues(sch, rhs.shape, (dx, dx, dx))
        inv = np.zeros_like(lam)
        inv[lam != 0.0] = 1.0 / lam[lam != 0.0]
        axes = (-3, -2, -1)
        p_ref = np.fft.irfftn(np.fft.rfftn(rhs_np, axes=axes) * inv, s=rhs_np.shape, axes=axes)
        p = solve_poisson(rhs, dx, sch).double().cpu().numpy()
        return float(np.abs(p - p_ref).max() / np.abs(p_ref).max())

    ok = gate("post-step max|div u| / max|u| (compact, projected)", divergence, DIV_GATE)
    ok = gate("poisson (torch.fft, float32) vs host float64 FFT", poisson, POISSON_GATE) and ok
    if ok:
        uy, uz = u[1], u[2]
        for name, fn, x in (
            ("NS step (3 stages)", lambda ux: ns.step((ux, uy, uz), DT)[0], u[0]),
            ("projection (1 of 3)", lambda ux: ns.project((ux, uy, uz))[0], u[0]),
            ("poisson (torch.fft)", lambda r: solve_poisson(r, dx, sch), rhs),
        ):
            try:
                ms, floor_ms, clock = timeline_ms(fn, x, captures=CAPTURES)
            except Exception as exc:
                report.error(name, exc)
                continue
            report.emit({"case": name, "grid": f"{n}^3", "ms": ms,
                         "gpts_per_s": n**3 / ms / 1e6, "copy_floor_ms": floor_ms,
                         "clock": clock})
    report.emit({"case": "poisson matmul-DFT", "status": "not ported: the JAX package's TPU "
                 "route; the port's Poisson solve runs torch.fft (ROADMAP A.8)"})
    return report.finish(args.out)


if __name__ == "__main__":
    main()
