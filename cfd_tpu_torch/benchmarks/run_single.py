"""Single-card benchmark sweep: solve-only, the full derivatives, d2 and a
filter.

The port of ``benchmarks/run_single.py``, the counterpart of the
reference's perf-test tree:

* solve-only — n^2 lines of n points solved with the SCHEME4 LHS: the
  port's PCR (``ops.tridiag``, plain PyTorch) and K12 without its update
  (``ops.dist.solve_lines_tables`` on one whole-line block: the
  counterpart of ``solve_lines_pallas``, which solves T x = B r). PyTorch
  has no batched tridiagonal solver, so the library row is one
  ``torch.matmul`` with the dense inverse T^{-1}, as the port's library
  column is elsewhere;
* the full dfdx, dfdy, dfdz (``method="auto"``) on the reference's
  benchmark field;
* d2fdx2, d2fdz2 (SCHEME4_D2_PERIODIC) and an x filter
  (``get_filter(6, 0.45, periodic=True)``).

Every row passes two gates before it is timed. Accuracy: the solve-only
residual max|T x - rhs| / max|rhs| <= 1e-4; derivatives within 5e-4 of
the float64 scipy-banded oracle on the same float32 field; d2 within 5e-3;
the filter within 1e-4. A row that fails is printed with ``"gate":
"failed"`` and no time, and the script then exits nonzero. Plausibility:
a rate above 1.25x the card's one-read, one-write roofline
(``utils.spec_roofline_pts_per_s``, 3.35 TB/s), or a time under 0.02 ms,
is printed as ``"suspect"``.

    python -m cfd_tpu_torch.benchmarks.run_single [--sizes 64,128,256] [--out FILE]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import ops
from ..models import benchmark_field
from ..ops import dense, dist, tridiag
from ..oracle import derivative_np
from ..parallel.dist_tables import shard_blocks
from ..schemes import SCHEME4, SCHEME4_D2_PERIODIC, get_filter, lhs_bands, rhs_matrix
from ..utils.timing import spec_roofline_pts_per_s
from . import Report, bench_ms, device_of, parser

NOISE_FLOOR_MS = 0.02  # below it a time says little about the kernel
RESIDUAL_GATE = 1e-4
CHECK_LINES = 1024  # the residual is read on the first lines only, in float64


def _emit(report, row, t=None, npts=None, itemsize=4):
    if t is not None:
        if npts / (t * 1e-3) > 1.25 * spec_roofline_pts_per_s(itemsize):
            row["raw_ms"] = t
            row["suspect"] = True
            row["suspect_reason"] = "above the HBM roofline: a timing artifact, no rate claimed"
        else:
            row["ms"] = t
            row["gpts_per_s"] = npts / t / 1e6
            if t < NOISE_FLOOR_MS:
                row["suspect"] = True
                row["suspect_reason"] = f"under {NOISE_FLOOR_MS} ms: timer noise"
    report.emit(row)


def _residual(x, rhs, n):
    """max |T x - rhs| / max |rhs| for the SCHEME4 LHS, numpy float64."""
    dl, d, du = lhs_bands(SCHEME4, n)
    x = np.asarray(x, np.float64)
    r = d[:, None] * x
    r[1:] += dl[1:, None] * x[:-1]
    r[:-1] += du[:-1, None] * x[1:]
    return float(np.abs(r - np.asarray(rhs, np.float64)).max() / np.abs(rhs).max())


def bench_solve_only(n, report, dev):
    """Solve n^2 lines of n points, lines along the leading axis."""
    rng = np.random.default_rng(0)
    rhs_np = rng.random((n, n * n), np.float32)
    rhs = torch.as_tensor(rhs_np, device=dev)
    fac = tridiag.pcr_factor(*lhs_bands(SCHEME4, n))
    block = shard_blocks(SCHEME4, n, 1)[0]
    ghosts = torch.zeros((SCHEME4.stencil_width, n * n), device=dev)  # not read: both ends closed
    tinv = torch.as_tensor(np.linalg.inv(dense.lhs_matrix(SCHEME4, n)), dtype=torch.float32,
                           device=dev)
    target = rhs_np[:, :CHECK_LINES].astype(np.float64)
    steps = {
        # solver: (call, what T x must equal, note)
        "pcr": (lambda r: tridiag.pcr_solve(fac, r), target, None),
        "k12_lines": (lambda r: dist.solve_lines_tables(r, ghosts, ghosts, 1.0, block),
                      rhs_matrix(SCHEME4, n) @ target, "solves T x = B r, stencil included"),
        "torch.matmul(dense inverse)": (
            lambda r: torch.matmul(tinv, r), target,
            "PyTorch has no batched tridiagonal solver: one torch.matmul with T^-1"),
    }
    for name, (step, want, note) in steps.items():
        row = {"bench": "solve_only", "solver": name, "grid": f"{n}^3"}
        if note:
            row["note"] = note
        try:
            res = _residual(step(rhs)[:, :CHECK_LINES].cpu().numpy(), want, n)
        except Exception as exc:  # a case that raises fails the run, after the others
            report.error(f"solve_only {name} {n}^3", exc)
            continue
        row["residual"] = res
        if not res <= RESIDUAL_GATE:
            report.fail(row, f"residual {res:.3e} > {RESIDUAL_GATE}")
            continue
        _emit(report, row, bench_ms(lambda: step(rhs), dev), n**3)


def _gated(report, row, got, ex, tol, step, f, n, dev):
    err = float(np.abs(got - ex).max() / np.abs(ex).max())
    row["rel_err"] = err
    if not err <= tol:
        report.fail(row, f"rel err {err:.3e} > {tol}")
        return
    _emit(report, row, bench_ms(lambda: step(f), dev), n**3)


def bench_full_derivative(n, report, dev):
    """dfdx/dfdy/dfdz on the reference's benchmark field, each gated
    against the float64 scipy-banded oracle on the same float32 field."""
    d = 2 * math.pi / n
    c = torch.arange(n, dtype=torch.float32, device=dev) * d
    f, _ = benchmark_field(c, c, c)
    f_host = f.double().cpu().numpy()
    for name, axis in (("dfdx", -1), ("dfdy", -2), ("dfdz", -3)):
        step = lambda g, axis=axis: ops.derivative(g, d, SCHEME4, axis=axis, method="auto")
        row = {"bench": "full_derivative", "op": name, "method": "auto", "grid": f"{n}^3"}
        try:
            got = step(f).double().cpu().numpy()
        except Exception as exc:
            report.error(f"{name} {n}^3", exc)
            continue
        _gated(report, row, got, derivative_np(SCHEME4, f_host, d, axis=axis), 5e-4, step, f,
               n, dev)


def bench_d2_and_filter(n, report, dev):
    """d2 (5e-3 against the float64 oracle: the float32 input's rounding
    through the d2 operator) and a filter (1e-4)."""
    d = 2 * math.pi / n
    c = np.arange(n) * d
    f64 = (np.sin(c)[None, None, :] * np.cos(2 * c)[None, :, None] * np.ones((n, 1, 1))
           + 0.3 * np.cos(3 * c)[:, None, None])
    f = torch.as_tensor(f64, dtype=torch.float32, device=dev)
    f_host = f.double().cpu().numpy()
    d2 = SCHEME4_D2_PERIODIC
    filt = get_filter(6, 0.45, periodic=True)
    cases = [
        ("d2fdx2", lambda g: ops.d2fdx2(g, d, d2), -1, d2, 5e-3),
        ("d2fdz2", lambda g: ops.d2fdz2(g, d, d2), -3, d2, 5e-3),
        ("filter_x", lambda g: ops.filter_field(g, filt, axis=-1), -1, filt, 1e-4),
    ]
    for name, step, axis, scheme, tol in cases:
        row = {"bench": "d2_filter", "op": name, "method": "auto", "grid": f"{n}^3"}
        try:
            got = step(f).double().cpu().numpy()
        except Exception as exc:
            report.error(f"{name} {n}^3", exc)
            continue
        ex = derivative_np(scheme, f_host, 1.0 if scheme is filt else d, axis=axis)
        _gated(report, row, got, ex, tol, step, f, n, dev)


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="64,128,256")
    ap.add_argument("--solve-only", action="store_true")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("run_single", dev)
    for n in (int(s) for s in args.sizes.split(",")):
        bench_solve_only(n, report, dev)
        if not args.solve_only:
            bench_full_derivative(n, report, dev)
            bench_d2_and_filter(n, report, dev)
    return report.finish(args.out)


if __name__ == "__main__":
    main()
