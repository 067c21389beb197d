"""Device-timeline times of the axis derivatives and the Laplacian.

The port of ``benchmarks/diag_axes.py``. Each op is gated first against
the host scipy-banded oracle in float64 (numpy on the host, so that the
reference is float64 and not a second float32 path), at 2e-5 of max|ref|,
then timed by the profiler's device timeline (``utils.device_op_time_ms``:
the least kernel time of a call over a few captures, with the in-capture
copy floor beside it): dfdx, dfdy, dfdz (SCHEME4_PERIODIC, ``"auto"``: K1,
K2, K2) and the Laplacian with the compact d2 (SCHEME4_D2_PERIODIC:
K9 + K2's solve) on a seeded random field.

    python -m cfd_tpu_torch.benchmarks.diag_axes [--n 256] [--out FILE]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.derivatives import derivative, laplacian
from ..oracle import derivative_np
from ..schemes import SCHEME4_D2_PERIODIC, SCHEME4_PERIODIC
from . import Report, device_of, parser, timeline_ms

GATE = 2e-5
CAPTURES = 4  # profiler captures a case, the least kept (the JAX script's)


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("diag_axes", dev)
    n, sch = args.n, SCHEME4_PERIODIC
    dx = 2 * math.pi / n
    f64 = np.random.default_rng(0).standard_normal((n, n, n))
    f = torch.as_tensor(f64, dtype=torch.float32, device=dev)
    refs = {name: derivative_np(sch, f64, dx, axis=ax)
            for ax, name in ((-1, "dfdx"), (-2, "dfdy"), (-3, "dfdz"))}
    refs["laplacian"] = sum(derivative_np(SCHEME4_D2_PERIODIC, f64, dx, axis=ax)
                            for ax in (-1, -2, -3))
    ops = {
        "dfdx": lambda x: derivative(x, dx, sch, axis=-1, method="auto"),
        "dfdy": lambda x: derivative(x, dx, sch, axis=-2, method="auto"),
        "dfdz": lambda x: derivative(x, dx, sch, axis=-3, method="auto"),
        "laplacian": lambda x: laplacian(x, dx, SCHEME4_D2_PERIODIC, method="auto"),
    }
    for name, fn in ops.items():
        row = {"case": name, "grid": f"{n}^3", "dtype": "float32"}
        try:
            ref = refs[name]
            err = float(np.abs(fn(f).double().cpu().numpy() - ref).max() / np.abs(ref).max())
            row["rel_err_vs_f64"] = err
            if not err < GATE:
                report.fail(row, f"rel err {err:.3e} vs the host float64 oracle > {GATE}")
                continue
            ms, floor_ms, clock = timeline_ms(fn, f, captures=CAPTURES)
        except Exception as exc:  # a case that raises fails the run, after the others
            report.error(name, exc)
            continue
        report.emit({**row, "ms": ms, "gpts_per_s": n**3 / ms / 1e6, "copy_floor_ms": floor_ms,
                     "clock": clock})
    return report.finish(args.out)


if __name__ == "__main__":
    main()
