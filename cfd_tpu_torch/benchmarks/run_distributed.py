"""Distributed benchmark: the distributed dfdx on a mesh of shards.

The port of ``benchmarks/run_distributed.py``, the counterpart of the
reference's perf-test/multi-GPU/PyCUDA/run.py. It times the whole
distributed dfdx (halo exchange, local solves, the reduced interface
system, the rank-2 update) of ``DistributedCompactSolver`` on the mesh of
``Config.from_env()``. Every shard of that mesh sits on ``--device``
(``CFD_MESH=2,2,2`` is eight shards on one card), so the time reads the
algorithm's overhead, not its scaling over cards.

    CFD_MESH=2,2,2 CFD_GRID=256,256,256 CFD_SPACING=0.0245 \\
        python -m cfd_tpu_torch.benchmarks.run_distributed

Before timing, dfdx of the reference's benchmark field is held to its
exact gradient (CFD_SPACING sets the physical grid, so the gate means
something at any CFD_GRID), at 5x the scheme's truncation at that spacing
plus the dtype's rounding; a failure exits nonzero. A rate above 1.25x the
one-read, one-write roofline of the distinct devices of the mesh is
printed as ``"suspect"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import Config
from ..models import benchmark_field
from ..parallel import DistributedCompactSolver
from ..utils.timing import spec_roofline_pts_per_s
from . import Report, bench_ms, device_of, parser

DTYPE_TOL = {"float64": 1e-10, "float32": 5e-4, "bfloat16": 5e-2}


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("run_distributed", dev)
    cfg = Config.from_env()  # method defaults to "auto"; CFD_METHOD overrides
    grid = cfg.make_grid([dev] * math.prod(cfg.mesh_shape))
    nz, ny, nx = cfg.grid_shape
    z, y, x = (torch.arange(n, dtype=torch.float32) * d
               for n, d in zip(cfg.grid_shape, cfg.spacing))
    f, (gx, _, _) = benchmark_field(z, y, x)  # the reference harness field
    fj = grid.distribute(f.to(cfg.torch_dtype))
    solver = DistributedCompactSolver(grid, method=cfg.method)
    row = {
        "bench": "distributed_dfdx",
        "mesh": "x".join(map(str, cfg.mesh_shape)),
        "grid": f"{nz}x{ny}x{nx}",
        "method": cfg.method,
        "dtype": cfg.dtype,
        "shards_on": str(dev),
    }
    try:
        got = grid.gather(solver.dfdx(fj)).astype(np.float64)
    except Exception as exc:  # the run fails, after its row
        report.error(f"distributed_dfdx {row['mesh']}", exc)
        return report.finish(args.out)
    ex = gx.double().numpy()
    rel = float(np.abs(got - ex).max() / np.abs(ex).max())
    kmax = float(y.abs().max())  # the d/dx wavenumber of x cos(xy) is ~ y
    tol = 5.0 * (kmax * cfg.spacing[2]) ** cfg.order + DTYPE_TOL[cfg.dtype]
    row["rel_err_vs_analytic"] = rel
    if not rel <= tol:
        report.fail({**row, "tol": tol}, f"rel err {rel:.3e} > {tol:.3e}")
        return report.finish(args.out)
    t = bench_ms(lambda: solver.dfdx(fj), dev)
    npts = nz * ny * nx
    devices = len({str(d) for d in grid.mesh.devices.flat})
    if npts / (t * 1e-3) > 1.25 * spec_roofline_pts_per_s(f.to(cfg.torch_dtype).element_size()) \
            * devices:
        row.update(raw_ms=t, suspect=True,
                   suspect_reason="above the HBM roofline: a timing artifact, no rate claimed")
    else:
        row.update(ms=t, gpts_per_s=npts / t / 1e6,
                   mpts_per_s_per_device=npts / t / 1e3 / devices)
    report.emit(row)
    return report.finish(args.out)


if __name__ == "__main__":
    main()
