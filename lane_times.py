#!/usr/bin/env python3
"""Device time of the kernels that solve whole lines in sub-block chains,
on one card, queued: K1 (``compact_lane``), and K9 (``lap_rhs``), K13
(``advection_pair``), K6 (``div_rhs``), K5 (``adv_lap_rhs3``) and K3
(``adv_lap_rhs``), whose x and y phases run the same chains; and K4
(``rk3_mega``), which runs them down z. The one script that times these
kernels: ``chip_smoke.py`` checks them and times the routes that compose
them, and ``dist_kernel_times.py`` times K11 and K12.

Times the checkout in the working directory, so that two checkouts can be
held against each other in one run on one card:

    python3 lane_times.py                          # this checkout
    (cd ../other && python3 ../repo/lane_times.py)  # another one

Cases, float32. K1, ``lane_derivative`` (the x derivative that ``dfdx``
and ``filter_field`` launch): on cubes of 64, 128 and 256 points a d1
(SCHEME4_PERIODIC), a d2 (SCHEME4_D2_PERIODIC) and the sixth-order
periodic filter (row 1 of PERF.md's kernel table); SCHEME4_PERIODIC at
(64, 64, 512), (32768, 512), (64, 128, 8192) and on the prime line (64,
128, 8191) (row 2); the sixth-order filter with closure rows at 256^3;
and, on lines that no divisor cuts into chains of 32 rows, (256, 256,
257) and (512, 512, 63), SCHEME4_PERIODIC, SCHEME4 and the periodic
filter. Each is beside its library call (one
``torch.matmul`` with the dense float32 operator, queued too) and its
byte bound (one read and one write of each point at 3.35 TB/s). K9 (SCHEME4_D2_PERIODIC) and K13 (SCHEME4_PERIODIC),
as the long-x stepwise substep calls them (rows 17 and 16): at (64, 128,
8192), 256^3, on a prime line (64, 128, 8191) and on (42, 128, 12278)
(14 chains of 877 rows), each beside its byte bound (K9 one read and one
write a point, K13 three reads and one write) and the durations of its y
and x phase kernels from torch.profiler (no library call computes either).
K6 (``div_rhs``, SCHEME4_PERIODIC; row 20) at (64, 128, 8192), 256^3 and
(42, 128, 12278), and K5 (``adv_lap_rhs3``, SCHEME4_PERIODIC with
SCHEME4_D2_PERIODIC; row 19) at 256^3, as the Navier–Stokes step calls
them, likewise (K6 three reads and one write a point, K5 three and six).
K3 (``adv_lap``, the same pair; row 18) at 256^3 and (16, 64, 6134) (two
chains of 3067 rows, opted in), likewise (three reads and two writes). K4
(``rk3_mega``, SCHEME4_PERIODIC with SCHEME4_D2_PERIODIC, the middle
substep: q in, q' out; row 22) at 256^3, (64, 128, 8192), (42, 128, 12278)
(one chain a z-line), and (257, 64, 256) (nz prime: one chain), beside its
byte bound (five reads and two writes) and its kernel's duration, and the
first substep (no q in) and the last (no q' out) at each.
Every time is taken with CUDA events around calls all issued behind a spin
kernel (``cuda_time_ms(..., queued=True)``: the kernel plus its launch, no
host time). Prints the card's name and power limit, then one JSON line;
exits non-zero without a card. Arguments name the groups to time, of
``compact_lane`` (K1), ``lap_rhs``, ``adv_pair``, ``div_rhs``,
``adv_lap3``, ``adv_lap`` and ``rk3_mega``; none times them all:

    python3 lane_times.py div_rhs adv_lap3
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, ".")  # the checkout being timed, not this script's

import cfd_tpu_torch as ct  # noqa: E402
from cfd_tpu_torch.ops import adv_lap, dense, lane, megastep, pair, vec  # noqa: E402
from cfd_tpu_torch.utils.timing import HBM_BYTES_PER_S, cuda_time_ms  # noqa: E402

# the profiler helper of this script's own checkout (the timed one may
# predate it); it imports nothing of the package
_spec = importlib.util.spec_from_file_location(
    "_profiling", Path(__file__).resolve().parent / "cfd_tpu_torch" / "utils" / "profiling.py")
_profiling = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_profiling)

FILTER = ct.get_filter(6, 0.45, periodic=True)
CASES = (  # (shape, schemes)
    *(((n, n, n), (ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC, FILTER)) for n in (64, 128, 256)),
    *((shape, (ct.SCHEME4_PERIODIC,)) for shape in ((64, 64, 512), (32768, 512), (64, 128, 8192),
                                                     (64, 128, 8191))),
    ((256, 256, 256), (ct.get_filter(6, 0.45, periodic=False),)),
    *((shape, (ct.SCHEME4_PERIODIC, ct.SCHEME4, FILTER)) for shape in ((256, 256, 257),
                                                                     (512, 512, 63))),
)
XY_SHAPES = ((64, 128, 8192), (256, 256, 256), (64, 128, 8191), (42, 128, 12278))
XY_CASES = {  # kernel: shapes, in the order they are timed
    "lap_rhs": XY_SHAPES,
    "adv_pair": XY_SHAPES,
    "div_rhs": ((64, 128, 8192), (256, 256, 256), (42, 128, 12278)),
    "adv_lap3": ((256, 256, 256),),
    "adv_lap": ((256, 256, 256), (16, 64, 6134)),
}
# least bytes a point: K9 1 read and 1 write, K13 and K6 3 and 1, K5 3 and
# 6, K3 3 and 2
XY_BYTES = {"lap_rhs": 8, "adv_pair": 16, "div_rhs": 16, "adv_lap3": 36, "adv_lap": 20}
MEGA_SHAPES = ((256, 256, 256), (64, 128, 8192), (42, 128, 12278), (257, 64, 256))
MEGA_BYTES = 28  # K4: f, r, axy, uz and q read, q' and f' written
GROUPS = ("compact_lane", *XY_CASES, "rk3_mega")


def _lane_times(g, dev, res) -> None:
    for shape, schemes in CASES:
        f = torch.randn(shape, generator=g, device=dev)
        n = shape[-1]
        dx = 2 * math.pi / n
        for scheme in schemes:
            M = torch.as_tensor(dense.dense_operator(scheme, n) / dx ** scheme.derivative_order,
                                dtype=torch.float32, device=dev).T.contiguous()
            res[f"{scheme.name} {'x'.join(map(str, shape))}"] = {
                "kernel_ms": cuda_time_ms(lambda: lane.lane_derivative(f, dx, scheme),
                                          queued=True),
                "library_ms": cuda_time_ms(lambda: torch.matmul(f.view(-1, n), M), queued=True),
                "bound_ms": 8 * f.numel() / HBM_BYTES_PER_S * 1e3,
            }
            del M


def _xy_times(g, dev, res, names) -> None:
    s1, s2 = ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC
    d = 2 * math.pi / 128
    for name, shapes in XY_CASES.items():
        if name not in names:
            continue
        for shape in shapes:
            f, ux, uy = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
            fn = {"lap_rhs": lambda: adv_lap.lap_rhs(f, d, d, d, s2),
                  "adv_pair": lambda: pair.advection_pair(f, ux, uy, d, d, s1),
                  "div_rhs": lambda: vec.div_rhs(f, ux, uy, d, d, d, s1),
                  "adv_lap3": lambda: adv_lap.adv_lap_rhs3((f, ux, uy), d, d, d, s1, s2),
                  "adv_lap": lambda: adv_lap.adv_lap_rhs(f, ux, uy, d, d, d, s1, s2)}[name]
            res[f"{name} {'x'.join(map(str, shape))}"] = {
                "kernel_ms": cuda_time_ms(fn, queued=True),
                "bound_ms": XY_BYTES[name] * f.numel() / HBM_BYTES_PER_S * 1e3,
                "phases_ms": _profiling.kernel_ms_by_name(fn),
            }
            del f, ux, uy


def _mega_times(g, dev, res) -> None:
    s1, s2 = ct.SCHEME4_PERIODIC, ct.SCHEME4_D2_PERIODIC
    rk = dict(a=-5.0 / 9.0, b=15.0 / 16.0, dt=1e-3, nu=1e-3)  # the middle substep
    d = 2 * math.pi / 128
    for shape in MEGA_SHAPES:
        f, r, axy, uz, q = (torch.randn(shape, generator=g, device=dev) for _ in range(5))
        fn = lambda: megastep.rk3_mega(f, r, axy, uz, q, s1, s2, d, **rk)
        res[f"rk3_mega {'x'.join(map(str, shape))}"] = {
            "kernel_ms": cuda_time_ms(fn, queued=True),
            "bound_ms": MEGA_BYTES * f.numel() / HBM_BYTES_PER_S * 1e3,
            "phases_ms": _profiling.kernel_ms_by_name(fn),
            "first_ms": cuda_time_ms(
                lambda: megastep.rk3_mega(f, r, axy, uz, None, s1, s2, d, **rk), queued=True),
            "last_ms": cuda_time_ms(
                lambda: megastep.rk3_mega(f, r, axy, uz, q, s1, s2, d, **rk, write_q=False),
                queued=True),
        }
        del f, r, axy, uz, q


def main(argv=None) -> None:
    names = (argv if argv is not None else sys.argv[1:]) or GROUPS
    unknown = set(names) - set(GROUPS)
    if unknown:
        raise SystemExit(f"lane_times.py: unknown groups {sorted(unknown)}; take {GROUPS}")
    if not torch.cuda.is_available():
        raise SystemExit("lane_times.py times the card; no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(20261017)
    res = {}
    if "compact_lane" in names:
        _lane_times(g, dev, res)
    _xy_times(g, dev, res, names)
    if "rk3_mega" in names:
        _mega_times(g, dev, res)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
