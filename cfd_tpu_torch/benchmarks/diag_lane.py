"""Diagnosis: copy floors of each access pattern, and K1 as its lines grow.

The port of ``benchmarks/diag_lane.py``. Two parts:

1. **Copy floors** — a pure copy (K14, ``ops.diag``) over the tiles each
   access pattern reads, bitwise checked before it is timed:
     - (rows, n) row tiles of an (n^2, n) array: K1's own lines;
     - (nz, C) column tiles of an (n, n^2) array: the flat dfdz layout,
       runs of C * 4 bytes strided by n^2 * 4;
     - (nz, by, nx) and (bz, ny, nx) slabs of an (n, n, n) array.
2. **K1 as its lines grow** — the x derivative (SCHEME4_PERIODIC, K1) at
   the fixed volume n^3 as lines of n and 2n points, at (n/4, n/4, 2n)
   and at native (2n)^3, each checked against the plain float32 version
   first. K1 has one form for every line length, so the JAX script's
   fold/roll/rows sweep is one row per shape here.

The whole suite runs ``--passes`` times in turn; the least time of each
case is its best-of row. ``--quick`` leaves out part 2. Shapes are those of
the JAX script at ``--n 256`` (the default):

    python -m cfd_tpu_torch.benchmarks.diag_lane [--quick] [--passes 2] [--out FILE]
"""

from __future__ import annotations

import torch

from ..ops import diag, lane
from ..schemes import SCHEME4_PERIODIC
from ..utils.timing import HBM_BYTES_PER_S
from . import Report, bench_ms, device_of, parser

K1_GATE = 1e-5  # K1 against its plain float32 version, relative to max|ref|


def _field(shape, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.rand(shape, generator=g, device=dev)


def cases(n: int, quick: bool, dev: torch.device) -> dict:
    """name -> (kind, call, input): the suite at size ``n``."""
    out = {}
    f256 = _field((n * n, n), 0, dev)
    f512 = _field((n * n // 2, 2 * n), 0, dev)
    for shape, x, rows in (((n * n, n), f256, 1024), ((n * n // 2, 2 * n), f512, 512),
                           ((n * n // 2, 2 * n), f512, 1024)):
        rows = min(rows, shape[0])
        out[f"copy ({shape[0]},{shape[1]}) rows={rows}"] = (
            "copy", lambda g, r=rows: diag.copy2d(g, r, g.shape[1]), x)
    fz = _field((n, n * n), 0, dev)
    for C in (512, 2048, 8192):
        if (n * n) % C == 0:
            out[f"copy ({n},{n * n}) cols={C}"] = ("copy", lambda g, C=C: diag.copy2d(g, n, C), fz)
    f3 = _field((n, n, n), 0, dev)
    for by in (8, 32):
        if n % by == 0:
            out[f"copy 3d ({n},{by},{n})"] = ("copy", lambda g, by=by: diag.copy3d(g, n, by), f3)
    if n % 8 == 0:
        out[f"copy 3d (8,{n},{n})"] = ("copy", lambda g: diag.copy3d(g, 8, n), f3)
    if not quick:
        k1 = lambda g: lane.lane_derivative(g, 1.0, SCHEME4_PERIODIC)
        out[f"K1 n={n} B={n * n}"] = ("k1", k1, f256)
        out[f"K1 n={2 * n} B={n * n // 2}"] = ("k1", k1, f512)
        out[f"K1 ({n // 4},{n // 4},{2 * n})"] = ("k1", k1, _field((n // 4, n // 4, 2 * n), 1, dev))
        out[f"K1 {2 * n}^3"] = ("k1", k1, _field((4 * n * n, 2 * n), 1, dev))
    return out


def check(kind: str, call, x) -> str:
    """Why the case's output is wrong, or None: a copy is bitwise the
    input; K1 agrees with its plain float32 version to K1_GATE."""
    got = call(x)
    if kind == "copy":
        return None if torch.equal(got, x) else "copy differs from its input"
    ref = lane.lane_derivative_ref(x, 1.0, SCHEME4_PERIODIC)
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    return None if rel <= K1_GATE else f"K1 vs plain: rel {rel:.3e} > {K1_GATE}"


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="copy floors only")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--n", type=int, default=256, help="the JAX script's 256")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("diag_lane", dev)
    suite = cases(args.n, args.quick, dev)
    best = {}
    for name, (kind, call, x) in suite.items():
        try:
            why = check(kind, call, x)
        except Exception as exc:  # a case that raises fails the run, after the others
            report.error(name, exc)
            continue
        if why:
            report.fail({"case": name}, why)
            continue
        best[name] = []
    for p in range(args.passes):
        for name in best:
            kind, call, x = suite[name]
            t = bench_ms(lambda: call(x), dev)
            best[name].append(t)
            report.emit({"case": name, "pass": p, "ms": t, "gpts_per_s": x.numel() / t / 1e6})
    for name, ts in best.items():
        x = suite[name][2]
        t = min(ts)
        report.emit({"case": name, "best_of": len(ts), "ms": t,
                     "gpts_per_s": x.numel() / t / 1e6,
                     "bound_ms": 8 * x.numel() / HBM_BYTES_PER_S * 1e3, "shape": list(x.shape)})
    return report.finish(args.out)


if __name__ == "__main__":
    main()
