"""Diagnosis: the dfdz kernel's stages on the (nz, ny * nx) layout.

The port of ``benchmarks/diag_dfdz.py``. It times stripped stages of the
z derivative on one (n, n^2) field in C-column tiles (K15, ``ops.diag``),
then the whole derivative, to say where K2's dfdz time goes:

  copy          out = f                         (the floor)
  rolls         out = g + roll(g, 1), g = roll(f, -1) - f   (the RHS stage)
  dots          out = T[b] @ f per 128-row block  (the block solve, float32)
  dots_default  the same with bf16 operands, float32 sums (the TPU's
                default-precision dot)
  K2 dfdz       the port's dfdz (``method="kernel"``)
  matmul dfdz   the dense route (``method="matmul"``)

Every stage is held to its plain version first: copy and rolls bitwise;
dots at 3e-6 of max|ref| against float64 (the dense-operator gate);
dots_default at 1e-5 against its bf16-operand plain version and at 1e-2
against float64; K2 at 1e-5 against the float64 dense route. The JAX
script's fold form and roll form of its kernel are one kernel here (K2).
``--n 256`` (the default) is its (256, 65536):

    python -m cfd_tpu_torch.benchmarks.diag_dfdz [--passes 2] [--out FILE]
"""

from __future__ import annotations

import torch

from ..ops import derivatives, diag
from ..schemes import SCHEME4_PERIODIC
from ..utils.timing import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S,
                            TF32_FLOPS_PER_S)
from . import Report, bench_ms, device_of, parser

SCH = SCHEME4_PERIODIC
DOTS_GATE = 3e-6  # dense operator in float32 against float64 (the repo's test gate)
BF16_GATE = 1e-5  # the same bf16 operands, float32 sums in another order
BF16_F64_GATE = 1e-2  # bf16 operands against float64: 8 mantissa bits
K2_GATE = 1e-5  # the f32 recurrence gate


def _rel(got, ref) -> float:
    return ((got.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def bound_ms(mode: str, points: int) -> tuple:
    """(ms, "bytes" or "operations"): the least time of a stage on
    ``points`` points, the larger of its 8 bytes a point over HBM and its
    operations over the card's peak for their type. The dots modes do one
    128-term dot a point on the tensor cores (K15): dots as three TF32
    passes (495 TFLOP/s), dots_default one bf16 pass (989 TFLOP/s); both
    are bound by bytes. ``fma_bound_ms`` is dots' bound on the FMA units."""
    byte_ms = 8 * points / HBM_BYTES_PER_S * 1e3
    flops = {"dots": (3, TF32_FLOPS_PER_S), "dots_default": (1, BF16_FLOPS_PER_S)}.get(mode)
    op_ms = flops[0] * 2 * diag.BLOCK * points / flops[1] * 1e3 if flops else 0.0
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def fma_bound_ms(points: int) -> float:
    """The operations bound of one 128-term float32 dot a point on the
    FMA units (67 TFLOP/s), the form of dots before the tensor cores."""
    return 2 * diag.BLOCK * points / F32_FLOPS_PER_S * 1e3


def check(mode: str, x, C: int, table) -> str:
    """Why a stage's output is wrong, or None (gates in the module doc)."""
    got = diag.dfdz_stage(x, mode, C, table)
    if mode in ("copy", "rolls"):
        ref = diag.dfdz_stage_ref(x, mode, C, table)
        return None if torch.equal(got, ref) else f"{mode} differs from its plain version"
    exact = diag.dfdz_stage_ref(x.double(), "dots", C, table.double())
    if mode == "dots":
        rel = _rel(got, exact)
        return None if rel <= DOTS_GATE else f"vs float64: rel {rel:.3e} > {DOTS_GATE}"
    rel = _rel(got, diag.dfdz_stage_ref(x, mode, C, table))
    rel64 = _rel(got, exact)
    if rel > BF16_GATE:
        return f"vs bf16 plain: rel {rel:.3e} > {BF16_GATE}"
    return None if rel64 <= BF16_F64_GATE else f"vs float64: rel {rel64:.3e} > {BF16_F64_GATE}"


def main(argv=None) -> list:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--n", type=int, default=256, help="nz; L = n^2 (the JAX script's 256)")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    report = Report("diag_dfdz", dev)
    n = args.n
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((n, n * n), generator=g, device=dev)
    x3 = x.view(n, n, n)
    table = diag.dfdz_table(n, dev)

    suite = {}  # name -> (call, bound_ms)
    for C in (1024, 2048):
        if (n * n) % C:
            continue
        for mode in diag.MODES:
            name = f"{mode} C={C}"
            try:
                why = check(mode, x, C, table)
            except Exception as exc:  # a case that raises fails the run, after the others
                report.error(name, exc)
                continue
            if why:
                report.fail({"case": name}, why)
                continue
            suite[name] = (lambda mode=mode, C=C: diag.dfdz_stage(x, mode, C, table),
                           bound_ms(mode, x.numel())[0])
    exact = derivatives.dfdz(x3.double(), 1.0, SCH, method="matmul")
    for name, method in (("K2 dfdz", "kernel"), ("matmul dfdz", "matmul")):
        try:
            rel = _rel(derivatives.dfdz(x3, 1.0, SCH, method=method), exact)
        except Exception as exc:
            report.error(name, exc)
            continue
        if rel > K2_GATE:
            report.fail({"case": name, "rel_err": rel}, f"vs float64: rel {rel:.3e} > {K2_GATE}")
            continue
        suite[name] = (lambda method=method: derivatives.dfdz(x3, 1.0, SCH, method=method),
                       bound_ms("copy", x.numel())[0])
    best = {name: [] for name in suite}
    for p in range(args.passes):
        for name, (call, _) in suite.items():
            t = bench_ms(call, dev)
            best[name].append(t)
            report.emit({"case": name, "pass": p, "ms": t})
    for name, ts in best.items():
        t = min(ts)
        report.emit({"case": name, "best_of": len(ts), "ms": t,
                     "gpts_per_s": x.numel() / t / 1e6, "bound_ms": suite[name][1],
                     "shape": [n, n * n]})
    return report.finish(args.out)


if __name__ == "__main__":
    main()
