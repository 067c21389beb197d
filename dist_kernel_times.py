#!/usr/bin/env python3
"""Device time per launch of the shard-local kernels K11 and K12 on one card.

Times the checkout in the working directory, so that two checkouts can be
held against each other in one run on one card:

    python3 dist_kernel_times.py                          # this checkout
    (cd ../other && python3 ../repo/dist_kernel_times.py)  # another one

The one script that times these kernels (``chip_smoke.py`` checks them
and builds their inputs). Cases: K11 (x) and K12 (y, z) on the first
128^3 shard of 256^3 over (2, 2, 2), SCHEME4_PERIODIC and SCHEME4_D2
(whose first chain forms the closure rows), and K12 on the flat lines of
one shard of 256^3 over (1, 1, 4), each beside its library call (one
torch.matmul with the shard's dense operator over the extended input,
halos and interface weights concatenated) and its bound: the least bytes
(f, halos and weights read once, f' written once) over the card's
published rate. A launch takes less device time than its Python wrapper
takes on the host, so each is timed two ways: the kernel's own duration
from ``torch.profiler``, and CUDA events around calls all issued behind a
spin kernel (``queued_ms``: the kernel plus its launch, no host time).
Prints one JSON line, and the card's name and power limit before it;
exits non-zero without a card.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")  # the checkout being timed, not this script's

import chip_smoke as cs  # noqa: E402
import cfd_tpu_torch as ct  # noqa: E402
from cfd_tpu_torch.ops import dist  # noqa: E402
from cfd_tpu_torch.parallel.dist_tables import shard_blocks  # noqa: E402
from cfd_tpu_torch.utils.timing import HBM_BYTES_PER_S  # noqa: E402

N = 256
SPIN_HZ = 2e9  # spin cycles a second: above any H100 clock, so the spin only lasts longer


def queued_ms(fn, warmup=3, iters=30) -> float:
    """Median event time of one call, every call issued behind a spin
    kernel (``cuda_time_ms(..., queued=True)``, repeated here for
    checkouts whose timer lacks it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int(SPIN_HZ * (2 * iters * host_s + 1e-3)))
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def profiled_us(fn, calls=20) -> float:
    """Mean device microseconds of one call's kernels, from torch.profiler
    (every kernel the call launches, summed)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        total += getattr(ev, "cuda_time_total", 0.0) if t is None else t
    return total / calls


def shard_operator(block, dx, with_ab=True):
    """The dense float64 operator of one shard's solve over its extended
    input [hl; f; hr (; a; b)]: T_r^{-1} B_ext / dx**order (and the unit
    loads), (nl, nl + 2w (+ 2)): the library call's matrix."""
    scheme = block.scheme
    nl, w = block.nl, scheme.stencil_width
    eye = torch.eye(nl + 2 * w, dtype=torch.float64)
    cols = [dist.solve_lines_tables_ref(eye[w:w + nl], eye[:w], eye[w + nl:], 1 / dx, block)]
    if with_ab:
        cols += [torch.from_numpy(block.suh)[:, None], torch.from_numpy(block.slh)[:, None]]
    return torch.cat(cols, 1)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("dist_kernel_times.py times the card; no CUDA device here")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(20261019)
    d = 2 * math.pi / N
    res = {}

    def record(key, kernel, lib, f, *rest):
        nbytes = 4 * (2 * f.numel() + sum(t.numel() for t in rest))
        res[key] = {"kernel_us": profiled_us(kernel), "queued_ms": queued_ms(kernel),
                    "library_us": profiled_us(lib), "library_queued_ms": queued_ms(lib),
                    "shape": list(f.shape), "bound_us": nbytes / HBM_BYTES_PER_S * 1e6}

    for scheme, suffix in ((ct.SCHEME4_PERIODIC, ""), (ct.SCHEME4_D2, "_d2_first")):
        block = shard_blocks(scheme, N, 2)[0]
        M = shard_operator(block, d).to(dev, torch.float32)
        for key, axis in (("lane_dist", 2), ("strided_dist_y", 1), ("strided_dist_z", 0)):
            f, hl, hr, ab = cs._dist_inputs(g, dev, scheme, 0, 2, (N // 2,) * 3, axis)
            ext = torch.cat([hl, f, hr, ab], axis)
            if axis == 2:
                kernel = lambda: dist.lane_dist_derivative(f, hl, hr, ab, d, block)
                lib = lambda: torch.matmul(ext, M.T)
            else:
                kernel = lambda: dist.sublane_dist_derivative(f, hl, hr, ab, d, block, axis=axis)
                flat = ext.view(ext.shape[0], -1) if axis == 0 else ext
                lib = lambda: torch.matmul(M, flat)
            record(key + suffix, kernel, lib, f, hl, hr, ab)
    scheme = ct.SCHEME4_PERIODIC
    block = shard_blocks(scheme, N, 4)[1]
    f, hl, hr, _ = cs._dist_inputs(g, dev, scheme, 1, 4, (N // 4, N * N), 0)
    ext = torch.cat([hl, f, hr])
    M = shard_operator(block, d, with_ab=False).to(dev, torch.float32)
    record("strided_dist_lines", lambda: dist.solve_lines_tables(f, hl, hr, 1 / d, block),
           lambda: torch.matmul(M, ext), f, hl, hr)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
