"""Compact-scheme right-hand sides on tensors, the line along axis 0.

The port of ``cfd_tpu/ops/rhs.py``:

* ``stencil_rhs`` — the uniform interior stencil over a line extended by
  ``w = scheme.stencil_width`` ghost or halo rows on each side;
* ``compact_rhs`` — the RHS of a whole line, with closure rows at both
  ends of a non-periodic scheme (and the wrap of a periodic one);
* ``shard_rhs`` — the RHS of one shard's line of a distributed line: the
  interior stencil over its halo rows, and a non-periodic scheme's closure
  rows formed from f on the line's end shards;
* ``closure_ghosts`` — ghost rows that make the interior stencil reproduce
  a non-periodic scheme's closure rows, for the distributed fast path's
  interface faces (``parallel/compact.py``).

Every row is formed as the kernels form it (``csrc/compact_common.cuh``):
from differences to the row's own value, and a second derivative's closure
rows from second differences. Each difference of neighbouring values is
exact in floating point, so a float32 row keeps the rounding of its
differences, O(dx f') or O(dx^2 f''), and not of the O(f) values: formed
from the raw values, a float32 d2 row at dx = 2 pi / 64 loses ~1e-5 of an
O(1) f'', which the closure LHS's corner (pivot -0.1) amplifies to ~1e-2
(a CPU run of the generic distributed routes, SCHEME6_D2).

Plain PyTorch, any dtype, any device: the distributed layer's plain path
and the plain versions of its kernels (``ops/dist.py``) use them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..schemes import CompactScheme
from ._native import second_differences

__all__ = ["stencil_rhs", "compact_rhs", "shard_rhs", "closure_ghosts", "closure_rows"]


def _exact_zero(x: float, scale: float) -> float:
    """``x``, or 0 where it is rounding of a sum that vanishes (a
    derivative's row annihilates constants)."""
    return 0.0 if abs(x) < 1e-12 * max(scale, 1.0) else x


def stencil_rhs(f_ext: torch.Tensor, inv_dx, scheme: CompactScheme) -> torch.Tensor:
    """Uniform interior stencil over ``f_ext`` (n + 2w, *batch), w ghost or
    halo rows on each side; returns (n, *batch), scaled by
    ``inv_dx ** derivative_order``. Each row is formed from differences to
    its own value f[i]; a filter's rows keep constants (``center``)."""
    w = scheme.stencil_width
    n = f_ext.shape[0] - 2 * w
    fi = f_ext[w : w + n]
    sgn = scheme.rhs_sign
    weights = scheme.rhs_weights
    center = _exact_zero(scheme.rhs_center + (1.0 + sgn) * sum(weights),
                         sum(abs(c) for c in weights))
    r = center * fi if center else torch.zeros_like(fi)
    for k, wk in zip(scheme.rhs_offsets, weights):
        r = r + wk * ((f_ext[w + k : w + k + n] - fi) + sgn * (f_ext[w - k : w - k + n] - fi))
    return r * float(inv_dx) ** scheme.derivative_order


def _closure_row(g: torch.Tensor, j: int, stencil, order: int) -> torch.Tensor:
    """Closure row ``j`` of the line ``g`` read from its wall (unscaled):
    ``sum_m c_m g[m]`` from differences to g[j], or for a second derivative
    from the second differences ``g[m] - 2 g[m+1] + g[m+2]``."""
    c = np.asarray(stencil, np.float64)
    if order == 2:
        d = second_differences(c)
        out = torch.zeros_like(g[0])
        for m, dm in enumerate(d[: len(c) - 2]):
            if dm:
                mid = g[m + 1]
                out = out + float(dm) * ((g[m] - mid) + (g[m + 2] - mid))
        return out
    gj = g[j]
    total = _exact_zero(float(c.sum()), float(np.abs(c).sum()))
    out = total * gj if total else torch.zeros_like(gj)
    for m, cm in enumerate(c):
        if cm and m != j:
            out = out + float(cm) * (g[m] - gj)
    return out


def closure_rows(f: torch.Tensor, scheme: CompactScheme):
    """The closure rows' unscaled RHS values of the line ``f`` (n, *batch):
    (left rows 0, 1, ..., right rows n-1, n-2, ...), each of batch shape,
    in the kernels' difference form."""
    order = scheme.derivative_order
    left = [_closure_row(f, j, row.rhs_stencil, order) for j, row in enumerate(scheme.left_rows)]
    fr = f.flip(0)
    right = [_closure_row(fr, j, row.rhs_stencil, order)
             for j, row in enumerate(scheme.right_rows)]
    return left, right


def shard_rhs(f: torch.Tensor, hl: torch.Tensor, hr: torch.Tensor, inv_dx,
              scheme: CompactScheme, first: bool, last: bool) -> torch.Tensor:
    """RHS of one shard's lines ``f`` (nl, *batch) with halo rows ``hl``/``hr``
    (w, *batch): the interior stencil, and where the shard holds a
    non-periodic line's physical end (``first``/``last``), the closure rows
    there formed from ``f`` (an open side's halo rows are not read)."""
    r = stencil_rhs(torch.cat([hl, f, hr]), inv_dx, scheme)
    if scheme.periodic or not (first or last):
        return r
    scale = float(inv_dx) ** scheme.derivative_order
    left, right = closure_rows(f, scheme)
    nl = f.shape[0]
    for j, v in enumerate(left if first else ()):
        r[j] = v * scale
    for j, v in enumerate(right if last else ()):
        r[nl - 1 - j] = v * scale
    return r


def compact_rhs(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """RHS of the compact system for the whole line ``f`` (n, *batch): the
    wrapped stencil for a periodic scheme, else the interior stencil with
    the closure rows installed at both ends."""
    w = scheme.stencil_width
    if scheme.periodic:
        ext = torch.cat([f[-w:], f, f[:w]])
        return stencil_rhs(ext, 1.0 / dx, scheme)
    zeros = f.new_zeros((w,) + f.shape[1:])
    return shard_rhs(f, zeros, zeros, 1.0 / dx, scheme, True, True)


def closure_ghosts(f: torch.Tensor, scheme: CompactScheme):
    """Ghost rows that make the interior stencil reproduce the closure RHS.

    At a physical boundary the ghost values are chosen so that the interior
    stencil at rows 0 .. n_closure-1 yields the closure rows' one-sided
    RHS, solved row by row, innermost first. Returns (ghost_left,
    ghost_right), each (w, *batch). A periodic scheme's "ghosts" are the
    wrap rows. Requires n_closure == w, true of every shipped scheme.
    """
    w = scheme.stencil_width
    if scheme.periodic:
        return f[-w:], f[:w]
    nb = scheme.n_closure
    if nb != w:
        raise ValueError(f"scheme {scheme.name}: ghost rows need one closure row per halo row")
    offsets, weights = scheme.rhs_offsets, scheme.rhs_weights
    sgn, c0 = scheme.rhs_sign, scheme.rhs_center

    def solve_ghosts(g, targets):
        """Row j's stencil sum_k w_k (g[j+k] + sgn g[j-k]) + c0 g[j] must
        equal targets[j]; g[j-k] with j < k are the unknown ghosts gh[k-j-1].
        From j = nb-1 down, each row adds one new, outermost unknown."""
        gh = [None] * w
        for j in range(nb - 1, -1, -1):
            m_outer = max(k - j for k in offsets)
            acc = c0 * g[j] if c0 else torch.zeros_like(targets[j])
            w_outer = None
            for k, wk in zip(offsets, weights):
                if k - j == m_outer:
                    w_outer = wk
                    acc = acc + wk * g[j + k]
                    continue
                gm = gh[k - j - 1] if j - k < 0 else g[j - k]
                acc = acc + wk * (g[j + k] + sgn * gm)
            gh[m_outer - 1] = sgn * (targets[j] - acc) / w_outer
        return gh

    def targets_for(g):
        return [sum(c * g[m] for m, c in enumerate(row.rhs_stencil)) for row in scheme.left_rows]

    # the right edge by mirror symmetry: the reversed line with the left
    # rows (for odd orders both the stencil and the right rows flip sign)
    fr = f.flip(0)
    left = solve_ghosts(f, targets_for(f))
    right = solve_ghosts(fr, targets_for(fr))
    return torch.stack(left[::-1]), torch.stack(right)
