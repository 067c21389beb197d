"""Compact-scheme right-hand sides on tensors, the line along axis 0.

The port of ``cfd_tpu/ops/rhs.py``:

* ``stencil_rhs`` — the uniform interior stencil over a line extended by
  ``w = scheme.stencil_width`` ghost or halo rows on each side;
* ``compact_rhs`` — the RHS of a whole line, with closure rows at both
  ends of a non-periodic scheme (and the wrap of a periodic one);
* ``closure_ghosts`` — ghost rows that make the interior stencil reproduce
  a non-periodic scheme's closure rows, so that a distributed line's end
  shards run the same uniform stencil as its interior ones.

Plain PyTorch, any dtype, any device: the distributed layer's plain path
and the plain versions of its kernels (``ops/dist.py``) use them.
"""

from __future__ import annotations

import torch

from ..schemes import CompactScheme

__all__ = ["stencil_rhs", "compact_rhs", "closure_ghosts", "closure_rows"]


def stencil_rhs(f_ext: torch.Tensor, inv_dx, scheme: CompactScheme) -> torch.Tensor:
    """Uniform interior stencil over ``f_ext`` (n + 2w, *batch), w ghost or
    halo rows on each side; returns (n, *batch), scaled by
    ``inv_dx ** derivative_order``."""
    w = scheme.stencil_width
    n = f_ext.shape[0] - 2 * w
    r = torch.zeros_like(f_ext[w : w + n])
    for k, wk in zip(scheme.rhs_offsets, scheme.rhs_weights):
        r = r + wk * (f_ext[w + k : w + k + n] + scheme.rhs_sign * f_ext[w - k : w - k + n])
    if scheme.rhs_center:
        r = r + scheme.rhs_center * f_ext[w : w + n]
    return r * float(inv_dx) ** scheme.derivative_order


def closure_rows(f: torch.Tensor, scheme: CompactScheme):
    """The closure rows' unscaled RHS values of the line ``f`` (n, *batch):
    (left rows 0, 1, ..., right rows n-1, n-2, ...), each of batch shape."""
    left = [sum(c * f[m] for m, c in enumerate(row.rhs_stencil)) for row in scheme.left_rows]
    n = f.shape[0]
    right = [sum(c * f[n - 1 - m] for m, c in enumerate(row.rhs_stencil))
             for row in scheme.right_rows]
    return left, right


def compact_rhs(f: torch.Tensor, dx, scheme: CompactScheme) -> torch.Tensor:
    """RHS of the compact system for the whole line ``f`` (n, *batch): the
    wrapped stencil for a periodic scheme, else the interior stencil with
    the closure rows installed at both ends."""
    w = scheme.stencil_width
    if scheme.periodic:
        ext = torch.cat([f[-w:], f, f[:w]])
        return stencil_rhs(ext, 1.0 / dx, scheme)
    zeros = f.new_zeros((w,) + f.shape[1:])
    r = stencil_rhs(torch.cat([zeros, f, zeros]), 1.0, scheme)
    left, right = closure_rows(f, scheme)
    r = r.clone()
    n = f.shape[0]
    for j, v in enumerate(left):
        r[j] = v
    for j, v in enumerate(right):
        r[n - 1 - j] = v
    return r * (1.0 / dx) ** scheme.derivative_order


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
