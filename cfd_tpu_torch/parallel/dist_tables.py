"""Per-shard tables of the distributed fast path (numpy, float64).

The port of what ``cfd_tpu/parallel/dist_tables.py`` builds that the
port's kernels and its faces phase read. The distributed solve is
substructuring: each shard solves its truncated local block
``T_r x_R = rhs_r`` (K11/K12, ``ops/dist.py``), two interface faces per
shard ride one ``all_gather``, a (2, 2p) product with precomputed rows of
the reduced-matrix inverse gives the shard's (alpha, beta), and the
rank-2 unit-load update ``x = x_R + alpha * suh + beta * slh`` closes the
system inside the kernel's store.

The faces need only the first and last row of ``x_R = T_r^{-1} rhs``, and
tridiagonal inverse rows decay geometrically away from the diagonal, so
each face is a K-term functional of the first (last) K RHS rows, and with
the stencil folded in (``fv``) one dot against the raw end slab and the
halo rows: the faces phase reads ~2K/nl of the field instead of running a
full extra solve.

The JAX module's other tables (the nb interleaved sub-block chains of its
leading kernel, the 128-lane block inverses ``Tm``/``Mt``/``E`` and the
intra-block corrections ``D``/``Qd`` of its lane kernels) feed the TPU's
vector and matrix units; K11 and K12 solve each shard line with one Thomas
sweep instead and need none of them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops.dist import ShardBlock
from ..schemes import CompactScheme

__all__ = ["ShardKernelTables", "shard_kernel_tables", "shard_blocks", "shard_table", "pick_nb"]

_MIN_BZ = 32  # the JAX leading kernel's shortest sub-block
# truncation threshold of the face functionals: the fast path is float32,
# and 1e-9 relative leaves the truncation two decades below its resolution
_FACE_TOL = 1e-9


_TENSORS = {}


def shard_table(tables, name: str, r: int, dtype: torch.dtype, device) -> torch.Tensor:
    """Row ``r`` (shard r's slice) of the stacked float64 table ``name`` of
    ``tables`` as a tensor of ``dtype`` on ``device``, cached: the table
    objects are cached for the life of the process, so their ``id`` keys the
    cache."""
    key = (id(tables), name, r, dtype, device)
    t = _TENSORS.get(key)
    if t is None:
        t = torch.as_tensor(getattr(tables, name)[r], dtype=dtype, device=device)
        _TENSORS[key] = t
    return t


def pick_nb(nl: int) -> int:
    """The JAX leading kernel's sub-block count for a local line of ``nl``
    rows (8, 4 or 2 chains of at least 32 rows, else 1). The port's K12
    runs one chain; ``nb >= 2`` stays in the routing so that a shard shape
    takes the route it takes in the JAX package."""
    for nb in (8, 4, 2):
        if nl % nb == 0 and nl // nb >= _MIN_BZ:
            return nb
    return 1


@dataclasses.dataclass(frozen=True)
class ShardKernelTables:
    """Stacked (p, ...) float64 tables of the outer level.

    ``suh``/``slh`` (p, nl): shard unit loads ``T_r^{-1}(-alpha e_0)`` and
    ``T_r^{-1}(-alpha e_{nl-1})``; ``fv`` (p, 2, K + 2w): the folded face
    vectors (the truncated face rows of ``T_r^{-1}`` times the stencil), ``fv[r, 0]``
    applying to ``[left halo (w); f[:K + w]]`` and ``fv[r, 1]`` to
    ``[f[nl - K - w:]; right halo (w)]`` (the caller scales by
    ``inv_dx ** derivative_order``); ``rinv_rows`` (p, 2, 2p): each shard's
    rows of the reduced-matrix inverse.
    """

    suh: np.ndarray
    slh: np.ndarray
    fv: np.ndarray
    rinv_rows: np.ndarray
    K: int


@functools.lru_cache(maxsize=None)
def shard_kernel_tables(scheme: CompactScheme, n: int, p: int) -> ShardKernelTables:
    """The outer-level tables of a global line of ``n`` points over ``p``
    shards."""
    from .compact import direction_tables

    outer = direction_tables(scheme, n, p)  # validates n, p and nl vs closures
    nl = n // p
    rows = np.stack([np.stack([t[0], t[-1]]) for t in outer.tinv])  # (p, 2, nl)
    # truncation: the first row decays rightward, the last leftward
    amax = np.abs(rows).max() or 1.0
    keep0 = np.abs(rows[:, 0, :]).max(0) > _FACE_TOL * amax
    keep1 = np.abs(rows[:, 1, ::-1]).max(0) > _FACE_TOL * amax
    K = int(max(
        np.nonzero(keep0)[0].max() + 1 if keep0.any() else 1,
        np.nonzero(keep1)[0].max() + 1 if keep1.any() else 1,
    ))
    if K > nl - scheme.stencil_width:
        K = nl  # short lines: the full rows (one whole-slab stencil)
    fw = np.stack([rows[:, 0, :K], rows[:, 1, nl - K :]], axis=1)  # (p, 2, K)

    # fold the stencil in: with S the (K, K + 2w) interior stencil over the
    # halo-extended slab (closures ride in ghost rows), fw . (S ext) = (S^T
    # fw) . ext, one dot against the raw slab
    w = scheme.stencil_width
    S = np.zeros((K, K + 2 * w))
    for i in range(K):
        for k, wk in zip(scheme.rhs_offsets, scheme.rhs_weights):
            S[i, w + i + k] += wk
            S[i, w + i - k] += scheme.rhs_sign * wk
        if scheme.rhs_center:
            S[i, w + i] += scheme.rhs_center
    fv = np.stack([np.einsum("ij,pi->pj", S, fw[:, 0]), np.einsum("ij,pi->pj", S, fw[:, 1])],
                  axis=1)
    return ShardKernelTables(
        suh=outer.uh, slh=outer.lh, fv=fv, rinv_rows=outer.rinv_rows, K=K
    )


@functools.lru_cache(maxsize=None)
def shard_blocks(scheme: CompactScheme, n: int, p: int):
    """Each shard's local block (``ops.dist.ShardBlock``), in mesh order,
    for a global line of ``n`` points over ``p`` shards."""
    from .compact import direction_tables

    t = direction_tables(scheme, n, p)
    blocks = []
    for r in range(p):
        first = r == 0 and not scheme.periodic
        last = r == p - 1 and not scheme.periodic
        blocks.append(ShardBlock(
            scheme=scheme, first=first, last=last, w=t.tw[r], invd=t.tinvd[r], du=t.tdu[r],
            tinv=t.tinv[r], suh=t.uh[r], slh=t.lh[r],
        ))
    return tuple(blocks)
