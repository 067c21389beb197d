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

Inside the shard, K11 and K12 cut each line into ``nb`` sub-blocks and
run their Thomas chains side by side, one thread each, as the JAX leading
kernel does (``cfd_tpu/ops/pallas_leading.py``): ``local_block_tables``
gives the sub-blocks' factors, the first rows of their inverses (the
forward sweep's faces), their intra unit loads and the (2nb, 2nb) intra
reduced inverse. ``line_block_tables`` gives the same for a whole line,
the sub-block chains of K1 (``csrc/line_chains.cuh``); on a periodic line
its reduced matrix is cyclic. The JAX module's 128-lane block inverses
``Tm``/``Mt``/``E`` and intra-block corrections ``D``/``Qd`` feed the
TPU's matrix unit, and the port needs none of them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops import tridiag
from ..ops.dist import ShardBlock
from ..schemes import CompactScheme, lhs_bands

__all__ = [
    "BlockTables", "ShardKernelTables", "line_block_tables", "local_block_tables",
    "shard_kernel_tables",
    "shard_blocks", "shard_table", "pick_nb",
]

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
    """The sub-block count of a local line of ``nl`` rows, the JAX leading
    kernel's rule: 8, 4 or 2 chains of at least 32 rows, else 1. K11 and
    K12 run that many chains a line; at least 32 rows keeps the closure
    rows inside the first and last sub-block. ``nb >= 2`` is also the
    routing condition of the JAX package's fast path along z."""
    for nb in (8, 4, 2):
        if nl % nb == 0 and nl // nb >= _MIN_BZ:
            return nb
    return 1


class BlockTables(NamedTuple):
    """Sub-block tables of one shard's local block, float64: ``w``,
    ``invd``, ``du`` (nl,) each sub-block's Thomas factors, concatenated;
    ``t0`` (nl,) the first rows of the sub-block inverses; ``uh``/``lh``
    (nl,) the intra unit loads (zero where a sub-block has no neighbour on
    that side); ``rinv`` (2nb, 2nb) the intra reduced inverse, columns 0
    and 2nb - 1 zeroed."""

    w: np.ndarray
    invd: np.ndarray
    du: np.ndarray
    t0: np.ndarray
    uh: np.ndarray
    lh: np.ndarray
    rinv: np.ndarray


@functools.lru_cache(maxsize=None)
def line_block_tables(scheme: CompactScheme, n: int, nb: int) -> BlockTables:
    """A whole line of ``n`` points cut into ``nb`` sub-blocks: K1's chains
    (``csrc/line_chains.cuh``). A non-periodic line is a shard that is both
    first and last, ``local_block_tables(scheme, n, True, True, nb)``. On a
    periodic line the wrap couples the last sub-block to the first: every
    sub-block has both intra unit loads, and ``rinv`` is the inverse of the
    cyclic (2nb, 2nb) reduced matrix, with no identity end rows; nothing
    is left for a Sherman–Morrison term."""
    if not scheme.periodic:
        return local_block_tables(scheme, n, True, True, nb)
    if n % nb:
        raise ValueError(f"line of {n} points not divisible into {nb} blocks")
    cat = _sub_block_parts(scheme, n, True, True, nb, wrap=scheme.alpha)
    rinv = _cyclic_reduced(cat["uh"].reshape(nb, -1), cat["lh"].reshape(nb, -1), nb)
    return BlockTables(rinv=rinv, **cat)


def _cyclic_reduced(uh: np.ndarray, lh: np.ndarray, nb: int) -> np.ndarray:
    """The inverse of a periodic line's reduced interface matrix: rows as
    ``_intra_reduced``'s, with the couplings across the wrap in place of
    the identity end rows."""
    m = 2 * nb
    R = np.zeros((m, m))
    for b in range(nb):
        er, orow = 2 * b, 2 * b + 1
        R[er, er] += uh[b, 0]
        R[er, orow] += lh[b, 0]
        R[er, (er - 1) % m] -= 1.0
        R[orow, er] += uh[b, -1]
        R[orow, orow] += lh[b, -1]
        R[orow, (orow + 1) % m] -= 1.0
    return np.linalg.inv(R)


@functools.lru_cache(maxsize=None)
def local_block_tables(scheme: CompactScheme, nl: int, first: bool, last: bool,
                       nb: int) -> BlockTables:
    """The inner level of the substructuring: one shard's truncated local
    block (closure rows where ``first``/``last``) cut into ``nb``
    sub-blocks of ``nl // nb`` rows (the port of
    ``cfd_tpu/parallel/dist_tables.py``'s ``local_block_tables``, without
    its ``rsupport``: the kernels dot all 2nb faces).

    A sub-block's forward sweep gives its last face (the final carry times
    the last pivot) and, against ``t0``, its first; each chain's weights
    are two rows of ``rinv`` dotted with the line's 2nb faces, and the
    backward sweep adds them times ``uh``/``lh``. The sub-block couplings
    are the interior ``alpha``: closure rows sit strictly inside the first
    and last sub-block (``pick_nb``'s 32 rows)."""
    if nl % nb:
        raise ValueError(f"local extent {nl} not divisible into {nb} blocks")
    cat = _sub_block_parts(scheme, nl, first, last, nb)
    rinv = _intra_reduced(cat["uh"].reshape(nb, -1), cat["lh"].reshape(nb, -1), nb)
    return BlockTables(rinv=rinv, **cat)


def _intra_reduced(uh: np.ndarray, lh: np.ndarray, nb: int) -> np.ndarray:
    """The inverse of the intra-shard reduced interface matrix, from the
    (nb, bz) unit loads. The block's outer ends are identity unknowns (their
    couplings to the neighbouring shards belong to the outer level), hence
    the identity end rows and the zeroed end columns."""
    m = 2 * nb
    R = np.zeros((m, m))
    for b in range(nb):
        er, orow = 2 * b, 2 * b + 1
        R[er, er] = uh[b, 0]
        R[er, orow] = lh[b, 0]
        if b > 0:
            R[er, er - 1] = -1.0
        R[orow, er] = uh[b, -1]
        R[orow, orow] = lh[b, -1]
        if b < nb - 1:
            R[orow, orow + 1] = -1.0
    R[0, :] = 0.0
    R[0, 0] = 1.0
    R[m - 1, :] = 0.0
    R[m - 1, m - 1] = 1.0
    rinv = np.linalg.inv(R)
    rinv[:, 0] = 0.0
    rinv[:, -1] = 0.0
    return rinv


def _sub_block_parts(scheme: CompactScheme, nl: int, first: bool, last: bool, nb: int,
                     wrap: float = 0.0) -> dict:
    """The local block's nb sub-blocks, their (nl,) tables concatenated:
    each sub-block's Thomas factors with its couplings to its neighbours
    cut (``w``, ``invd``, ``du``), the first row of its inverse (``t0``)
    and its intra unit loads (``uh``/``lh``, the responses to the cut
    couplings). ``wrap`` couples the first sub-block to the last, both ways
    (a periodic line's cyclic corners); without it their outer loads are
    zero. Each takes O(bz) work: three Thomas solves a sub-block, never its
    dense inverse (a whole line of a prime length is one sub-block)."""
    dl, d, du = lhs_bands(scheme, nl, first_block=first, last_block=last)
    bz = nl // nb
    parts = {k: [] for k in ("w", "invd", "du", "t0", "uh", "lh")}
    for b in range(nb):
        s, e = b * bz, (b + 1) * bz
        sdl, sd, sdu = dl[s:e].copy(), d[s:e], du[s:e].copy()
        up_c = sdl[0] if b > 0 else wrap
        lo_c = du[e - 1] if e < nl else wrap
        sdl[0] = 0.0
        sdu[-1] = 0.0
        ends = np.zeros((bz, 2))
        ends[0, 0] = ends[-1, 1] = 1.0
        cols = tridiag._thomas_solve_np(sdl, sd, sdu, ends)  # inverse's columns 0, bz - 1
        # its row 0: column 0 of the transpose, whose bands are (du, d, dl) shifted
        t0 = tridiag._thomas_solve_np(np.roll(sdu, 1), sd, np.roll(sdl, -1), ends[:, 0])
        tf = tridiag.thomas_factor(sdl, sd, sdu)
        for k, v in (("w", tf.w), ("invd", tf.invd), ("du", tf.du), ("t0", t0),
                     ("uh", -up_c * cols[:, 0] if b > 0 or wrap else np.zeros(bz)),
                     ("lh", -lo_c * cols[:, 1] if b < nb - 1 or wrap else np.zeros(bz))):
            parts[k].append(v)
    return {k: np.concatenate(v) for k, v in parts.items()}


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
            scheme=scheme, first=first, last=last, tinv=t.tinv[r], suh=t.uh[r], slh=t.lh[r],
        ))
    return tuple(blocks)
