"""Traffic kind ``dist_derivs``: distributed derivative calls back to back on
a bounded box split in blocks over cards.

The ``derivs`` kind's closed loop (the host issues call after call, each on
the next of a few fields made from the seed, and waits once at the window's
end), on a field that no card holds whole: the configuration's ``mesh``
(npz, npy, npx) splits its ``grid`` in blocks, one a card (``cuda:0`` ...
in mesh order; on the CPU every block on the one device), and the program
is the port's distributed layer: ``DistributedCompactSolver``'s ``op`` on
``"auto"``, as any caller runs it. Each block is made on its own card, from the same field form
and seed draws as ``derivs``: f = x cos(a x y) + sin(b z + c) y at points
``i * length / (block - 1)`` along each axis, ``block`` the block's x
extent, so the first card's block is a ``derivs`` cell's field and the
others are that block moved along the split axes.

The mix gives ``op`` (``dfdx``), ``fields``, ``samples``, ``sample_below``,
``warm_calls``, ``trace_lead`` and ``trace_units``, as in ``derivs``, and
``cards``, the cards the traffic spreads over, which has to equal the
mesh's blocks (the per-layer metrics read it; they see the mix and not the
configuration).
The loop is closed: the host issues call after call and waits once, at the
window's end. So a call that waits on a card (a blocking copy from host
memory, a read of a value back) cannot run this traffic; the warm-up ends
with one call of each field under PyTorch's sync debug mode set to
``"error"`` (``issues_ahead``), and a program whose call waits on a card
stops there with that error, before anything is timed.
Each sampled call's output blocks stay on their cards until the check:
until the harness has read the memory peak, card 0 holds its own share and
nothing more. Every wait and every marker spans all cards: the window ends
when the last card is done, and in the traced sub-window card 0's stream
waits for the other cards before each marker, so that each traced call's
work on every card lies between its markers on card 0.

The check gathers each sampled call's input and output on card 0 as whole
fields and compares every point with the float64 dense operator of the whole
line (``reference/ops.py``'s ``bounded_d1``), a block of planes at a time.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Sequence, Tuple

import torch

from ..reference.ops import FLOAT64, TF32, bounded_d1, bounded_d1_apply, bounded_d1_gap
from . import derivs, scheme_named

AXIS = {"dfdx": 2}  # of (nz, ny, nx)


@dataclasses.dataclass(frozen=True)
class Layout:
    shape: Tuple[int, int, int]   # the whole grid
    mesh: Tuple[int, int, int]    # cards along z, y, x
    h: float                      # the spacing on every axis
    devices: Tuple[torch.device, ...]

    @property
    def block(self) -> Tuple[int, int, int]:
        return tuple(n // p for n, p in zip(self.shape, self.mesh))

    def coords(self):
        """Each block's mesh coordinate, in mesh (C) order."""
        return [(i, j, k) for i in range(self.mesh[0]) for j in range(self.mesh[1])
                for k in range(self.mesh[2])]


def _layout(cfg, mix, device) -> Layout:
    shape = tuple(int(n) for n in cfg["grid"])
    mesh = tuple(int(p) for p in cfg["mesh"])
    if any(n % p for n, p in zip(shape, mesh)):
        raise ValueError(f"grid {shape} does not split over mesh {mesh}")
    cards = math.prod(mesh)
    if int(mix["cards"]) != cards:
        raise ValueError(f"the mix spreads over {mix['cards']} cards, the mesh {mesh} has {cards}")
    device = torch.device(device)
    if device.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(cards))
    else:
        devices = (device,) * cards
    return Layout(shape, mesh, float(cfg["length"]) / (shape[2] // mesh[2] - 1), devices)


def _join(devices: Sequence[torch.device]) -> None:
    """Card 0's stream waits, on the card, for the work queued on the others."""
    if devices[0].type == "cuda":
        first = torch.cuda.current_stream(devices[0])
        for d in devices[1:]:
            if d != devices[0]:
                first.wait_stream(torch.cuda.current_stream(d))


def _sync(devices: Sequence[torch.device]) -> None:
    """The host waits for every card."""
    if devices[0].type == "cuda":
        for d in dict.fromkeys(devices):
            torch.cuda.synchronize(d)


def whole(blocks: Sequence[torch.Tensor], layout: Layout, device) -> torch.Tensor:
    """The blocks (in mesh order) as one field on ``device``."""
    nz, ny, nx = layout.mesh
    moved = [b.to(device) for b in blocks]
    rows = [torch.cat(moved[i * nx:(i + 1) * nx], dim=2) for i in range(nz * ny)]
    planes = [torch.cat(rows[i * ny:(i + 1) * ny], dim=1) for i in range(nz)]
    return torch.cat(planes, dim=0)


def split(f: torch.Tensor, layout: Layout) -> Tuple[torch.Tensor, ...]:
    """A whole field as its blocks, each contiguous on its card."""
    bz, by, bx = layout.block
    return tuple(f[i * bz:(i + 1) * bz, j * by:(j + 1) * by, k * bx:(k + 1) * bx]
                 .to(dev).contiguous() for (i, j, k), dev in zip(layout.coords(), layout.devices))


def make_inputs(cfg, mix, seed: int, device) -> dict:
    layout = _layout(cfg, mix, device)
    rng = random.Random(seed)
    field = cfg["field"]
    fields: List[Tuple[torch.Tensor, ...]] = []
    for _ in range(int(mix["fields"])):
        a, b, phase = (rng.uniform(*field[key]) for key in ("a", "b", "c"))
        blocks = []
        for coord, dev in zip(layout.coords(), layout.devices):
            z, y, x = (torch.arange(c * n, (c + 1) * n, dtype=torch.float32, device=dev)
                       * layout.h for c, n in zip(coord, layout.block))
            z, y, x = z[:, None, None], y[None, :, None], x[None, None, :]
            blocks.append((x * torch.cos(a * x * y) + torch.sin(b * z + phase) * y).contiguous())
        fields.append(tuple(blocks))
    samples = sorted(rng.sample(range(int(mix["sample_below"])), int(mix["samples"])))
    _sync(layout.devices)
    return {"fields": fields, "samples": samples, "layout": layout}


class Program:
    """The system under test: ``cfd_tpu_torch.parallel``'s
    ``DistributedCompactSolver`` on the configuration's mesh, ``"auto"``,
    its ``op`` (``dfdx``) called on each field."""

    def __init__(self, cfg, mix, device):
        from cfd_tpu_torch.parallel import DistributedCompactSolver, Grid, Sharded, make_mesh

        layout = _layout(cfg, mix, device)
        mesh = make_mesh(layout.mesh, layout.devices)
        grid = Grid(mesh, layout.shape, (layout.h,) * 3, scheme_named(cfg["scheme"]))
        op = getattr(DistributedCompactSolver(grid), mix["op"])
        self.call = lambda blocks: op(Sharded(mesh, blocks)).shards


class Control:
    """The reference in the program's place, in TF32 (see reference/ops.py):
    the blocks gathered on card 0, the whole line's operator, the result
    split back over the cards."""

    def __init__(self, cfg, mix, device):
        layout = _layout(cfg, mix, device)
        axis = AXIS[mix["op"]]
        d = bounded_d1(layout.shape[axis], layout.h, TF32, layout.devices[0])
        self.call = lambda blocks: split(bounded_d1_apply(
            whole(blocks, layout, layout.devices[0]), d, axis, TF32), layout)


def issues_ahead(call, fields, devices: Sequence[torch.device]) -> None:
    """Run ``call`` once on each of ``fields`` under the sync debug mode
    ``"error"``: a call that makes the host wait on a card (a blocking copy
    from pageable host memory, ``.item()``, a synchronize) raises."""
    if devices[0].type != "cuda":
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        for blocks in fields:
            call(blocks)
    except RuntimeError as e:
        raise RuntimeError("the program's call waits on a card, so the host cannot issue "
                           "ahead as this traffic's closed loop does") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _sync(devices)


def warm_up(sut, inputs, mix) -> None:
    derivs.warm_up(sut, inputs, mix)
    _sync(inputs["layout"].devices)
    if isinstance(sut, Program):
        issues_ahead(sut.call, inputs["fields"], inputs["layout"].devices)


def run_window(sut, inputs, mix, seconds: float, sync) -> derivs.Window:
    return derivs.run_window(sut, inputs, mix, seconds, lambda: _sync(inputs["layout"].devices))


def run_marked(sut, window: derivs.Window, inputs, mix, marker, start) -> int:
    devices = inputs["layout"].devices

    def joined(*label):
        _join(devices)
        marker(*label)

    return derivs.run_marked(sut, window, inputs, mix, joined, start)


def end_to_end(window: derivs.Window, cfg, mix) -> dict:
    return derivs.end_to_end(window, cfg, mix)


def check(window: derivs.Window, inputs, cfg, mix, device) -> Dict[int, Dict[str, float]]:
    """Each sampled call's largest gap from the float64 reference of the
    whole line over the reference's largest value."""
    layout = inputs["layout"]
    axis = AXIS[mix["op"]]
    home = layout.devices[0]
    d = bounded_d1(layout.shape[axis], layout.h, FLOAT64, home)
    fields = inputs["fields"]
    out: Dict[int, Dict[str, float]] = {}
    for k, got in sorted(window.held.items()):
        f = whole(fields[k % len(fields)], layout, home)
        gap, top = bounded_d1_gap(f, whole(got, layout, home), d, axis)
        out[k] = {derivs.GAP[axis]: gap / top}
    return out
