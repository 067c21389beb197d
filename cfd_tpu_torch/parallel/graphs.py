"""CUDA graphs of the distributed fast path's exchange over the cards of a mesh.

The fast path's exchange (halos, faces, their gather, the reduced solve and
the weights laid out for the kernels: some 250 PyTorch operations and copies
between devices, ``parallel/compact.py``'s ``dist_exchange``) is issued from
Python. On four cards of 512³ a shard that costs the host 3-5 ms a call
against about 1 ms of each card's work, so a closed loop of calls issued op
by op runs at the host's pace, and that pace drifts with whatever else the
host runs. Where a field's shards lie on several cards,
``DistributedCompactSolver`` replays the exchange from one CUDA graph over
those cards (``Replays``), and the cards set the pace. The graph ends at the
interface weights: its outputs are the kernels' operands (the halo slabs
``hl``/``hr`` and each shard's weights), held in its own buffers, and the
solver launches K11 (x) or K12 (y, z) on the caller's own shards after it,
each on its device's current stream, into fresh outputs. The exchange reads
only the first and last ``L'`` points of each shard's line
(``compact.ends_width``, from the scheme's tables: the faces' slabs, the
closure ghosts, the halos), so the graph's input is those two end slabs of
each shard, one after the other (``stage_ends``), the whole shard where
they cover it. A graph is captured once for each axis and shard layout
(devices, shapes, dtype) and serves every field of that layout: each call
stages its field's ends, so a field never seen costs what a field seen
before costs. On one device the shards' work queues on one card already:
there, and off CUDA, the call is issued op by op (``replayable``).

Capture. Each device's work goes to a side stream of its own. The first
device's stream begins the capture (``torch.cuda.graph``); the others join it
by waiting on an event recorded in it, and leave it the same way, so the
copies between devices (``parallel/mesh.py``), which PyTorch orders by events
on both devices' current streams, become edges of the graph. Allocations on
the first device go to the graph's pool, on the others to a ``MemPool`` of
the capture, made on that device and held as long as the graph (a pool that
nothing holds is emptied by the next ``empty_cache``, which every capture
calls), so the graph's buffers stay its own. One plain call on the same
streams comes first: it caches every table on its device and gives cuBLAS
its workspaces, since a capture copies nothing from the host.

Replay. Each shard's ends are copied into the input buffer on its device's
current stream; the first device's current stream waits for the others',
the graph runs, and the others wait for it. The kernels the solver then
launches read the graph's output buffers on those streams, and the next
replay waits for them before it writes the buffers again. A replay adds to
``ops.dist.LAUNCHES`` and ``ops.dist.PEER_COPIES`` what the captured call
launched and copied, and to ``ops.dist.STAGED`` one replay and the bytes it
copied into the input buffers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from ..ops import dist
from .mesh import Sharded

__all__ = ["Replays", "replayable", "stage_ends"]

_COUNTERS = (dist.LAUNCHES, dist.PEER_COPIES)


def replayable(f: Sharded) -> bool:
    """Whether a fast-path call on ``f`` runs as a graph replay: its shards
    lie on more than one CUDA device, and no capture is under way."""
    devices = {s.device for s in f.shards}
    return (len(devices) > 1 and all(d.type == "cuda" for d in devices)
            and not torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def _on(streams: Dict[torch.device, torch.cuda.Stream]):
    """Each stream current on its device; the current device kept."""
    device = torch.cuda.current_device()
    before = {d: torch.cuda.current_stream(d) for d in streams}
    try:
        for s in streams.values():
            torch.cuda.set_stream(s)
        torch.cuda.set_device(device)
        yield
    finally:
        for s in before.values():
            torch.cuda.set_stream(s)
        torch.cuda.set_device(device)


def stage_ends(s: torch.Tensor, dim: int, width: int, out=None) -> torch.Tensor:
    """The first and last ``width`` points of shard ``s`` along ``dim``, one
    after the other, in ``out`` (made where None), by one copy; the whole
    shard where the two cover it."""
    d = dim % s.ndim
    nl = s.shape[d]
    rows = nl if 2 * width >= nl else 2 * width
    if out is None:
        shape = list(s.shape)
        shape[d] = rows
        out = torch.empty(shape, dtype=s.dtype, device=s.device)
    if rows == nl:
        return out.copy_(s)
    # a view of the two slabs: the line's axis as (2, width), the second
    # slab nl - width points after the first
    ends = s.unfold(d, width, nl - width).movedim(-1, d + 1)
    out.view(ends.shape).copy_(ends)
    return out


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    devices: List[torch.device]
    dim: int
    width: int
    inputs: List[torch.Tensor]  # the buffers each call's shard ends are copied into
    out: Tuple[Sharded, ...]
    pools: list
    made: List[Dict[str, int]]  # counter increments of one call
    # one event a device, recorded again at each replay (a wait takes the
    # record made before it)
    events: List[torch.cuda.Event]

    def __call__(self, f: Sharded) -> Tuple[Sharded, ...]:
        for buf, s in zip(self.inputs, f.shards):
            stage_ends(s, self.dim, self.width, buf)
        home = torch.cuda.current_stream(self.devices[0])
        for d, ev in zip(self.devices[1:], self.events[1:]):
            ev.record(torch.cuda.current_stream(d))
            home.wait_event(ev)
        with torch.cuda.device(self.devices[0]):
            self.graph.replay()
        self.events[0].record(home)
        for d in self.devices[1:]:
            torch.cuda.current_stream(d).wait_event(self.events[0])
        for c, made in zip(_COUNTERS, self.made):
            for k, v in made.items():
                c[k] += v
        dist.STAGED["replays"] += 1
        dist.STAGED["bytes"] += sum(b.numel() * b.element_size() for b in self.inputs)
        return self.out


def _capture(op: Callable[[Sharded], Tuple[Sharded, ...]], f: Sharded, dim: int,
             width: int) -> _Graph:
    devices = list(dict.fromkeys(s.device for s in f.shards))
    home, others = devices[0], devices[1:]
    inputs = [stage_ends(s, dim, width) for s in f.shards]
    static = Sharded(f.mesh, inputs)
    streams = {d: torch.cuda.Stream(d) for d in devices}
    for d, s in streams.items():
        s.wait_stream(torch.cuda.current_stream(d))
    with _on(streams):
        op(static)
    for d in devices:
        torch.cuda.synchronize(d)
    counts = [dict(c) for c in _COUNTERS]
    graph = torch.cuda.CUDAGraph()
    pools = []
    for d in others:
        with torch.cuda.device(d):  # a pool belongs to the device current at its making
            pools.append(torch.cuda.MemPool())
    with torch.cuda.device(home), torch.cuda.graph(graph, stream=streams[home]):
        fork = torch.cuda.Event()
        fork.record(streams[home])
        with contextlib.ExitStack() as stack:
            for d, pool in zip(others, pools):
                streams[d].wait_event(fork)
                stack.enter_context(torch.cuda.use_mem_pool(pool, device=d))
            with _on(streams):
                out = op(static)
            for d in others:
                streams[home].wait_stream(streams[d])
    made = [{k: c[k] - s[k] for k in c} for c, s in zip(_COUNTERS, counts)]
    for c, s in zip(_COUNTERS, counts):
        c.update(s)  # the capture ran nothing
    events = []
    for d in devices:
        with torch.cuda.device(d):
            events.append(torch.cuda.Event())
    return _Graph(graph, devices, dim, width, inputs, tuple(out), pools, made, events)


class Replays:
    """A solver's graphs of the exchange, one for each axis and shard
    layout, each captured from ``op`` at its layout's first call and held as
    long as the solver."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}

    def __call__(self, op: Callable[[Sharded], Tuple[Sharded, ...]], f: Sharded, axis: int,
                 width: int) -> Tuple[Sharded, ...]:
        """``op``'s outputs on the first and last ``width`` points of each
        shard of ``f`` along mesh ``axis``, replayed; held in the graph's
        buffers until the next replay of this layout."""
        key = (axis, f.dtype, tuple((s.device, tuple(s.shape)) for s in f.shards))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _capture(op, f, axis - 3, width)
        return graph(f)

    def __len__(self) -> int:
        return len(self._graphs)
