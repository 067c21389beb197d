"""CUDA graphs of the distributed fast path over the cards of a mesh.

The fast path's call (halos, faces, their gather, the reduced solve, one K11
or K12 a shard: some 250 PyTorch operations and copies between devices) is
issued from Python. On four cards of 512³ a shard that costs the host 3-5 ms
a call against about 1 ms of each card's work, so a closed loop of calls runs
at the host's pace, and that pace drifts with whatever else the host runs.
Where a field's shards lie on several cards, ``DistributedCompactSolver``
runs the call as a replay of one CUDA graph over those cards (``Replays``):
the host issues a copy of each shard into the graph's input buffer, one graph
launch, the joins of the cards' streams and a copy of each output shard out
of the graph's buffer, and the cards set the pace. A graph is captured once
for each axis and shard layout (devices, shapes, dtype) and serves every
field of that layout: each call copies its field in, so a field never seen
costs what a field seen before costs. On one device the shards' work queues
on one card already, and the two copies would only lengthen that queue:
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

Replay. Each shard is copied into the input buffer on its device's current
stream; the first device's current stream waits for the others', the graph
runs, the others wait for it, and each output shard is copied out of the
graph's buffer on its device, since the next replay writes that buffer
again. A replay adds to ``ops.dist.LAUNCHES`` and ``ops.dist.PEER_COPIES``
what the captured call launched and copied.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List

import torch

from ..ops import dist
from .mesh import Sharded

__all__ = ["Replays", "replayable"]

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


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    devices: List[torch.device]
    inputs: List[torch.Tensor]  # the buffers each call's shards are copied into
    out: List[torch.Tensor]
    pools: list
    made: List[Dict[str, int]]  # counter increments of one call
    # one event a device, recorded again at each replay (a wait takes the
    # record made before it)
    events: List[torch.cuda.Event]

    def __call__(self, f: Sharded) -> Sharded:
        for buf, s in zip(self.inputs, f.shards):
            buf.copy_(s)
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
        return Sharded(f.mesh, [o.clone() for o in self.out])


def _capture(op: Callable[[Sharded], Sharded], f: Sharded) -> _Graph:
    devices = list(dict.fromkeys(s.device for s in f.shards))
    home, others = devices[0], devices[1:]
    inputs = [torch.empty(s.shape, dtype=s.dtype, device=s.device) for s in f.shards]
    for buf, s in zip(inputs, f.shards):
        buf.copy_(s)
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
    return _Graph(graph, devices, inputs, list(out.shards), pools, made, events)


class Replays:
    """A solver's graphs, one for each axis and shard layout, each captured
    from ``op`` at its layout's first call and held as long as the solver."""

    def __init__(self):
        self._graphs: Dict[tuple, _Graph] = {}

    def __call__(self, op: Callable[[Sharded], Sharded], f: Sharded, axis: int) -> Sharded:
        key = (axis, f.dtype, tuple((s.device, tuple(s.shape)) for s in f.shards))
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _capture(op, f)
        return graph(f)

    def __len__(self) -> int:
        return len(self._graphs)
