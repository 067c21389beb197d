"""Megabytes a distributed dfdx call copies into its CUDA graph's inputs.

The program's counter of the bytes each replay of the fast path's exchange
stages into its graph's input buffers (each shard's two end slabs, or the
whole shard where the graph reads it all), read around the traced
sub-window: MB (1e6 B) a call, summed over the cards, over the traced calls.
Left out where the program has no such counter.
"""

COUNTER = ("dist", "STAGED", "bytes")


def read(r):
    made = r.launches.get("staged_mb_per_call")
    if made is None:
        r.note("staged_mb_per_call", "the program has no counter of the bytes staged "
                                     "into its graph")
        return None
    return made / 1e6 / r.traced_units
