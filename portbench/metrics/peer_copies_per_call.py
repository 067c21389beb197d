"""Copies between two cards a distributed dfdx call makes.

The program's counter of the distributed layer's copies from one device to
another (``ppermute``'s halo slabs and ``all_gather``'s faces), read around
the traced sub-window, over the traced calls. Left out where the program
has no such counter.
"""

COUNTER = ("dist", "PEER_COPIES", "copies")


def read(r):
    made = r.launches.get("peer_copies_per_call")
    if made is None:
        r.note("peer_copies_per_call", "the program has no counter of copies between cards")
        return None
    return made / r.traced_units
