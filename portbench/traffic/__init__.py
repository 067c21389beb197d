"""The traffic of the cells.

A mix is ``traffic/<name>.json``: its ``kind`` names the module
``traffic/<kind>.py`` that drives it, and the rest are that kind's
parameters. A kind module defines ``make_inputs``, ``Program`` (the system
under test), ``Control`` (the reference in a lower precision, in the
program's place), ``warm_up``, ``run_window``, ``run_marked`` (the traced
sub-window), ``end_to_end`` and ``check``.
"""

from __future__ import annotations


def scheme_named(name: str):
    """The program's compact scheme of this name."""
    from cfd_tpu_torch import schemes

    for value in vars(schemes).values():
        if isinstance(value, schemes.CompactScheme) and value.name == name:
            return value
    raise ValueError(f"cfd_tpu_torch.schemes has no scheme named {name!r}")
