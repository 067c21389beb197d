"""The share of the traced sub-window in which no operation ran on the
card: one minus the union of its device activity over the window."""

from ..readers import idle_pct


def read(r):
    return idle_pct(r)
