"""Device milliseconds of the diagnostics a step, in the traced sub-window.

At a step that logs diagnostics (``ops/spectra.py``: enstrophy,
dissipation, the energy spectrum; and the model's kinetic energy), the
traffic puts a marker labelled ``diagnostics`` before them and one
labelled ``step`` after them; the device time of the ``diagnostics``
segments, over the traced steps.
"""


def read(r):
    ms = 1e3 * r.timeline.labelled_s("diagnostics")
    if ms == 0.0:
        r.note("diag_ms_per_step", "the traced steps logged no diagnostics")
        return None
    return ms / r.traced_units
