"""The device kernels a Navier-Stokes step launches, in the traced
sub-window.

Every kernel on the device timeline between the markers (the port's own,
cuFFT's and PyTorch's; copies and fills left out), over the traced steps.
It counts what the routing leaves to launch, whatever the kernels are
named, so a kernel that a later change adds or removes moves it.
"""

from ..readers import device_ops


def read(r):
    return len(device_ops(r)) / r.traced_units
