"""Share of their roofline of the port's kernel-zone kernels together: the
bound seconds of the zone layers' work (work/arith.py) over the device
seconds of the kernels that did it, in the traced stretch."""
from portbench.lib import readers


def read(ctx):
    return readers.zone_roofline(ctx)
