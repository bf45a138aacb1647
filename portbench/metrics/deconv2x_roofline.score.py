"""K3's share of its roofline in the traced stretch: the bound of its zone
layers' work (work/arith.py) over its launches' device seconds."""
from portbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "deconv2x")
