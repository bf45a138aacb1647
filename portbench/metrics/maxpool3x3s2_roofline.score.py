"""K4's share of its roofline in the traced stretch: the bound of its zone
layers' work (work/arith.py) over its launches' device seconds."""
from portbench.lib import readers


def read(ctx):
    return readers.roofline(ctx, "maxpool3x3s2")
