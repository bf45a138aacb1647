"""Whole-step share of the H100's bf16 tensor peak (989 TFLOP/s at 700 W):
the model's FLOPs (2·MACs of every conv and transposed conv) of the
calls made after the traced stretches over their seconds on the host's
clock."""
from portbench.lib import readers


def read(ctx):
    return readers.mfu(ctx)
