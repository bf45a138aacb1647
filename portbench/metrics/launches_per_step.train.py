"""Device operations (kernels, copies, sets) a training step launches, from
the traced stretch."""
from portbench.lib import readers


def read(ctx):
    return readers.launches_per_call(ctx)
