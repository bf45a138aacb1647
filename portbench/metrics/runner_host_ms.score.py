"""Host milliseconds a batch inside PrecroppedRunner._dispatch (sparsify,
pad, enqueue the copies, forward and readback), the median over the
window."""
from portbench.lib import readers


def read(ctx):
    return readers.dispatch_ms(ctx)
