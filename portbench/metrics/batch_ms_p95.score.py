"""95th percentile ms of a batch from the runner's dispatch call to its
scores on the host, over the window's batches sent after the traced
stretches. Per-layer, not end to end: with one batch in flight it jumps
by a whole period between runs whose host is a little faster or slower
than the card (PERF.md section 2), wider than any bound holds."""
from portbench.lib import readers


def read(ctx):
    return readers.batch_p95_ms(ctx)
