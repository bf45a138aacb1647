"""Share of the traced stretch in which no device operation ran."""
from portbench.lib import readers


def read(ctx):
    return readers.idle_pct(ctx)
