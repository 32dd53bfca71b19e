"""idle_in_build_pct: the share of the traced part in which the card is idle
while the program builds or drops step graphs (a 'graphs.warm',
'graphs.capture' or 'graphs.release' span open), the spans mapped onto the
profiler's clock by epoch_ns."""

from portbench.spans import idle_in_build_pct


def read(ctx):
    return idle_in_build_pct(ctx)
