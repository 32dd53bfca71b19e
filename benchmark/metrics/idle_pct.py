"""idle_pct: the share of the traced part in which no kernel, copy or set
ran on the card (torch.profiler's timeline)."""

from portbench.layers import idle_pct


def read(ctx):
    return idle_pct(ctx)
