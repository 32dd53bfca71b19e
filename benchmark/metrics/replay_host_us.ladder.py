"""replay_host_us.ladder: what metrics/replay_host_us.py reads, in a cell
whose end-to-end metric is image_s."""

from portbench.spans import replay_host_us


def read(ctx):
    return replay_host_us(ctx)
