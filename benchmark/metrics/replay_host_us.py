"""replay_host_us: the program's own host microseconds a graph replay takes
(flatten, copy-in, launch credit), its launch call excluded, where a full
launch queue holds the host: the own_ns of the window's 'engine.begin'
spans over their replays."""

from portbench.spans import replay_host_us


def read(ctx):
    return replay_host_us(ctx)
