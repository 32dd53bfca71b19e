"""Profiling context managers (style_transfer2_tpu/utils/profiling.py;
reference utils.py:72-107): cProfile and line_profiler for host code, and
device_trace, the torch.profiler counterpart of the JAX package's
jax.profiler trace."""

import cProfile
import inspect
import socket
import sys
import time
from contextlib import contextmanager
from pathlib import Path


@contextmanager
def profile():
    """Prints a cProfile report for the enclosed host-side code."""
    prof = cProfile.Profile()
    prof.enable()
    yield
    prof.disable()
    prof.print_stats(1)
    prof.clear()


@contextmanager
def line_profile(*items):
    """Prints a line-by-line profile for the given functions/modules/module
    names while execution is in context (requires line_profiler)."""
    from line_profiler import LineProfiler
    prof = LineProfiler()
    for item in items:
        if inspect.isfunction(item):
            prof.add_function(item)
        elif inspect.ismodule(item):
            prof.add_module(item)
        elif isinstance(item, str):
            prof.add_module(sys.modules[item])
        else:
            raise TypeError('Inputs must be functions, modules, or module '
                            'names')
    prof.enable()
    yield
    prof.disable()
    prof.print_stats()


@contextmanager
def device_trace(log_dir, device):
    """Captures a torch.profiler trace of the enclosed code: host activity
    always, and the card's kernels and copies where device is a CUDA
    device. On leaving, writes it as a Chrome trace
    (<host>.<ns>.pt.trace.json, as torch.profiler.tensorboard_trace_handler
    names it) into log_dir, for chrome://tracing, Perfetto or TensorBoard's
    profiler plugin. Yields the trace file's path."""
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    path = log_dir / ('%s.%d.pt.trace.json' % (socket.gethostname(),
                                                time.time_ns()))
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield path
        finally:
            if torch.device(device).type == 'cuda':
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(path))
