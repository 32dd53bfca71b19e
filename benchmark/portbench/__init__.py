"""The harness of the port's benchmark: inputs, the traffic driver, the
frozen roofline, the profiler's reading and the comparison with the plain
reference (benchmark/run.py runs a cell)."""
