"""Small utilities: running averages and bit counts (``misc``), the
port's tracer, stage timers and device traces (``profiling``), compact
weight snapshots (``weights_io``)."""
