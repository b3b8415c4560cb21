"""Small utilities: running averages and bit counts (``misc``), stage
timers and device traces (``profiling``), compact weight snapshots
(``weights_io``)."""
