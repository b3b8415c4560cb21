"""The harness: manifest lookup, the device, the timed window's result line,
the device trace and the per-layer readers' inputs.  It names no cell,
configuration, traffic mix or metric: those are files found by the names
in ``BENCHMARK.json``."""
