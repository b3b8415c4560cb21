"""Traffic drivers: one module a kind of traffic, run by the parameters of
``benchmark/traffic/<cell traffic>.json``."""
