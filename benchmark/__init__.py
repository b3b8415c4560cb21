"""The benchmark of upcc_tpu_torch (``python3 -m benchmark.run``)."""
