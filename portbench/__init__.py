"""Benchmark of trpx_tpu_torch on NVIDIA cards: ``python3 -m portbench.run``."""
