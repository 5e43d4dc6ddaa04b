"""The benchmark of ``mcrt_tpu_torch`` on an NVIDIA H100: one command runs
one cell of ``BENCHMARK.json`` once (``run.py``).  See ``README.md``."""
