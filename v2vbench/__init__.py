"""The benchmark of ``anyv2v_torch`` on one NVIDIA H100: cells of a model
configuration under a traffic mix, named in ``BENCHMARK.json``; see
``v2vbench/run.py``."""
