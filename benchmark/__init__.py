"""The benchmark of grtrans_tpu_torch: one cell a run (run.py), driven by
BENCHMARK.json and the configuration, traffic and metric files it names."""
