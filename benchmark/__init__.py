"""The benchmark of ``tpu_joints_torch`` (``BENCHMARK.json``): one cell run by
``python3 -m benchmark.run``; configurations, traffic mixes and per-layer
metric readers are files of their own under this folder."""
