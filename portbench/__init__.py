"""The benchmark of ``last_torch_tpu_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
line. Configurations, traffic mixes, per-layer metrics and limits are files
found by name under ``configs/``, ``traffic/``, ``metrics/`` and
``limits/``.
"""
