"""The port's benchmark: TRPO policy updates per second on one H100.

``python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Every configuration, traffic mix, per-layer metric, model
family and limit is a file of its own under this folder, found by the
name that ``BENCHMARK.json`` gives it (``spec.py``).
"""
