"""The port's benchmark harness: one cell of BENCHMARK.json, run once.

Run from the root of a checkout:
    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It measures elbencho_tpu_torch only and imports nothing of elbencho_tpu or
JAX. Configurations, traffic mixes and metric readers are files under this
folder, found by the names in BENCHMARK.json.
"""
