"""The benchmark of the PyTorch / CUDA port (``srbh_tpu_torch``).

Run one cell from the checkout's root:
``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``.
``README.md`` says how cells, configurations, traffic mixes and per-layer
metrics are added as files.
"""
