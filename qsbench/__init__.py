"""qsbench: the benchmark of the PyTorch / CUDA port (``quantum_simulator_tpu_torch``).

``python qsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; see ``README.md``.
"""
