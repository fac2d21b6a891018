"""The benchmark of the PyTorch and CUDA port: one command runs one cell once.

  python3 -m asr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
