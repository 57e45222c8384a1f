"""The benchmark of the PyTorch / CUDA port (``tvretrieval_tpu_torch``):
full-corpus XML retrieval on one H100. ``python3 benchmarks/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell
once; ``BENCHMARK.json`` at the repository's root lists the cells."""
