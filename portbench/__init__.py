"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell (``run.py``); ``BENCHMARK.json`` at the repository's
root lists the cells and metrics."""
