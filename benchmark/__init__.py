"""The benchmark of the PyTorch and CUDA port, ``aki_torch``: one command runs
one cell once (``benchmark/run.py``); see ``BENCHMARK.json`` for the cells."""
