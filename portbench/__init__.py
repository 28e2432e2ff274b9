"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell a
run (``run.py``), cells, configurations, mixes and metrics found by name
(``spec.py``)."""
