"""The benchmark of the PyTorch and CUDA port (``selfc_tpu_torch``): run a
cell with ``python3 -m benchmark.run``."""
