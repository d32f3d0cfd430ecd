"""The benchmark of the PyTorch/CUDA port (``mockingbird_tpu_torch``): see ``run.py``."""
