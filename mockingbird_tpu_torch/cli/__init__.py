"""Command-line interface of the port: ``python -m mockingbird_tpu_torch.cli``."""
from .main import main  # noqa: F401
