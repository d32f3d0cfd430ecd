"""HTTP toolbox console and JSON/wav API of the port (``serve(...)``)."""
from .http import serve  # noqa: F401
