"""Metadata-only approval policy and route helper of the PyTorch port."""
from . import policy, route  # noqa: F401
