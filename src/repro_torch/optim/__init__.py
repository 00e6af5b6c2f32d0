"""Optimisers and schedules (``adamw``)."""
from . import adamw  # noqa: F401
