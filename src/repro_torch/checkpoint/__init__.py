"""Atomic, asynchronous checkpointing (``Checkpointer``)."""
from .checkpointer import Checkpointer  # noqa: F401
