"""Deterministic synthetic data for the LM stack."""
from .pipeline import SyntheticLM  # noqa: F401
