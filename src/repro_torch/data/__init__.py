"""Synthetic data for the model substrate (numpy only)."""
from . import lm_data  # noqa: F401
