"""Synthetic data for the model substrate (numpy only)."""
from . import gnn_data, lm_data, recsys_data  # noqa: F401
