"""Synthetic data pipeline (``pipeline``)."""
