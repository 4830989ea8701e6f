"""Deterministic data sources of the port (``pipeline``)."""
