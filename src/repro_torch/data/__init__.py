"""Seekable synthetic data sources of the LM trainer."""
