"""Synthetic datasets and micro-batching (port of ``repro/data/``)."""
