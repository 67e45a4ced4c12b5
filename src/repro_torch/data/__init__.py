"""Deterministic synthetic LM batches (counterpart of ``repro.data``)."""
from .pipeline import DataConfig, DataIterator, make_batch  # noqa: F401
