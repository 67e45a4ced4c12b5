"""Perf records: the schema of ``--record``'s JSON."""
