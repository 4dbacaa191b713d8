"""Parallel drivers: the replica ensemble (``ensemble.py``)."""
