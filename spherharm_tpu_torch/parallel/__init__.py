"""Parallel drivers: the replica ensemble (``ensemble.py``) and the slab
decomposition (``halo.py``, with its dry run in ``dryrun.py``)."""
