"""Deployments, one module a builder, named by a configuration's
``"builder"`` and found by that name. Each has

* ``geometry(cfg, geo)``: adds the box, the walls, the cutoff and the
  skin to ``geo`` (plain numbers, worked out from the configuration and
  the benchmark's own shape tables in ``geo["ref_shapes"]``);
* ``simulation(cfg, geo, shapes, params, device, axis, cuda_graphs)``:
  the program's simulation of it, from the program's shape tables and
  parameters (``harness/program.build``); ``axis`` is a rank's
  transport where the builder shards.
"""
