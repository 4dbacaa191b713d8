"""The reference's validation harnesses (``scripts/`` of the JAX package),
one module each under the script's own file name:

* ``drift_lmax8`` — four Lmax-8 blobs, periodic, undamped: energy drift
  sampled in free flight (geometric or conservative law);
* ``drift`` — two Lmax-0 spheres colliding forever, periodic along x;
* ``conservative_probe`` — one Lmax-8 head-on bounce: dE/E of the
  geometric law, of the autograd gradient of its sampled PE, and of the
  conservative law;
* ``packing_n500`` — config 2 settled, its packing fraction;
* ``restitution_curve`` — config 1 over a gamma_n sweep in one ensemble;
* ``cadence_sweep`` — the drum's rebuild step against its plain step and
  particle-steps/s over rebuild cadences;
* ``profile_step`` — the drum's step split by stage.

Each has ``build(...)`` (the script's builder, plus ``device``) and
``main(argv=None)``: ``python -m spherharm_tpu_torch.validation.<name>
[--device cpu]`` prints the script's lines and a ``# RESULT`` line. The
default device is ``cuda``. Where a script reads an environment variable,
the module takes a command-line flag with the same default.
"""
