"""A frozen, plain-PyTorch copy of the port's coupled step and builders.

The benchmark's reference: the modules of ``wrf_partmc_tpu_torch`` that
``entry.build``, ``cares.build_cares_shape`` and ``CoupledModel`` run, as
they stood when the benchmark was written, with the hand-written kernels
taken out (K1 -> ``ops.tridiag.solve_scan``, K2/K3 ->
``ops.place.*_plain``, K4 -> ``utils.rng.draw_plain``, K5 ->
``models.partmc.optics.mie_fit_sums_plain``) and a Mie table cache of its
own.  It imports nothing outside this package but torch and numpy, so a
later change to the program cannot change it.  ``../README.md`` lists
every difference from the program it was copied from.
"""
