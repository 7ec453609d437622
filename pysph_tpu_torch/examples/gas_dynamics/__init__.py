"""Compressible gas-dynamics examples (port of
``pysph_tpu/examples/gas_dynamics/``): the Sod shock tube and the 2D
Sedov blast under ``GasDScheme``."""
