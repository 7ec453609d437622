"""Compressible gas dynamics (port of ``pysph_tpu/sph/gas_dynamics/``):
the grad-h MPM equations of ``GasDScheme`` (``basic.py``)."""
