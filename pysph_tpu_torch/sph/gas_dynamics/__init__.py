"""Compressible gas dynamics (port of ``pysph_tpu/sph/gas_dynamics/``):
the grad-h MPM and ADKE equations of ``GasDScheme`` and ``ADKEScheme``
(``basic.py``), Godunov SPH, ``GSPHScheme``'s (``gsph.py``, with the
Riemann solvers of ``riemann_solver.py``), and ``TSPHScheme`` with its
equations (``tsph.py``)."""
