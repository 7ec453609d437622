"""Standalone SPH equation evaluation over given particle arrays (port of
``pysph_tpu/tools/sph_evaluator.py``): the post-processing workhorse.

``SPHEvaluator(arrays, equations, dim, kernel, domain_manager, config)``
bins the arrays on a ``CellGrid`` (periodic on the axes of
``domain_manager``) and ``evaluate(t, dt)`` runs the equations once on
``config``'s device (the card by default: ``Config()``), writing the
results back into the arrays.  A torch engine pair list that outgrew its
capacity is run again with the capacity grown (``run_sized``), and a
particle beyond the grid is clamped into its edge cell (correct), so one
evaluation needs no redo of its own; a position or h that is not finite
raises ``FloatingPointError`` after it (the binning's flag, one read).
"""

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import Gaussian
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.sph.acceleration_eval import AccelerationEval


class SPHEvaluator(object):
    def __init__(self, arrays, equations, dim, kernel=None,
                 domain_manager=None, config=None):
        self.arrays = arrays
        self.equations = equations
        self.domain_manager = domain_manager
        self.dim = dim
        self.kernel = kernel if kernel is not None else Gaussian(dim=dim)
        self.config = config if config is not None else Config()
        self._create_eval(arrays)

    def evaluate(self, t=0.0, dt=0.1):
        """Evaluate the equations and write the results back to the
        arrays."""
        states = {pa.name: pa.to_device(self.config) for pa in self.arrays}
        self.func_eval.update_and_compute(t, dt, states)
        self.func_eval.grid.check_finite()
        for pa in self.arrays:
            pa.update_from_device(states[pa.name])

    def update(self, update_domain=True):
        """API parity: binning happens in every ``evaluate``."""

    def update_particle_arrays(self, arrays):
        self.arrays = arrays
        self._create_eval(arrays)

    def _create_eval(self, arrays):
        self.grid = CellGrid.from_particles(
            arrays, dim=self.kernel.dim,
            radius_scale=self.kernel.radius_scale,
            domain=self.domain_manager)
        self.func_eval = AccelerationEval(arrays, self.equations,
                                          self.kernel, self.config,
                                          self.grid)
