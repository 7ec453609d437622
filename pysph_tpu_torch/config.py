"""Run configuration: device, float dtype and pair engine.

float32 is the speed path and float64 (``--use-double``) the validation
path, as in ``pysph_tpu``.  The device is never guessed: a ``cuda``
device with no card fails at the first allocation instead of quietly
running on the CPU.

``engine`` picks how eligible pair phases run:

- ``'kernel'`` (default): through the wrapper of a hand-written pair
  kernel (``ops/wcsph_pair.py``, ``ops/gtvf_pair.py``; planned by
  ``ops/pair_engine.py``), which launches the CUDA kernel for CUDA
  tensors and uses its plain torch version for CPU tensors;
- ``'dense'``: the WCSPH phase sets through ``ops/dense_pair.py`` (one
  thread block per dest cell), every other set through the torch pair
  engine; the port's counterpart of the JAX package's dense-slot Pallas
  engine (``PYSPH_TPU_RESIDENT=0 PYSPH_TPU_COMPACT=0``);
- ``'torch'``: every pair phase through the generic torch pair engine
  (``sph/acceleration_eval.py``).
"""

from dataclasses import dataclass, field

import torch

ENGINES = ('kernel', 'dense', 'torch')


@dataclass
class Config:
    device: torch.device = field(
        default_factory=lambda: torch.device('cuda'))
    dtype: torch.dtype = torch.float32
    engine: str = 'kernel'

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError('dtype must be float32 or float64, got %r'
                             % (self.dtype,))
        if self.engine not in ENGINES:
            raise ValueError('engine must be one of %s, got %r'
                             % (ENGINES, self.engine))
