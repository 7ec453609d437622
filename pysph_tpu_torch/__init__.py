"""pysph_tpu_torch: the PyTorch/CUDA port of pysph_tpu.

Same module layout and Equation contract as ``pysph_tpu``; particle
state is a dict of torch tensors per array, neighbour search is a sorted
cell list, and the pair phases that a hand-written CUDA kernel covers
(``ops/pair_engine.py``) run through it on an NVIDIA card.  Everything
else is eager torch.  This package never imports JAX.
"""

__version__ = '0.1.0'
