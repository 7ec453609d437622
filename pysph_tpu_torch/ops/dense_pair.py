"""The cell-blocked WCSPH pair kernel: wrapper and launch counter.

``dense_pair`` computes what ``wcsph_pair`` computes (``ops/wcsph_pair.py``:
Continuity, non-tensile Momentum, XSPH and the laminar viscosity of one
dest over at most ``MAX_SOURCES`` sources, with the same per-source term
masks, but for the delta-SPH terms ``DCONT`` and ``DMOM``, which it
refuses), with the same arguments and outputs, on an open or a periodic
grid; ``wcsph_pair_reference`` is the plain version of both.  The engine
``dense`` (``config.py``) plans the WCSPH phase sets onto it; it is the
port's counterpart of the JAX package's dense-slot Pallas engine
(``PYSPH_TPU_RESIDENT=0 PYSPH_TPU_COMPACT=0``).

For CUDA tensors it calls ``csrc/dense_pair.cu`` (built on first use by
``ops/build.py``) once, which launches the source pack (counted in
``ops/cell_pack.py::pack.launches``) and then the walk (one
thread block per tile of x-adjacent dest cells of a row, the neighbour
rows of the packed sources staged in shared memory by bulk copies;
counted in ``dense_pair.launches``); for CPU tensors it calls
``wcsph_pair_reference``.
"""

from pysph_tpu_torch.ops.wcsph_pair import (
    DCONT, DMOM, launch_pair, wcsph_pair_reference)


def dense_pair(dest, dest_cells, write_mask, pre, sources, grid, kernel):
    """Pair terms of one dest over its sources; same arguments and
    result as ``wcsph_pair_reference``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if any(ps.terms & (DCONT | DMOM) for _, _, ps in sources):
        raise ValueError('dense_pair: the delta-SPH terms are wcsph_pair\'s')
    if dest['x'].device.type == 'cpu':
        return wcsph_pair_reference(dest, dest_cells, write_mask, pre,
                                    sources, grid, kernel)
    if dest['x'].device.type != 'cuda':
        raise ValueError('dense_pair: no kernel for device %s'
                         % dest['x'].device)
    return launch_pair('dense_pair', dense_pair, dest, dest_cells,
                       write_mask, pre, sources, grid, kernel)


#: kernel launches since the last reset (set to 0 to reset)
dense_pair.launches = 0
