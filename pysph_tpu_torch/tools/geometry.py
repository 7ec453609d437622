"""Geometry generators on the host (numpy), the part of
``pysph_tpu/tools/geometry.py`` that dam_break_2d uses."""

import numpy as np


def get_2d_tank(dx=0.05, base_center=(0.0, 0.0), length=1.0, height=1.0,
                num_layers=1, outside=True, staggered=False, top=False):
    """Open 2d tank: base on the x-axis, side walls along y."""
    dy = dx
    fac = 1 if outside else 0
    if staggered:
        dx = dx / 2
    start = fac * (1 - num_layers) * dx
    end = fac * num_layers * dx + (1 - fac) * dx
    x, y = np.mgrid[start:length + end:dx, start:height + end:dy]
    topset = 0 if top else 10 * height
    if staggered:
        topset += dx
        y[1::2] += dx
    offset = 0 if outside else (num_layers - 1) * dx
    cond = ~((x > offset) & (x < length - offset) &
             (y > offset) & (y < height + topset - offset))
    return (x[cond] + base_center[0] - length / 2,
            y[cond] + base_center[1])


def get_2d_block(dx=0.01, length=1.0, height=1.0, center=(0.0, 0.0)):
    """Filled rectangular block of particles."""
    n1 = int(length / dx) + 1
    n2 = int(height / dx) + 1
    x, y = np.mgrid[-length / 2.0:length / 2.0:n1 * 1j,
                    -height / 2.0:height / 2.0:n2 * 1j]
    return x.ravel() + center[0], y.ravel() + center[1]
