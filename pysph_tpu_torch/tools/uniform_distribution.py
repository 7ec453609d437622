"""Uniform particle distributions (port of
``pysph_tpu/tools/uniform_distribution.py``): a hexagonal close packing
and a simple cubic lattice in 2D, and the number density of the packing
under a kernel."""

import numpy
import torch


def uniform_distribution_hcp2D(dx, xmin, xmax, ymin, ymax,
                               adjust=False):
    """Hexagonal close packing in 2D: rows dy = sqrt(3) dx / 2 apart,
    each shifted by dx / 4 the other way from the one before; with
    ``adjust``, scaled in y to tile the box.  Returns (x, y, dx, dy, xmin,
    xmax, ymin, ymax)."""
    dy = 0.5 * numpy.sqrt(3.0) * dx
    rows = int(numpy.ceil((ymax - ymin) / dy))
    cols = int(numpy.ceil((xmax - xmin) / dx))
    xs, ys = [], []
    for j in range(rows):
        y = ymin + 0.5 * dy + j * dy
        off = 0.25 * dx if j % 2 == 0 else -0.25 * dx
        x = xmin + 0.5 * dx + off + dx * numpy.arange(cols)
        keep = (x > xmin) & (x < xmax)
        xs.append(x[keep])
        ys.append(numpy.full(int(keep.sum()), y))
    x = numpy.concatenate(xs)
    y = numpy.concatenate(ys)
    if adjust:
        ly = rows * dy
        y = ymin + (y - ymin) * (ymax - ymin) / ly
        dy = dy * (ymax - ymin) / ly
    return x, y, dx, dy, xmin, xmax, ymin, ymax


def uniform_distribution_cubic2D(dx, xmin, xmax, ymin, ymax,
                                 nrows=None):
    """A simple cubic lattice of spacing dx, half a spacing in from the
    box's edges.  Returns (x, y, dx, dy, xmin, xmax, ymin, ymax)."""
    dy = dx
    x, y = numpy.mgrid[xmin + 0.5 * dx:xmax:dx,
                       ymin + 0.5 * dy:ymax:dy]
    return x.ravel(), y.ravel(), dx, dy, xmin, xmax, ymin, ymax


def get_number_density_hcp(dx, dy, kernel, h0):
    """The number density at the origin of the hexagonal packing (11 x 11
    particles around it) under ``kernel`` at ``h0``: sum of W."""
    n = 5
    xs, ys = [], []
    for j in range(-n, n + 1):
        off = 0.25 * dx if j % 2 == 0 else -0.25 * dx
        for i in range(-n, n + 1):
            xs.append(i * dx + off)
            ys.append(j * dy)
    x = numpy.array(xs)
    y = numpy.array(ys)
    r = torch.as_tensor(numpy.sqrt(x ** 2 + y ** 2), dtype=torch.float64)
    w = kernel.kernel(None, r, h0)
    return float(torch.sum(w))
