"""Dam-break geometry (port of ``pysph_tpu/examples/db_geometry.py``:
``DamBreak3DGeometry``), vectorized with numpy masks."""

import numpy

from pysph_tpu_torch.base.utils import get_particle_array_wcsph


class DamBreak3DGeometry(object):
    """SPHERIC Test 2 geometry (reference _db_geometry.py:250)."""

    def __init__(self, container_height=1.0, container_width=1.0,
                 container_length=3.22, fluid_column_height=0.55,
                 fluid_column_width=1.0, fluid_column_length=1.228,
                 obstacle_center_x=2.5, obstacle_center_y=0,
                 obstacle_length=0.16, obstacle_height=0.161,
                 obstacle_width=0.4, nboundary_layers=5,
                 with_obstacle=True, dx=0.02, hdx=1.2, rho0=1000.0):
        self.container_width = container_width
        self.container_length = container_length
        self.container_height = container_height
        self.fluid_column_length = fluid_column_length
        self.fluid_column_width = fluid_column_width
        self.fluid_column_height = fluid_column_height
        self.obstacle_center_x = obstacle_center_x
        self.obstacle_center_y = obstacle_center_y
        self.obstacle_width = obstacle_width
        self.obstacle_length = obstacle_length
        self.obstacle_height = obstacle_height
        self.nboundary_layers = nboundary_layers
        self.dx = dx
        self.hdx = hdx
        self.rho0 = rho0
        self.with_obstacle = with_obstacle

    def get_max_speed(self, g=9.81):
        return numpy.sqrt(2 * g * self.fluid_column_height)

    def create_particles(self, **kwargs):
        dx = self.dx
        ghostlims = self.nboundary_layers * dx
        cl = self.container_length
        ch = self.container_height
        cw2 = 0.5 * self.container_width
        xmin, xmax = -ghostlims, cl + ghostlims
        zmin, zmax = -ghostlims, ch + ghostlims
        ymin, ymax = -cw2 - ghostlims, cw2 + ghostlims
        eps = 0.1 * dx
        xx, yy, zz = numpy.mgrid[xmin:xmax + eps:dx,
                                 ymin:ymax + eps:dx,
                                 zmin:zmax + eps:dx]
        x, y, z = xx.ravel(), yy.ravel(), zz.ravel()

        fmask = ((x > 0) & (x <= self.fluid_column_length) &
                 (y > -cw2) & (y < cw2) &
                 (z > 0) & (z <= self.fluid_column_height))
        obl2 = 0.5 * self.obstacle_length
        obw2 = 0.5 * self.obstacle_width
        ocx, ocy = self.obstacle_center_x, self.obstacle_center_y
        omask = ((x >= ocx - obl2) & (x <= ocx + obl2) &
                 (y >= ocy - obw2) & (y <= ocy + obw2) &
                 (z > 0) & (z <= self.obstacle_height))
        bmask = ((y <= -cw2) | (y >= cw2) | (x >= cl) | (x <= 0) |
                 (z <= 0))

        def make(name, mask):
            return get_particle_array_wcsph(
                name=name, x=x[mask], y=y[mask], z=z[mask])

        fluid = make('fluid', fmask)
        boundary = make('boundary', bmask)
        particles = [fluid, boundary]
        if self.with_obstacle:
            particles.append(make('obstacle', omask))

        h0 = self.hdx * dx
        m0 = self.rho0 * dx ** 3
        for pa in particles:
            pa.m = numpy.full(pa.get_number_of_particles(), m0)
            pa.h = numpy.full(pa.get_number_of_particles(), h0)
            pa.rho = numpy.full(pa.get_number_of_particles(), self.rho0)
        counts = tuple(p.get_number_of_particles() for p in particles)
        print('3D dam break with %d fluid, %d boundary%s particles' %
              (counts[0], counts[1],
               ', %d obstacle' % counts[2] if self.with_obstacle
               else ''))
        for pa in particles[1:]:
            pa.set_output_arrays(['x', 'y', 'z', 'rho', 'm', 'h', 'p',
                                  'tag', 'pid', 'gid'])
        return particles
