"""Basic SPH equations of the main path (port of
``pysph_tpu/sph/basic_equations.py``): pair values are per-pair tensors."""

from pysph_tpu_torch.sph.equation import Equation


class SummationDensity(Equation):
    """rho_a = sum_b m_b W_ab."""

    def initialize(self, d_idx, d_rho):
        d_rho[d_idx] = 0.0

    def loop(self, d_idx, d_rho, s_idx, s_m, WIJ):
        d_rho[d_idx] += s_m[s_idx] * WIJ


class ContinuityEquation(Equation):
    """drho_a/dt = sum_b m_b v_ab . grad W_ab."""

    def initialize(self, d_idx, d_arho):
        d_arho[d_idx] = 0.0

    def loop(self, d_idx, d_arho, s_idx, s_m, DWIJ, VIJ):
        vijdotdwij = (DWIJ[0] * VIJ[0] + DWIJ[1] * VIJ[1] +
                      DWIJ[2] * VIJ[2])
        d_arho[d_idx] += s_m[s_idx] * vijdotdwij


class XSPHCorrection(Equation):
    """XSPH position stepping: writes the corrected advection velocity
    into ax, ay, az."""

    def __init__(self, dest, sources, eps=0.5):
        self.eps = eps
        super(XSPHCorrection, self).__init__(dest, sources)

    def initialize(self, d_idx, d_ax, d_ay, d_az):
        d_ax[d_idx] = 0.0
        d_ay[d_idx] = 0.0
        d_az[d_idx] = 0.0

    def loop(self, s_idx, d_idx, s_m, d_ax, d_ay, d_az, WIJ, RHOIJ1, VIJ):
        tmp = -self.eps * s_m[s_idx] * WIJ * RHOIJ1
        d_ax[d_idx] += tmp * VIJ[0]
        d_ay[d_idx] += tmp * VIJ[1]
        d_az[d_idx] += tmp * VIJ[2]

    def post_loop(self, d_idx, d_ax, d_ay, d_az, d_u, d_v, d_w):
        d_ax[d_idx] += d_u[d_idx]
        d_ay[d_idx] += d_v[d_idx]
        d_az[d_idx] += d_w[d_idx]
