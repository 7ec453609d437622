"""Kernel corrections of Bonet & Lok 1999 (port of
``pysph_tpu/sph/wc/kernel_correction.py``).

``GradientCorrectionPreStep`` sums each dest's moment matrix into the
stride-9 property ``m_mat``; ``GradientCorrection`` then rewrites the
pair symbol ``DWIJ`` in place, pair by pair, with the closed-form solve
of ``linalg.small_solve_cols``, so that the equations after it in the
same pair phase read the corrected gradient.  On the card both phases
run in ``csrc/delta_pair.cu`` (``ops/delta_pair.py``), which repeats
``accept``'s arithmetic.

The mixed corrections need ``loop_all``, which the evaluator does not
run yet (ROADMAP Queue 1 item 21): they raise.
"""

import torch

from pysph_tpu_torch.sph.equation import Equation
from pysph_tpu_torch.sph.wc.linalg import small_solve_cols

_LOOP_ALL = ('%s uses loop_all, which is not ported yet (ROADMAP Queue 1 '
             'item 21)')


class KernelCorrection(Equation):
    """Shepard denominator, Bonet-Lok eq. (53)."""

    def initialize(self, d_idx, d_cwij):
        d_cwij[d_idx] = 0.0

    def loop(self, d_idx, s_idx, d_cwij, s_m, s_rho, WIJ):
        d_cwij[d_idx] += s_m[s_idx] * WIJ / s_rho[s_idx]


class GradientCorrectionPreStep(Equation):
    """Accumulate the moment matrix L^-1 = -sum V dW (x) xij."""

    def __init__(self, dest, sources, dim=2):
        self.dim = dim
        super(GradientCorrectionPreStep, self).__init__(dest, sources)

    def initialize(self, d_idx, d_m_mat):
        for i in range(9):
            d_m_mat[9 * d_idx + i] = 0.0

    def loop(self, d_idx, s_idx, d_m_mat, s_m, s_rho, DWIJ, XIJ):
        V = s_m[s_idx] / s_rho[s_idx]
        n = self.dim
        for i in range(n):
            for j in range(n):
                d_m_mat[9 * d_idx + 3 * i + j] += -V * DWIJ[i] * XIJ[j]


def accept(a, dwij, hij, n, tol):
    """(res, ok) of the correction of one gradient per pair: ``res``
    solves ``a res = dwij`` over the first ``n`` components, and ``ok``
    holds where the L1 norm changes by less than ``tol`` relative."""
    eps = 1.0e-4 * hij
    res = small_solve_cols(a, [dwij[i] for i in range(n)], n)
    res_mag = sum(torch.abs(res[i]) for i in range(n))
    dwij_mag = sum(torch.abs(dwij[i]) for i in range(n))
    change = torch.abs(res_mag - dwij_mag) / (dwij_mag + eps)
    return res, change < tol


class GradientCorrection(Equation):
    """Correct DWIJ in place: DWIJ <- L_a DWIJ, Bonet-Lok eq. (42)/(45).
    Later equations in the same group see the corrected gradient."""

    def __init__(self, dest, sources, dim=2, tol=0.1):
        self.dim = dim
        self.tol = tol
        super(GradientCorrection, self).__init__(dest, sources)

    def loop(self, d_idx, d_m_mat, DWIJ, HIJ):
        n = self.dim
        a = [[d_m_mat[9 * d_idx + 3 * i + j] for j in range(n)]
             for i in range(n)]
        res, ok = accept(a, DWIJ, HIJ, n, self.tol)
        for i in range(n):
            DWIJ[i] = torch.where(ok, res[i], DWIJ[i])


class MixedKernelCorrectionPreStep(Equation):
    """Mixed correction prestep, Bonet-Lok eq. (54)/(57)/(58): needs
    ``loop_all``."""

    def __init__(self, dest, sources, dim=2):
        raise NotImplementedError(_LOOP_ALL % 'MixedKernelCorrectionPreStep')


class MixedGradientCorrection(Equation):
    """Mixed kernel-gradient correction: pairs with
    ``MixedKernelCorrectionPreStep``, which needs ``loop_all``."""

    def __init__(self, dest, sources, dim=2, tol=0.1):
        raise NotImplementedError(_LOOP_ALL % 'MixedGradientCorrection')
