"""How far the Taylor-Green state is from its rounding, after a few steps.

    python3 -m pysph_tpu_torch.tools_dev.tg_conditioning [--device cpu]

``spread(nx, steps, perturb, device)``: ``examples/taylor_green.py`` in
float64 at ``nx`` from its start (``--perturb``), ``steps`` steps on the
torch pair engine, on the kernel engine, and on the torch engine again
from the start with a seeded third of the particles' x moved by one unit
in the last place.  For each prop of ``PROPS``, the kernel engine's
distance from the torch engine's run and the one-ulp run's, each over
the torch run's max |prop|.

The one-ulp run is what rounding alone does: two correct float64 engines
that add their pair terms in another order (the card's ``index_add_``
adds in no fixed order) differ by about as much.  On the unperturbed
lattice the transport accelerations ``auhat avhat`` are sums of terms of
~1e3 that cancel to ~1e-2, so their scaled spread is ~1e-9 after ten
steps; a start perturbed by a tenth of dx leaves every prop ~1e-13 or
less.  ``main`` prints one JSON line a start, with the card's name and
power limit on the card.
"""

import argparse
import json

import numpy as np
import torch

from pysph_tpu_torch.examples.taylor_green import TaylorGreen
from pysph_tpu_torch.tools_dev import common

PROPS = ('x', 'y', 'u', 'v', 'rho', 'p', 'V', 'au', 'av', 'auhat', 'avhat')


def _run(nx, steps, perturb, device, engine, ulp=False):
    app = TaylorGreen()
    app.setup(['--disable-output', '-q', '--device', device, '--engine',
               engine, '--use-double', '--nx', str(nx), '--perturb',
               str(perturb), '--max-steps', str(steps)])
    st = app.solver.states['fluid']
    if ulp:
        sign = np.random.default_rng(0).integers(-1, 2, st['x'].shape[0])
        st['x'].mul_(1.0 + torch.as_tensor(sign * 2.0 ** -52,
                                           dtype=st['x'].dtype,
                                           device=st['x'].device))
    app.solve()
    return app.solver.states['fluid']


def spread(nx=50, steps=10, perturb=0.0, device='cuda'):
    """{prop: (kernel engine's scaled distance, one-ulp run's)}."""
    ref = _run(nx, steps, perturb, device, 'torch')
    kernel = _run(nx, steps, perturb, device, 'kernel')
    ulp = _run(nx, steps, perturb, device, 'torch', ulp=True)
    out = {}
    for p in PROPS:
        scale = max(float(ref[p].abs().max()), 1e-300)
        out[p] = tuple(float((o[p] - ref[p]).abs().max()) / scale
                       for o in (kernel, ulp))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--nx', type=int, default=50)
    parser.add_argument('--steps', type=int, default=10)
    o = parser.parse_args(argv)
    card = common.require_cuda() if o.device == 'cuda' else None
    for perturb in (0.0, 0.1):
        print(json.dumps(dict(
            nx=o.nx, steps=o.steps, perturb=perturb, device=o.device,
            card=card, kernel_vs_torch_and_one_ulp=spread(
                o.nx, o.steps, perturb, o.device))), flush=True)


if __name__ == '__main__':
    main()
