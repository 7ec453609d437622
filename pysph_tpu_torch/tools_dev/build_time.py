"""Cold builds of the pair libraries of a tree, timed, and their kernels'
registers and spills.

    python3 pysph_tpu_torch/tools_dev/build_time.py [ROOT] [--kinds]
        [--edac]

(as a script, so that no ``pysph_tpu_torch`` is imported before it
chooses one) imports ``pysph_tpu_torch.ops.build`` from the tree at
``ROOT`` (default: this one; a ``git archive`` of another commit under
``build/`` for a before and after on one card), builds the six pair
libraries of ``PAIRS`` into that tree's ``build/`` in parallel, one nvcc
each, and times each build and the whole; with ``--kinds`` then each later
smoothing-kernel kind's library of the five that take kinds
(``build.kind_flags``), in parallel; with ``--edac`` then ``tvf_pair``'s
EDAC library (``ops/tvf_pair.py`` ``EDAC_FLAGS``) alone, with its
kernels' registers and spills.  A library already built is not built
again: run it on a tree whose ``build/`` holds none.  Prints one
JSON line: the seconds, and ``build.resources`` of each default library
(registers, spill store and load bytes of every kernel).
"""

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PAIRS = ('tvf_pair', 'wcsph_pair', 'gtvf_pair', 'dense_pair', 'fused_pair',
         'delta_pair')


def _timed(build, jobs):
    def one(job):
        t = time.perf_counter()
        lib = build.build(*job)
        return lib, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = list(pool.map(one, jobs))
    return done, time.perf_counter() - t0


def main(argv):
    kinds = '--kinds' in argv
    edac = '--edac' in argv
    roots = [a for a in argv if a not in ('--kinds', '--edac')]
    root = Path(roots[0]).resolve() if roots else \
        Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    from pysph_tpu_torch.ops import build
    if Path(build.__file__).resolve().parents[2] != root:
        raise SystemExit('build_time: imported %s, not the tree at %s'
                         % (build.__file__, root))
    done, wall = _timed(build, [(n,) for n in PAIRS])
    out = dict(tree=str(root), pairs_wall_s=wall,
               pairs_s={n: s for n, (_, s) in zip(PAIRS, done)},
               resources={n: build.resources(lib)
                          for n, (lib, _) in zip(PAIRS, done)})
    if kinds:
        jobs = [(n, build.kind_flags(k)) for n in PAIRS if n != 'fused_pair'
                for k in range(build.BASE_KINDS, build.KINDS)]
        done, wall = _timed(build, jobs)
        out.update(kinds_wall_s=wall, kinds_s={
            '%s %s' % (job[0], job[1][0]): s
            for job, (_, s) in zip(jobs, done)})
    if edac:
        from pysph_tpu_torch.ops import tvf_pair
        ((lib, secs),), _ = _timed(build, [('tvf_pair',
                                            tvf_pair.EDAC_FLAGS)])
        out.update(edac_s=secs, edac_resources=build.resources(lib))
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main(sys.argv[1:])
