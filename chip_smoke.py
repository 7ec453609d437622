"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure propagates; the exit code is then not 0):

1. the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build the seventeen CUDA sources of ``pysph_tpu_torch/csrc`` (the
   fourteen pair and probe kernels, IISPH's pressure solve ``iisph_solve``,
   the source pack ``cell_pack`` and the binning ``bin_cells``), ``tvf_pair``'s EDAC library (``-DTVF_EDAC``) and the
   libraries of the later smoothing-kernel kinds (4-7,
   ``csrc/shapes.cuh``) of the five pair kernels that take kinds, with
   nvcc, one process per library, all in parallel, each one's seconds
   printed, and print ``-Xptxas -v``;
3. ``wcsph_pair`` against its plain torch version on the card, on the
   dam_break_3d state with a seeded velocity and density perturbation:
   dx=0.04 (24,672 particles) in float64 (scaled error <= 1e-10) and
   float32 (<= 1e-4 of max|ref|), and dx=0.02 (143,051 particles, the
   main path's shapes) in float32, where both are also timed (the kernel
   with its source pack, eagerly and replayed from a CUDA graph) and the
   work is counted (candidates and ``visited``); the pack of each call
   (``ops/cell_pack.py``) equal to its plain version, and timed; then 10
   steps of dam_break_3d
   at dx=0.04 in float64 on the kernel engine against the torch engine
   (<= 1e-9 of max|ref|); then each later kind (``WendlandQuinticC4``,
   ``WendlandQuinticC6``, ``SuperGaussian`` in 2D and 3D) in every pair
   kernel that takes kinds against its plain version in float64 and
   float32 (``tools_dev/kind_check.py``: the Taylor-Green vortex at nx=50
   under ``tvf``, ``gtvf``, ``wcsph`` on both engines and ``wcsph
   --delta-sph``, dam_break_3d at dx=0.04 on both engines and with
   ``--delta-sph``; 0 flipped accept decisions);
4. the solver's chunks (``tools_dev/time_chunks.py::gate``): on each of
   the paths in float64 at a small size (dam_break_3d dx=0.04, also
   with its fluid at 3 m/s so that the binning is rebuilt inside the
   chunks, with ``--delta-sph``, its strided ``m_mat`` and ``gradrho`` in
   the chunk's write-back, and with ``--engine dense --delta-sph``, whose
   delta-SPH groups run on the torch pair engine inside the graphs; GTVF
   dx=0.02; the 2D WCSPH dam break dx=0.02 under PEC and under Euler,
   TVDRK3, LeapFrog and PEFRL; the drop nx=40 in a grid that just holds
   it), 30
   steps with ``n_damp = 0`` in chunks of 10 replayed from CUDA graphs
   against the eager per-step loop: every prop within 1e-12 of its max,
   t, dt, the count and the binnings that ran exactly equal, one landing
   on an output time inside a chunk, one replay a chunk, and the drop's
   grid grown and its chunk captured again;
5. the main path: ``pysph_tpu_torch.examples.dam_break_3d`` at dx=0.02
   in float32 for ``STEPS`` steps (``_drive``), per step (``chunk_steps
   = 1``) and in chunks of 10 (50 damped steps, then chunks), each with
   its median ms/step (per step: host clock at each step's start, the
   card synchronised; in chunks: host clock after each chunk's read,
   over the chunks after the capture) and the kernel's and the pack's
   launches counted (in chunks: the eager ones, and those a capture
   counts x the replays), the binning's too (``bin_cells``: the reuse
   test once a step, and the binnings that ran), the captures, replays
   and host reads, and a finite final state; then ``bin_cells`` against
   its plain version on the run's final state (``tools_dev/bin_check.py``:
   forced, kept, stale but inactive, rebuilt, kept; every tensor of the
   handle exactly equal, and unchanged under the flag 0) and its time an
   eval in a CUDA graph, kept and rebuilt; the same run again under the
   reference's other binning configuration (``bin_every_eval`` on cells
   1.001 times the support, ``time_chunks.CONFIGS``), per step and in
   chunks; GTVF and the drops below are driven and checked the same way;
   then dam_break_3d ``--kernel WendlandQuinticC4`` (``wcsph_pair`` at
   kind 4, a library of its own): against its plain version at dx=0.02 in
   float32, timed there with its open-grid kernels' registers and spills,
   and the path as the main path under the binning reuse;
6. the delta-SPH dam break (``dam_break_3d --delta-sph``, the
   BASELINE's): ``delta_pair`` (the moment matrix and the corrected
   density gradient) and ``wcsph_pair``'s delta terms against their plain
   versions (``tools_dev/delta_check.py``) at dx=0.04 perturbed in
   float64 and float32, and at dx=0.02 on the path's state after its 50
   damped steps in float32, with the pairs whose accept decision differs
   counted, and the linked pair there (``delta_check.check_linked``: the
   moment launch's neighbour list equal to ``neighbours_reference``, the
   gradient launch that reads it equal to the walking one bit for bit,
   0 flips, one pack for the two; the dests past the list's capacity,
   its largest count and the capacity printed); timed there (the linked
   pair against the two walking launches of before the link and each
   launch alone, graph replays alternated in one process, and the
   fluid's ``wcsph_pair`` call with the delta terms against without
   them), the launches of one eval counted (2 ``delta_pair``, 3
   ``wcsph_pair``, 4 packs); then the path as the main path, under
   ``reuse`` only (3 ``wcsph_pair`` and 2 ``delta_pair`` launches an
   eval, a pack for each but the linked gradient, peak device memory);
   its chunks against the per-step loop in float64 are a gate of phase 4
   (``dam_break_3d dx=0.04 delta``); then ``--engine dense --delta-sph``
   at dx=0.02 in float32, its delta-SPH groups on the torch pair engine,
   for its 50 damped steps and 3 chunks per step and in captured chunks,
   with one overflow forced (the capacities cut before the first chunk):
   grown, redone and captured again;
7. ``gtvf_pair`` against its plain version on the GTVF dam break
   (``examples.dam_break_2d --scheme gtvf``) with a seeded perturbation,
   every phase set of both evaluators: dx=0.02 (7,603 particles) in
   float64 and float32, dx=0.004 (137,803 particles, the path's shapes)
   in float32, timed and counted there; infinities (``rhodiv`` next to
   the walls) must match exactly; the pack of each call (the GTVF planes)
   equal to its plain version; then 10 steps at dx=0.02 in float64 on
   the kernel engine against the torch engine (<= 1e-9 of max|ref|);
8. the GTVF path at dx=0.004 in float32, as the main path (chunks from
   step 0; 2 launches in the initial eval, 5 a step, one pack a launch),
   every pair phase of both evaluators on the kernel, and a finite final
   state (``rhodiv`` aside); then the 2D WCSPH dam break
   (``examples.dam_break_2d``'s default ``--scheme wcsph``: PEC,
   WendlandQuintic, the Hughes-Graham walls): ``wcsph_pair`` against its
   plain version with a seeded perturbation at dx=0.02 and dx=0.004
   (137,803 particles, the path's shapes) in float64 and float32, timed
   and counted at dx=0.004 in float32, and the path as the main path (50
   damped steps, then chunks; 2 launches in the initial eval, 2 a step);
   then Euler, TVDRK3, LeapFrog and PEFRL each driving its equations at
   dx=0.02 in float64 for 3 captured chunks, a capture counting 2
   ``wcsph_pair`` launches an eval (1, 3, 1 and 4 evals a step); then the
   Taylor-Green vortex (``examples.taylor_green``, ``--scheme tvf``: a
   box periodic in x and y, ``QuinticSpline``, PEC): ``tvf_pair``
   against its plain version on a seeded perturbation at nx=50 in
   float64 and float32 and at nx=400 (160,000 particles, the path's
   shapes) in float32, each also with a tenth of the particles on the
   box's edges and corners (``tools_dev/tvf_check.py``), timed and
   counted at nx=400; 10 steps at nx=50 (``--perturb 0.1``) in float64
   on the kernel engine against the torch engine; then the path at
   nx=400 as the main path under the binning reuse (2 launches in the
   initial eval, 2 a step, both pair groups on ``tvf_pair``), with
   max |v| against the exact decay and the L1 error of |v| after its 200
   steps; its chunks against the per-step loop in float64 are a gate of
   phase 4 (``taylor_green nx=40``, particles wrapping across the box);
   then the same vortex under ``--scheme wcsph`` (``WCSPHScheme`` with
   ``LaminarViscosity``, PEC: ``wcsph_pair``, and under ``--engine
   dense`` ``dense_pair``) and ``--scheme gtvf`` (``GTVFScheme`` without
   walls, with ``MomentumEquationViscosity``, two evaluators a step:
   ``gtvf_pair``), each kernel's periodic branch against its plain
   version on the path's calls (``tvf_check.calls``) at nx=50 in float64
   and float32, each also with a tenth of the particles on the box's
   edges and corners, and at nx=400 in float32, timed and counted there;
   the kernel engine against the torch engine at nx=50 from
   ``--perturb 0.1`` in float64 for 10 steps (<= 1e-9 of max|ref|); the
   path at nx=400 as the main path under the binning reuse (1 launch in
   the initial eval and 1 a step; ``gtvf``: 1 and 3), every dest on the
   kernel, with its decay held to the JAX package's for the same scheme,
   nx, steps and dtype (``JAX_DECAY``: max |v| over the exact decay
   within 1e-3 of the JAX figure, the L1 error of |v| within 5% of it);
   then the same for ``--scheme wcsph`` with each of ``--delta-sph``
   (``delta_pair``'s periodic branch, linked, twice an eval, with its
   accept decisions' flips counted and 0, and ``wcsph_pair`` with the
   delta terms and ``LaminarViscosityDeltaSPH``), ``--summation-density``
   (``wcsph_pair`` twice an eval: the density launch and the main one)
   and ``--tensile-correction`` (``wcsph_pair``'s tensile term); their
   chunks against the per-step loop are gates of phase 4
   (``taylor_green <scheme>[ <option>] nx=40``); then the Adami walls on
   ``tvf_pair`` (its no-slip term) and the TVF wall examples
   (``_tvf_wall_phase``): every pair kernel of their evals (each fluid's
   density and momentum on ``tvf_pair``, linked; the wall's velocity and
   pressure on ``gtvf_pair``) against its plain version on the cavity's
   open grid at nx=50 and Poiseuille's channel, periodic in x, in float64
   and float32, each also with a tenth of the fluid on its box's edges
   and corners, and on Rayleigh-Taylor and the periodic cylinders in
   float32, the linked pair bit for bit the walk on each; the cavity at
   nx=400 (160,000 fluid and 8,921 wall particles) in float32, timed
   there; the cavity at nx=400 as the main path under the binning reuse
   (every dest on a kernel, one linked pair, no dest past its list), its
   fluid's max speed and kinetic energy within 1e-3 of the JAX package's
   (``JAX_CAVITY``); Poiseuille's and Couette's flow to their tf = 100,
   their ``post_process`` error against the exact profile within 0.005
   of the JAX package's (``JAX_PROFILE``); Rayleigh-Taylor and the
   periodic cylinders as the main path; their chunks against the
   per-step loop are gates of phase 4 (``cavity nx=20``,
   ``poiseuille``); then ``EDACScheme``'s three runs (``_edac_phase``:
   ``taylor_green``, ``cavity`` and ``dam_break_2d --scheme edac``):
   ``tvf_pair``'s EDAC terms and ``gtvf_pair``'s EDAC wall set against
   their plain versions at a small size (nx=50, dx=0.02) in float64 and
   float32, with and without the edge particles, and at the paths'
   sizes (Taylor-Green and the cavity at nx=400, the dam break at
   dx=0.004) in float32, the linked calls (the density launch emitting,
   the cavity's mean-pressure launch and each momentum launch reading
   its list) bit for bit the walk, the dests whose ``nnbr`` differs
   counted (0 from the perturbed starts; at each path's own start
   printed), timed there with the EDAC library's registers and spills;
   each path as the main path under the binning reuse, its launches
   against the plan's count, its gate: the decay within 1e-3 (ratio) and
   5% (L1) of ``JAX_DECAY['edac']`` and within 5% of the exact one, the
   cavity within 1e-3 of ``JAX_CAVITY_EDAC``, the dam break's wall
   pressure >= 0 after the run and, at dx=0.02 per step, before every
   step, with its front and kinetic energy within 1e-3 of
   ``JAX_DAM_BREAK_EDAC``; their chunks against the per-step loop are
   gates of phase 4 (``taylor_green edac nx=40``, ``cavity edac nx=20``,
   ``dam_break_2d edac dx=0.04``); then ``gtvf_pair`` at kind 4 on the
   Taylor-Green vortex's ``--scheme gtvf --kernel WendlandQuinticC4`` at
   nx=400, against its plain version and timed; then ``IISPHScheme``'s
   three runs (``_iisph_phase``: ``taylor_green``, ``elliptical_drop``
   and ``dam_break_2d --scheme iisph``): ``iisph_pair``'s six phase sets
   against their plain versions on every pair call of one evaluation
   (each pressure sweep's two calls among them) from the run's own state
   after 3 steps of a jittered start (``tools_dev/iisph_check.py``), at a
   small size (nx=50, nx=40, dx=0.02) in float64 and float32 with and
   without a tenth of the fluid on its box's edges and corners (where
   the solve sweeps 30 times) and at the path's size (nx=400, 160,000
   particles; nx=200, 125,623; dx=0.004, 137,803) in float32, the chain
   of linked calls (the dest's first call that sees all its sources
   emitting its neighbour list, every later one reading it, the fluid's
   ``dijpj`` over fewer sources) bit for bit the walk, each pack exact;
   timed there (the evaluation linked and walking, each phase set alone,
   the plain versions) with the library's registers and spills; then
   ``iisph_solve``, the pressure group's every sweep in one cooperative
   launch, on the same states (``iisph_check.check_solve``): within the
   tolerance of its plain version with the same sweeps, and bit for bit
   the per-launch chain (``iisph_pair``'s ``dijpj`` and pressure launches
   and the torch ``post_loop``) in ``p``, ``piter``, ``compression`` and
   ``dijpj`` where the sweeps agree, at the call's tolerance, at one that
   forces 30 sweeps and at one that stops at 2; timed at the path's size
   (an evaluation as the path runs it now, the solve alone, its plain
   version) with its registers and spills; each path for 200 steps in
   chunks of 10 replayed from a CUDA graph and per step
   (``_iisph_drive``): 4 (6) ``iisph_pair`` and 1 ``iisph_solve``
   launches a step and a pack each, no host read of ``converged``, the
   sweeps of every evaluation equal both ways, host reads a step, a
   replayed step's device busy time and idle share (``_iisph_idle``);
   its gate, in chunks, against the JAX package's figures within 1e-3
   (``JAX_IISPH``: Taylor-Green nx=400's decay ratio, the drop nx=50's
   max |y| at tf, the dam break dx=0.02's front and energy after 10
   steps); the chunks against the per-step loop in float64 are gates of
   phase 4 (``taylor_green iisph nx=40``, ``dam_break_2d iisph
   dx=0.04``); then ``GasDScheme``'s two runs (``_gasd_phase``:
   ``examples/gas_dynamics/shocktube.py`` and ``sedov.py``): both of
   ``gasd_pair``'s sets (the grad-h density, ``MPMAccelerations``)
   against their plain versions (``tools_dev/gasd_check.py``: every
   output within the dtype's tolerance of max|ref|, ``dt_cfl``'s MAX
   among them, the pairs and every dest's pair count equal) on a jittered
   Sedov lattice at nx=41 and the shock tube at nl=80 (h jumping by 8 at
   the diaphragm) in float64 and float32, and on the blast at its full
   width, nx=401 (160,801 particles), after 50 steps in float32; GHI
   against ``Gaussian.gradient_h`` in 1D and 2D; every other kernel with
   a shape function in both dtypes (``gasd_check.kinds``; each later kind
   a library of its own); timed at full width with the library's
   registers and spills, beside the bound of the pairs alone; the shock
   tube at nl=320 in float64 to tf = 0.15, its L1 errors against the exact Riemann
   solution within 1e-3 of the JAX package's (``JAX_SHOCKTUBE``); the
   Sedov blast at nx=41 in float32 for 200 steps, its shell radius, peak
   density and total energy within 1e-3 of the JAX package's
   (``JAX_SEDOV``); the gated density sweep (``gasd_sweep``) against its
   plain version on every sweep of an iteration (``_gasd_sweep_checks``:
   the Sedov lattice at nx=41 and the shock tube at nl=80 in both
   dtypes, a list of one entry, Sedov nx=401 after 50 steps in float32,
   where float32 may end a particle converged on one side only where its
   step lies within rounding of htol, counted), its neighbour list
   against ``pair_link.neighbours_reference`` and the momentum launch on
   it bit for bit the walk, timed; 20 steps of Sedov nx=401 under
   ``mpm`` and ``gsph`` in chunks against the per-step loop bit for bit
   (``_gasd_chunk_gate``); the blast at nx=401 for 200 steps in chunks of
   10 (the sweeps gated on the card, at most 0.2 host reads a step) and
   per step (``_gasd_drive``): ms/step over steps 20-199, the sweeps,
   slots, redos, host reads, launches and binnings a step, the largest
   hmax/hmin, the candidates a dest, the drift in total energy, and a
   step's device idle share and time by layer from a ``torch.profiler``
   trace (a replay of the chunk's graph); the binning's guards
   (``_bin_guard_phase``: 160,801 particles in one cell and on the
   clamped edges of a 4 x 4 grid sorted as ``torch.sort(cid,
   stable=True)``, a NaN state not binned and raising, a chunked run
   with a NaN h raising ``FloatingPointError`` at its read, before its
   first chunk and after it (with no redo), each within
   ``BIN_GUARD_SECONDS``) and its times on the blast's final state beside
   ``torch.sort``'s; then ``GSPHScheme`` on ``gsph_pair`` and
   ``ADKEScheme`` on ``gasd_pair``'s ADKE sets (``_gas_schemes_phase``):
   the eleven device Riemann solvers against the torch ones on Toro's
   problems and 10^5 seeded states in both dtypes; every set of both
   schemes against its plain version on jittered small states (the
   accuracy test at 24^2 and the hydrostatic box at nx=20, periodic, the
   shock tube at nl=80 with its free ends) in float64 and float32, the
   acceleration under every Riemann solver, limiter, interpolation,
   interface, the hybrid blend and the conduction, and at full width
   (the accuracy test at 256^2, ``gsph`` in float32, ``adke`` in float64;
   the shock tube at nl=320, ``adke`` in float32), the pairs and every
   dest's count equal; accuracy_test_2d (gsph, mpm, adke) at 64^2 to tf,
   hydrostatic_box (gsph, mpm, adke) at nx=50 for 200 steps and the shock
   tube (gsph, adke) at nl=320 to tf in float64, each within CAVITY_TOL
   of the JAX package's figures (``JAX_ACCURACY``, ``JAX_HYDROSTATIC``,
   ``JAX_SHOCKTUBE_SCHEMES``); the accuracy test under gsph at 256^2 in
   float32: 20 steps in chunks bit for bit the per-step loop, 200 steps
   timed in chunks of 10 and per step with a step's launches, host
   reads, device time by layer and idle share (``_accuracy_drive``), and
   the run to tf = 1.0 with its L1 under ``ACCURACY_L1_BAR``; each set
   timed there beside its bound with ``gsph_pair``'s registers and
   spills; also each binning's periodic counts in those runs,
   the linked pair (``gasd_check.check_gsph_linked``: the acceleration
   on the gradients launch's list bit for bit the walking launch; its
   list against ``neighbours_reference``) on the small states in both
   dtypes and at full width in float32, the four pair launches of an
   evaluation after the first chunk at full width
   (``gasd_check.path_calls``) with their candidates a pair on their
   binnings' cells (at most ``MAX_CANDIDATES_A_PAIR``, within
   ``FITTED_SLACK`` of the count on cells fitted to the launch's own h),
   and the linked pair timed beside the walking launches, GSPH's two
   density launches there timed beside their bound; ``ADKEScheme``'s
   sets on ``csrc/adke_pair.cu`` (a group of lanes a dest: its lanes,
   registers and spills printed): in float64 on the shock tube at
   nl=320, the accuracy test at 64^2 and the hydrostatic box at nx=50
   too, on periodic grids of 1, 2, 3, 5 and 8 cells an axis and on probe
   dests of an open grid (``gasd_check.adke_calls``) in both dtypes, the
   pairs and counts equal; each launch at full width repeated bit for
   bit; 20 steps of the accuracy test under adke at 256^2 in chunks bit
   for bit the per-step loop, and 200 steps timed in chunks; then
   ``CRKSPHScheme`` on ``crksph_pair`` (``_crksph_phase``): its six sets
   of both evaluators against their plain versions in float64 and
   float32 (``tools_dev/crksph_check.py``: within TOL of max|ref|, each
   dest's pairs equal) on the accuracy test at 256^2 (periodic, after a
   jittered step), an open 12^2 box with a singular particle and an open
   6^3 box, with its registers and spills by instantiation; the accuracy
   test at 32^2 to tf (L1), the hydrostatic box's default at nx=50 for
   200 steps (its largest speed under ``HYDROSTATIC_STILL``, rho's
   spread) in float64 and Taylor-Green ``--scheme crksph`` at nx=100
   (``TG_CRKSPH_NX``) for 200 steps in float32 against the JAX package's
   figures (``JAX_CRKSPH``, ``JAX_DECAY['crksph']``); the first
   evaluator's five sets linked (the number density emitting the list,
   four launches reading it) against the plain version and the walking
   launches, the list against ``neighbours_reference``, on the accuracy
   test and the open box (the 3D box walks); the ``post_loop`` solve on
   ``crk_solve`` against its plain version on all three, the same
   particles singular; the accuracy test at 256^2 in float32: 20 steps in
   chunks bit for bit the per-step loop, 200 steps timed in chunks of 10
   and per step (``_accuracy_drive``: every pair phase of both
   evaluators on ``crksph_pair``, the solve on ``crk_solve``, a step's
   launches, host reads, device ms by layer and idle share; 0 dests past
   the list's capacity), the solve timed beside its plain version, and
   each set timed there walking and as the path runs it, beside its
   bound, with the lanes a dest, registers and spills; then
   ``TSPHScheme`` on ``tsph_pair`` (``_tsph_phase``): its three sets
   against their plain versions in float64 and float32
   (``tools_dev/tsph_check.py``: within TOL of max|ref|, each dest's
   pairs equal) on the accuracy test at 24^2, the hydrostatic box at
   nx=20 and Cheng-Shu's 1,000 particles (1D), and on the accuracy test
   at 256^2 in float32; every sweep of a density iteration on
   ``tsph_sweep`` against its plain version (the converged flags and the
   count equal), its list against ``neighbours_reference`` and the
   velocity gradient and the momentum on it bit for bit their walks
   (``gasd_check.check_sweep``); the accuracy test at 32^2 to tf, the
   hydrostatic box at nx=50 and Cheng-Shu (``tsph`` and ``gsph``, 1D) for
   200 steps in float64, Sedov at nx=41 for 200 steps in float32, each
   within CAVITY_TOL of the JAX package's figures (``JAX_TSPH``,
   ``JAX_CHENG_SHU_GSPH``); the accuracy test ``tsph`` at 256^2 in
   float32: 20 steps in chunks bit for bit the per-step loop, 200 steps
   in chunks of 10 and ``ADKE_STEPS`` per step (``_accuracy_drive``, with
   its sweeps and slots), each set, the sweep and the two readers on its
   list timed beside their bounds, with registers and spills;
9. ``wcsph_pair`` with the Gaussian kernel and ``dense_pair`` against
   their plain version on the elliptical drop (``examples.elliptical_drop``)
   with a seeded velocity and density perturbation: nx=40 (5,021
   particles) in float64 (scaled error <= 1e-10) and nx=200 (125,623,
   the path's shapes) in float32 (<= 1e-4); ``dense_pair`` also on
   dam_break_3d's calls at dx=0.04 in float64 and dx=0.02 in float32
   (three sources, 3D); both kernels and the pack on the walk's edge
   cases (``tools_dev/walk_cases.py``: a clamped cell longer than a
   ``dense_pair`` stage, a 2D grid, four sources, write masks, an empty
   dest array) in float64 and float32, and the bulk copy (``UBLKCP``) in
   ``dense_pair``'s SASS; ``dense_pair``, ``wcsph_pair`` and the plain
   version timed on identical calls at nx=200 and at dx=0.02, on cells
   1.1 and 1.001 times the support, with the candidates and
   ``dense_pair``'s passes;
10. ``fused_continuity_momentum`` (CubicSpline) against its plain version
   on the perturbed drop at nx=200 in float64 and float32, timed, and its
   pack (the fused planes) equal to its plain version; then,
   with its launches counted, m times its rates against ``wcsph_pair``'s
   Continuity + Momentum on the same state;
11. the elliptical drop at nx=200 in float32 under ``--engine kernel``
    (``wcsph_pair``) and ``--engine dense`` (``dense_pair``), as the main
    path (1 launch in the initial eval, 2 a step), every pair phase on the
    engine;
12. the physics gate: the drop at nx=40 in float64 to tf=0.0076 under
    ``--engine dense``, in chunks after its 50 damped steps, dumping into
    a temporary directory under ``build/``: max |y| within 3% of the exact
    semi-major axis, and ``post_process`` through the ported ``load``; the
    drop outgrows its initial cell grid, which must grow at least once and
    end with at most twice the stencil candidates of the start, and a grow
    after the first capture must capture the chunk again;
13. ``micro_launch`` against its plain version on the nine cases of
    ``tools_dev/micro_launch.py`` (seeded inputs, <= 1e-4 of max|ref|),
    then that tool's run (its path) with the launches counted, and the
    fluid dest phase case timed beside the plain version and
    ``embedding_bag``;
14. ``micro_engine`` against its plain version on ``fluid-full`` with
    ``dyn_maps`` both ways and 9 and 3 views, then the
    ``tools_dev/micro_engine.py`` run with the launches counted;
15. ``pair_stub`` in every mode on dam_break_3d dx=0.02's calls: every
    output exactly 0, global loads in the SASS of every mode but
    ``none``, each mode timed (``all`` must be slower than ``none``);
    then the ``tools_dev/prof_dma.py`` and ``prof_phases.py`` runs (its
    path) with the launches counted.

Each kernel's bound is computed from its work at the path's shapes
(``tools_dev/roofline.py``) and printed beside its time; a kernel's
``launches`` are those on the card in its path's run.  Then ms/step of
the full-width runs under both binning configurations, per step and
in chunks, with the chunked runs' captures, replays, host reads and
binnings per 100 steps, and the binning's times an eval.  The line
before the last is a JSON summary of the kernels; the last is
``{"ok": true, "device": {...}}``.
"""

import functools
import gc
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from pysph_tpu_torch.base.cell_grid import CellGrid
from pysph_tpu_torch.base.kernels import CubicSpline, kernel_kind
from pysph_tpu_torch.base.utils import get_particle_array_gasd
from pysph_tpu_torch.config import Config
from pysph_tpu_torch.examples.dam_break_2d import DamBreak2D
from pysph_tpu_torch.examples.dam_break_3d import DamBreak3D
from pysph_tpu_torch.examples.elliptical_drop import (
    EllipticalDrop, exact_solution)
from pysph_tpu_torch.examples.gas_dynamics import (
    accuracy_test_2d, cheng_shu_1d, hydrostatic_box, sedov, shocktube)
from pysph_tpu_torch.examples.couette import CouetteFlow
from pysph_tpu_torch.examples.poiseuille import PoiseuilleFlow, profile_error
from pysph_tpu_torch.examples.taylor_green import TaylorGreen, decay_errors
from pysph_tpu_torch.ops import bin_cells as bc
from pysph_tpu_torch.ops import build, cell_pack, cell_walk
from pysph_tpu_torch.ops import crksph_pair as cp
from pysph_tpu_torch.ops.crk_solve import crk_solve, crk_solve_reference
from pysph_tpu_torch.ops import delta_pair as dl
from pysph_tpu_torch.ops import dense_pair as dp
from pysph_tpu_torch.ops import fused_pair as fp
from pysph_tpu_torch.ops import gasd_pair as gd
from pysph_tpu_torch.ops import gsph_pair as gs
from pysph_tpu_torch.ops import gtvf_pair as gp
from pysph_tpu_torch.ops import iisph_pair as ip
from pysph_tpu_torch.ops import iisph_solve as isv
from pysph_tpu_torch.ops import wcsph_pair as wp
from pysph_tpu_torch.ops import micro
from pysph_tpu_torch.ops import pair_link as pl
from pysph_tpu_torch.ops import pair_stub as stub
from pysph_tpu_torch.ops import tsph_pair as ts
from pysph_tpu_torch.ops import tvf_pair as tp
from pysph_tpu_torch.ops.pair_engine import PairSource
from pysph_tpu_torch.sph.wc import crksph
from pysph_tpu_torch.tools_dev import bin_check, delta_check, iisph_check
from pysph_tpu_torch.tools_dev import crksph_check
from pysph_tpu_torch.tools_dev import gasd_check
from pysph_tpu_torch.tools_dev import micro_engine as tool_engine
from pysph_tpu_torch.tools_dev import micro_launch as tool_launch
from pysph_tpu_torch.tools_dev import prof_chunk, prof_dma, prof_phases
from pysph_tpu_torch.tools_dev import roofline
from pysph_tpu_torch.tools_dev import time_chunks, tvf_check, walk_cases
from pysph_tpu_torch.tools_dev import tsph_check
from pysph_tpu_torch.tools_dev import kind_check
from pysph_tpu_torch.tools_dev.common import (
    capture, events_ms, graph_ms, linked_calls)
from pysph_tpu_torch.tools_dev.time_walks import (
    delta_calls, drop_calls, fused_call, gtvf_calls, make_app, pair_calls,
    plan_calls)

STEPS = 200
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: the JAX package's Taylor-Green decay at nx=400 after STEPS steps in
#: float32 on the CPU (``python tests/jax_tg_decay.py --scheme <scheme>
#: --nx 400 --steps 200 [<the option's flags>]``), by scheme and option:
#: (max |v| over the exact decay of the start's max |v|, the L1 error of
#: |v|)
JAX_DECAY = {'wcsph': (1.000178380345958, 0.009089970207746673),
             'gtvf': (1.000495169086151, 0.009147097045272161),
             'edac': (1.0016999426061108, 0.0006807834743331017),
             'wcsph delta': (0.9986821392914745, 0.008999829297085801),
             'wcsph summation': (1.000352147793546, 0.009079249251684698),
             'wcsph tensile': (1.0001777789107333, 0.009101093339999769),
             # at TG_CRKSPH_NX (``... --scheme crksph --nx 100 --steps
             # 200``): at nx=400 the JAX package's run printed NaN
             'crksph': (1.0003998103748453, 0.050676097729411056)}
#: the Taylor-Green vortex's ``--scheme crksph`` gate size: the example
#: starts CRKSPH at e = 0 (p = 0, cs = 0), and at nx=400 e falls below 0
#: somewhere within 200 steps, where cs is NaN: the JAX package's run
#: printed NaN, the port's raises FloatingPointError at its read (both
#: float32); at nx=100 both stay finite for 200 steps
TG_CRKSPH_NX = 100
#: the JAX package's ``post_process`` error against the exact steady
#: profile (max |u - ue| over max |ue|) of Poiseuille's and Couette's
#: flow run as the examples define themselves (to tf = 100) in float32 on
#: the CPU (``python tests/jax_wall_figures.py poiseuille``, ``...
#: couette``); the port's bar is the JAX error plus PROFILE_SLACK
JAX_PROFILE = {'poiseuille': 0.006605376955121756,
               'couette': 0.0002688895328901708}
PROFILE_SLACK = 0.005
#: the JAX package's lid-driven cavity at nx=400 after STEPS steps in
#: float32 on the CPU (``python tests/jax_wall_figures.py cavity --nx 400
#: --steps 200``): the fluid's max speed and kinetic energy, which the
#: port's run must meet to CAVITY_TOL relative
JAX_CAVITY = (0.9328589499779117, 0.0033403797557614422)
CAVITY_TOL = 1e-3
#: the same for ``--scheme edac`` (``python tests/jax_wall_figures.py
#: cavity --scheme edac --nx 400 --steps 200``)
JAX_CAVITY_EDAC = (0.9326928853989933, 0.0033353065544602318)
#: the JAX package's 2D dam break under ``--scheme edac`` at dx=0.02
#: after STEPS steps in float32 on the CPU (``python
#: tests/jax_wall_figures.py dam_break_2d --dx 0.02 --steps 200``): the
#: fluid's front (max x) and kinetic energy, which the port's run must
#: meet to CAVITY_TOL relative; the wall's pressure stays >= 0
#: (ClampWallPressure)
JAX_DAM_BREAK_EDAC = (1.0208659172058105, 8.88488556575926)
DAM_BREAK_FIGURE_DX = 0.02
#: the JAX package's figures of the three IISPH runs in float32 on the
#: CPU, each at the size and steps of the run's ``IisphRun.figure``,
#: which the port's run there must meet to CAVITY_TOL relative:
#: Taylor-Green (``python tests/jax_tg_decay.py --scheme iisph --nx 400
#: --steps 200``): max |v| over the exact decay of the start's max |v|;
#: the drop (``python tests/jax_wall_figures.py elliptical_drop --nx 50
#: --scheme iisph``, to tf): max |y| of the fluid, its semi-major axis;
#: the dam break (``python tests/jax_wall_figures.py dam_break_2d --dx
#: 0.02 --steps 10 --scheme iisph``): the fluid's front (max x) and its
#: kinetic energy.  The dam break stops at 10 steps: the reference's
#: IISPH dam break diverges from about step 12 at dx=0.02 (its speed
#: 10^4 m/s by step 19), in the JAX package and in the port alike
JAX_IISPH = {'taylor_green': (1.000369764239616,),
             'elliptical_drop': (1.9322257041931152,),
             'dam_break_2d': (1.040663719177246, 2948.5665646805487)}
#: the JAX package's gas-dynamics figures (``tests/jax_gasd_figures.py``,
#: its FROZEN; the JAX solver's per-step loop): the shock tube's L1
#: errors of rho, p and u against the
#: exact Riemann solution at --nl 320 in float64 to tf = 0.15 (``python
#: tests/jax_gasd_figures.py shocktube``), and the Sedov blast's shell
#: radius, peak density and total energy at --nx 41 after 200 steps in
#: float32 (``... sedov --nx 41 --steps 200``); the port's within
#: CAVITY_TOL of each, relative
JAX_SHOCKTUBE = {'rho': 0.01269194755940777, 'p': 0.015312279820969206,
                 'u': 0.06395616494260377}
JAX_SEDOV = {'radius': 0.1599970491956032, 'peak': 1.7150838375091553,
             'energy': 0.9999738059114059}
#: the JAX package's figures of the new gas runs (tests/jax_gasd_figures.py,
#: its FROZEN; the JAX solver's per-step loop, float64, the periodic runs
#: on its grid with ROOMY cells): accuracy_test_2d --nparticles 64 to tf =
#: 1.0, its L1 error of rho against the advected profile, by scheme;
#: hydrostatic_box --nx 50 after 200 steps, its largest speed and largest
#: relative departure of rho, by scheme; the shock tube at --nl 320 to tf
#: = 0.15 under gsph and adke, the L1 errors of rho, p and u; the port's
#: within CAVITY_TOL of each, relative
JAX_ACCURACY = {'gsph': 0.019094168522500815, 'mpm': 0.009723247057571023,
                'adke': 0.01850768099388279}
JAX_HYDROSTATIC = {
    'gsph': {'max_speed': 0.05207310077308546,
             'rho_spread': 0.488650734680953},
    'mpm': {'max_speed': 0.09849217996461504,
            'rho_spread': 0.39589640171242335},
    'adke': {'max_speed': 0.17708498207009132,
             'rho_spread': 0.4606353648072288}}
JAX_SHOCKTUBE_SCHEMES = {
    'gsph': {'rho': 0.006351124186608512, 'p': 0.005643681197702059,
             'u': 0.009568452084448117},
    'adke': {'rho': 0.19249611921569626, 'p': 0.2167222541130143,
             'u': 0.19141747246591215}}
#: the JAX package's figures of the CRKSPH runs (the JAX solver's per-step
#: loop): ``accuracy``, accuracy_test_2d --nparticles 32 to tf = 1.0 in
#: float64, its L1 error of rho (``python tests/jax_gasd_figures.py
#: accuracy_test_2d --nparticles 32 --scheme crksph``; 32^2, as its 64^2
#: run took over 20 minutes on the CPU); ``hydrostatic``, the
#: hydrostatic box's default scheme at --nx 50 after 200 steps in float64
#: (``python tests/jax_gasd_figures.py hydrostatic_box --nx 50 --steps
#: 200 --scheme crksph``); Taylor-Green's is JAX_DECAY['crksph'], at
#: TG_CRKSPH_NX
JAX_CRKSPH = {'accuracy': (32, 7.707702803696342e-07),
              'hydrostatic': {'max_speed': 3.852790224035833e-15,
                              'rho_spread': 0.00015512394441330457}}
#: the JAX package's figures of the TSPH runs (the JAX solver's per-step
#: loop; tests/jax_gasd_figures.py's FROZEN['tsph'] and ['cheng_shu_1d
#: gsph']): accuracy_test_2d --nparticles 32 --scheme tsph to tf = 1.0 in
#: float64, its L1 of rho; hydrostatic_box --nx 50 --scheme tsph after 200
#: steps in float64; sedov --nx 41 --scheme tsph after 200 steps in
#: float32; cheng_shu_1d --scheme tsph and --scheme gsph after 200 steps in
#: float64 (1,000 particles), the mean |rho - the carried profile|, the
#: largest rho and u; the port's within CAVITY_TOL of each, relative
JAX_TSPH = {'accuracy': (32, 0.020816479930321194),
            'hydrostatic': {'max_speed': 0.13057059225211037,
                            'rho_spread': 0.3963929452518531},
            'sedov': {'radius': 0.1602630866490765,
                      'peak': 1.7553044557571411,
                      'energy': 0.9999728717082634},
            'cheng_shu_1d': {'rho_l1': 0.01785519223224774,
                             'rho_max': 3.0006915842179342,
                             'u_max': 1.0996233021775303}}
JAX_CHENG_SHU_GSPH = {'rho_l1': 0.01806316552009522,
                      'rho_max': 3.0793219522333306,
                      'u_max': 1.0999479519940372}
#: nothing moves in the hydrostatic box under CRKSPH: the JAX package's
#: largest speed after 200 steps is rounding (3.9e-15), which no relative
#: bar can hold; the port's must stay below this
HYDROSTATIC_STILL = 1e-12
#: the accuracy test at full width: its particles a side, the steps timed,
#: and the JAX package's slow test's bar on its L1 at tf = 1.0
#: (tests/test_examples_quantitative.py)
ACCURACY_FULL = 256
#: steps of accuracy_test_2d --scheme adke at full width, per step
ADKE_STEPS = 40
ACCURACY_L1_BAR = 0.08
#: the most support tests a pair in support that a launch of the accuracy
#: test's GSPH evaluation may take after its first chunk, its binnings
#: sized for their own h (~4.4 on cells 1.1 times the support)
MAX_CANDIDATES_A_PAIR = 6.0
#: a binning is sized for the widest h of the steps since its last sizing,
#: so its cells may be a count wider than those fitted to one launch's h:
#: its walk tests at most this many times the fitted candidates
FITTED_SLACK = 1.1


def _compare(calls, dtype, label, op=None):
    """Max absolute and max scaled error of each kernel (``op``, else
    the plan's) against its plain version over every dest and output
    (on the entries where the plain version is finite; its infinities
    must be matched exactly); the plain version with torch's
    deterministic algorithms (``tvf_check.reference``)."""
    worst_abs = worst_scaled = 0.0
    for k, dest, plan, args in calls:
        got = (op or plan.op)(*args)
        ref = tvf_check.reference(plan, args)
        torch.cuda.synchronize()
        for p in ref:
            fin = torch.isfinite(ref[p])
            if not torch.equal(torch.isfinite(got[p]), fin) or \
                    not torch.equal(got[p][~fin].double(),
                                    ref[p][~fin].double()):
                raise AssertionError('%s eval %d %s.%s: non-finite entries '
                                     'differ' % (label, k, dest, p))
            d = float((got[p][fin].double() - ref[p][fin]).abs().max())
            scale = max(float(ref[p][fin].abs().max()), 1e-300)
            worst_abs = max(worst_abs, d)
            worst_scaled = max(worst_scaled, d / scale)
            if not d <= TOL[dtype] * scale:
                raise AssertionError('%s eval %d %s.%s: error %.3g > %.1g '
                                     '* %.3g' % (label, k, dest, p, d,
                                                 TOL[dtype], scale))
    print('compare %s: max abs err %.3g, max scaled err %.3g (tol %.0e)'
          % (label, worst_abs, worst_scaled, TOL[dtype]), flush=True)
    return worst_abs


def _engines_agree(label, dx, steps, props, cls=DamBreak3D, extra=(),
                   engine='kernel'):
    """A path on a kernel engine (``engine``) against the same run on the
    plain torch engine, float64, after ``steps`` steps (non-finite
    entries must match exactly)."""
    runs = {}
    for e in (engine, 'torch'):
        app = make_app(dx, torch.float64, steps=steps, engine=e, cls=cls,
                       extra=extra)
        app.solve()
        runs[e] = app
    worst = 0.0
    for name, ref in runs['torch'].solver.states.items():
        got = runs[engine].solver.states[name]
        for p in props:
            if p not in ref:
                continue
            fin = torch.isfinite(ref[p])
            if not torch.equal(torch.isfinite(got[p]), fin) or \
                    not torch.equal(got[p][~fin], ref[p][~fin]):
                raise AssertionError('engines disagree on the non-finite '
                                     'entries of %s.%s' % (name, p))
            scale = max(float(ref[p][fin].abs().max()), 1e-300)
            err = float((got[p][fin] - ref[p][fin]).abs().max()) / scale
            worst = max(worst, err)
            if not err <= 1e-9:
                raise AssertionError('engines disagree on %s.%s after %d '
                                     'steps: %.3g' % (name, p, steps, err))
    print('%s dx=%s float64, %d steps: %s engine against torch engine, '
          'max scaled err %.3g (tol 1e-09)' % (label, dx, steps, engine,
                                               worst), flush=True)


def _chunk_launches(solver, ops):
    """Record, for each chunk body ``solver`` runs, (steps, [launches of
    each of ``ops`` counted in it], whether it was being captured): the
    wrappers count Python calls, so a capture counts its chunk's
    launches once and a replay counts none.  Returns the list it fills."""
    rows = []
    body = solver._chunk_body

    def counted(iters):
        before = [op.launches for op in ops]
        capturing = torch.cuda.is_current_stream_capturing()
        body(iters)
        rows.append((iters, [op.launches - b for op, b in zip(ops, before)],
                     capturing))

    solver._chunk_body = counted
    return rows


def _drive(label, kw, ops, bins, skip_finite=(), engine='kernel',
           checks=(), config='reuse'):
    """A path at full width in float32 for ``STEPS`` steps under the
    binning configuration ``config`` (``time_chunks.CONFIGS``), per step
    (``chunk_steps = 1``) and in chunks (10, replayed from a CUDA graph),
    each timed by ``time_chunks.timed_solve`` (median ms/step: per step
    from the host clock at each step's start, the card synchronised; in
    chunks from the host clock after each chunk's read, over the chunks
    after the capture).  ``ops``: ((kernel wrapper, first, per_step[,
    packs a launch]), ...), the path's pair kernels (a launch packs once
    but where said: a linked ``delta_pair`` pair packs once).  Each one's
    launch count (and the source pack's and ``bin_cells``') is set to 0
    just before each run and read just after: per step, the initial eval
    launches it ``first`` and a step ``per_step`` times (``bin_cells``
    once and ``bins`` times: each reuse test); in chunks, the eager
    launches are the initial eval's, the damped steps' and one warm-up
    step a capture, each capture counts ``per_step`` x K (``bins`` x K),
    and the launches on the card are the eager ones plus those of a
    capture x replays (the pack as often as the pair kernels' launches
    times their packs a launch).  Every pair phase of every evaluator must be
    planned on ``engine``, the final state finite (``skip_finite`` aside)
    and each of ``checks`` pass (called with the chunked run's solver).
    Returns {launches: {kernel: launches}, bin_launches, particles, ms:
    {chunk steps: ms/step}, rebuilds: {chunk steps: binnings that ran},
    counters: the chunked run's solver counters, peak_mib: the chunked
    run's peak device memory, from a reset after a garbage collection}."""
    ms, rebuilds, counters, launches = {}, {}, None, {}
    wrappers = [o[0] for o in ops]
    pack_share = [o[3] if len(o) > 3 else 1 for o in ops]
    for k in (1, 10):
        app = time_chunks.configure(
            make_app(dtype=torch.float32, steps=STEPS, **kw), config)
        s = app.solver
        bodies = _chunk_launches(s, wrappers + [bc.bin_cells])
        for op in wrappers:
            op.launches = 0
        cell_pack.pack.launches = bc.bin_cells.launches = 0
        # the earlier runs' solvers sit in reference cycles (timed_solve)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ms[k], samples = time_chunks.timed_solve(app, k)
        counted = [op.launches for op in wrappers]
        packs, binned = cell_pack.pack.launches, bc.bin_cells.launches
        peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
        rebuilds[k] = s.rebuilds
        n = sum(st['x'].shape[0] for st in s.states.values())
        print('%s, %s, chunk_steps=%d: median %.3f ms/step (min %.3f, max '
              '%.3f over %d samples from step %d), %.4g particle-steps/s; %d '
              'captures, %d replays, %d reads, %d binnings of %d tests; '
              't=%.6g dt=%.6g; peak device memory %.1f MiB' % (
                  label, config, k, ms[k], min(samples), max(samples),
                  len(samples), time_chunks.WARMUP, n / ms[k] * 1e3,
                  s.captures, s.replays, s.reads, s.rebuilds,
                  1 + bins * STEPS, s.t, s.dt, peak_mib), flush=True)
        if k == 1:
            if s.captures or s.replays or bodies or s.count != STEPS or \
                    any(c != o[1] + o[2] * STEPS
                        for c, o in zip(counted, ops)) \
                    or binned != 1 + bins * STEPS:
                raise AssertionError('%s, chunk_steps=1: %s launches, %d '
                                     'bin_cells launches, %d chunks' % (
                                         label, counted, binned,
                                         len(bodies)))
            del app, s
            continue
        K = s.chunk_steps
        chunked = STEPS - s.n_damp
        nb = len(ops)
        bin_captured = [c[nb] for it, c, cap in bodies if cap]
        bin_warm = [c[nb] for it, c, cap in bodies if not cap]
        ok = (s.count == STEPS and s.captures and
              s.replays == -(-chunked // K))
        for q, (op, first, per_step, *_) in enumerate(ops):
            captured = [c[q] for it, c, cap in bodies if cap]
            warm = [c[q] for it, c, cap in bodies if not cap]
            eager = counted[q] - sum(captured)
            launches[op.__name__] = eager + per_step * K * s.replays
            print('%s launches: %d eager (initial eval %d, %d damped '
                  'steps, %d warm-up steps) + %d a capture (%d steps) x %d '
                  'replays = %d on the card; %d steps chunked, %d counted in '
                  '%d captures' % (
                      op.__name__, eager, first, s.n_damp, len(warm),
                      per_step * K, K, s.replays, launches[op.__name__],
                      chunked, sum(captured), len(captured)), flush=True)
            ok = ok and (len(captured) == s.captures and
                         set(captured) == {per_step * K} and
                         warm == [per_step] * s.captures and
                         eager == first + per_step * (s.n_damp +
                                                      s.captures))
        bin_eager = binned - sum(bin_captured)
        bin_launches = bin_eager + bins * K * s.replays
        print('bin_cells: %d eager + %d a capture x %d replays = %d'
              % (bin_eager, bins * K, s.replays, bin_launches), flush=True)
        if not (ok and set(bin_captured) == {bins * K} and
                bin_warm == [bins] * s.captures and
                bin_eager == 1 + bins * (s.n_damp + s.captures)):
            raise AssertionError('%s did not run every pair phase and '
                                 'reuse test through the kernels in its '
                                 'chunks: %s' % (label, bodies))
        want = sum(c * f for c, f in zip(counted, pack_share))
        print('cell_pack launches: %d eager and in captures, for %d pair '
              'kernel launches' % (packs, sum(counted)), flush=True)
        if packs != want:
            raise AssertionError('%s: %d pack launches, not %g' % (
                label, packs, want))
        for i, a_eval in enumerate(s.acceleration_evals):
            print('eval %d engine_choices: %s' % (i, a_eval.engine_choices))
            if set(a_eval.engine_choices.values()) != {engine}:
                raise AssertionError('a dest planned off the %s engine: %s'
                                     % (engine, a_eval.engine_choices))
        for name, st in s.states.items():
            for p, v in st.items():
                if p in skip_finite or not v.is_floating_point():
                    continue
                if not bool(torch.isfinite(v).all()):
                    raise AssertionError('non-finite %s.%s after the run'
                                         % (name, p))
        for check in checks:
            check(s)
        counters = dict(captures=s.captures, replays=s.replays,
                        reads=s.reads, chunk_steps=K)
        del app, s
    print('%s, %s: %.3f ms/step per step, %.3f in chunks (%.2fx); %d and %d '
          'binnings in %d steps' % (label, config, ms[1], ms[10],
                                    ms[1] / ms[10], rebuilds[1],
                                    rebuilds[10], STEPS), flush=True)
    return dict(launches=launches, bin_launches=bin_launches, particles=n,
                ms=ms, rebuilds=rebuilds, counters=counters,
                peak_mib=peak_mib)


def _bin_phase(label, s, out):
    """``bin_cells`` against its plain version on the states the run of
    ``s`` ended with, the arrays of each evaluator (``bin_check.check``:
    exact, and unchanged under the flag 0), then its times an eval
    (``bin_check.times``), into ``out[label]``."""
    rows = []
    for i, a_eval in enumerate(s.acceleration_evals):
        used = {n: s.states[n] for n in a_eval.arrays_used}
        calls = bin_check.check(s.grid, used, seed=i,
                                label='%s eval %d' % (label, i))
        t = bin_check.times(s.grid, used)
        cid = s.grid.bin_all(used)[next(iter(used))].cell.long()
        t['sort_ms'] = events_ms(lambda: torch.sort(cid, stable=True), 20)
        n = sum(st['x'].shape[0] for st in used.values())
        print('bin_cells %s eval %d after %d steps (%d particles in %d '
              'arrays, %d cells): exactly the plain version in %d calls, '
              'bitwise unchanged under the flag 0; kept %.4f ms, rebuilt '
              '%.4f ms in a graph, plain %.3f ms; bound kept %.4f ms (%s), '
              'rebuilt %.4f ms (%s)' % (
                  (label, i, STEPS, n, len(used), s.grid.ncells, calls,
                   t['kept_ms'], t['rebuilt_ms'], t['plain_ms']) +
                  roofline.bound(t['kept_work']) +
                  roofline.bound(t['rebuilt_work'])), flush=True)
        print('  rebuilt, by kernel (ms): %s; torch.sort(cid, stable=True) '
              'on the first array\'s cell ids %.4f ms' % (', '.join(
                  '%s %.4f' % (k.split('(')[0].split(' ')[-1], v)
                  for k, v in t['rebuilt_kernels'].items()), t['sort_ms']),
              flush=True)
        rows.append(t)
    out[label] = rows


def _linked_times(op, calls, rounds=5, reps=20):
    """Median ms of CUDA graph replays of the linked pair of ``calls``
    (``op``'s emitting call, then its consuming call), of the two
    walking calls (each packing, as before the link), and of each launch
    alone (``consume`` on a hand-off emitted before; ``first walk`` and
    ``second walk`` the walking calls), the graphs' replays alternated
    over ``rounds`` rounds in this process; and the linked pair as a
    function."""
    ((_, _, _, first), (_, _, _, second)), = linked_calls(calls)
    _, held = op(*first, emit=True)
    fns = {
        'linked': lambda: op(*second, handoff=op(*first, emit=True)[1]),
        'walking': lambda: (op(*first), op(*second)),
        'emit': lambda: op(*first, emit=True),
        'consume': lambda: op(*second, handoff=held),
        'first walk': lambda: op(*first),
        'second walk': lambda: op(*second),
    }
    graphs = {k: capture(fn) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(events_ms(graph.replay, reps))
    del graphs, held
    return {k: float(np.median(v)) for k, v in times.items()}, fns['linked']


def _delta_packs(app):
    """(delta_pair launches, pack launches) of one eager eval of
    ``app``'s evaluator, and the pair launches of the wcsph_pair calls."""
    s = app.solver
    a_eval = s.acceleration_evals[0]
    handle, _ = a_eval.prepare(s.states)
    torch.cuda.synchronize()
    dl.delta_pair.launches = wp.wcsph_pair.launches = 0
    cell_pack.pack.launches = 0
    a_eval.compute(0.0, s.dt, s.states, handle)
    torch.cuda.synchronize()
    return (dl.delta_pair.launches, cell_pack.pack.launches,
            wp.wcsph_pair.launches)


def _delta_phase(runs, kernels):
    """dam_break_3d ``--delta-sph``: ``delta_pair`` and ``wcsph_pair``'s
    delta terms against their plain versions (``tools_dev/delta_check.py``:
    float64 and float32 at dx=0.04 perturbed, float32 at dx=0.02 on the
    path's state after its damped steps, the accept decisions' flips
    counted), and the linked pair there (``check_linked``: the moment
    call's neighbour list equal to ``neighbours_reference``, the
    consuming gradient call equal to the walking one bit for bit, 0
    flips, one pack), timed at dx=0.02 (``_linked_times``: the linked pair
    against the two walking launches, each launch alone), the pack
    launches of one eval counted, then the path (``_drive``, reuse
    only): 3 ``wcsph_pair`` and 2 ``delta_pair`` launches an eval, 4
    packs.  Adds the ``delta_pair`` entry and the delta terms of the
    ``wcsph_pair`` one."""
    for dx, dtype in ((0.04, torch.float64), (0.04, torch.float32)):
        calls, n, _ = delta_calls(dx, dtype)
        what = 'dam_break_3d --delta-sph dx=%g %s (%d particles), ' \
            'perturbed' % (dx, str(dtype)[6:], n)
        delta_check.check(calls, what)
        delta_check.check_linked(calls, what)
        del calls
    label = 'dam_break_3d dx=0.02 delta'
    calls, n, app = delta_calls(0.02, torch.float32, steps=50)
    what = '%s float32 (%d particles) after its %d damped steps' % (
        label, n, app.solver.count)
    found = delta_check.check(calls, what)
    linked = delta_check.check_linked(calls, what)
    dcalls = [c for c in calls if c[2].op is dl.delta_pair]
    times, linked_fn = _linked_times(dl.delta_pair, calls)
    delta_ms = times['linked']
    delta_eager = events_ms(linked_fn, 20)
    delta_plain_ms = events_ms(
        lambda: [c[2].reference(*c[3]) for c in dcalls], 3)
    # the linked gradient tests no candidate: one walk's support tests
    ((_, _, _, margs), (_, _, _, gargs)), = linked_calls(calls)
    delta_work = roofline.add(roofline.delta_work(*margs),
                              roofline.delta_work(*gargs, walks=False))
    two_walks = _calls_work(dcalls, roofline.delta_work)
    print('delta_pair, the 2 pre-phases of one eval at dx=0.02 float32, '
          'graph replays alternated in this process: linked (emit + '
          'consume, one pack) %.4f ms, walking (2 walks, 2 packs) %.4f ms; '
          'alone: emit %.4f, consume %.4f, moment walk %.4f, gradient walk '
          '%.4f; linked eager %.3f, plain torch %.3f ms; bound %.4f ms (%s, '
          'one walk: %.4g flops); counted with two walks %.4f ms (%s, %.4g '
          'flops)' % (
              (delta_ms, times['walking'], times['emit'], times['consume'],
               times['first walk'], times['second walk'], delta_eager,
               delta_plain_ms) + roofline.bound(delta_work) +
              (delta_work['flops'],) + roofline.bound(two_walks) +
              (two_walks['flops'],)), flush=True)
    launches, packs, wcsph = _delta_packs(app)
    print('one eager eval of %s: %d delta_pair launches, %d wcsph_pair, %d '
          'pack launches (%d for the pre-phases)' % (
              label, launches, wcsph, packs, packs - wcsph), flush=True)
    if (launches, wcsph, packs) != (2, 3, 4):
        raise AssertionError('%s: %d delta_pair, %d wcsph_pair and %d pack '
                             'launches in one eval, not 2, 3 and 4' % (
                                 label, launches, wcsph, packs))
    # the delta terms: the fluid's wcsph_pair call with and without them
    tc = delta_check.terms_calls(calls)
    with_ms = graph_ms(lambda: [wp.wcsph_pair(*c[0]) for c in tc], 20)
    without_ms = graph_ms(lambda: [wp.wcsph_pair(*c[1]) for c in tc], 20)
    alone_ms = graph_ms(lambda: [wp.wcsph_pair(*c[2]) for c in tc], 20)
    plain_alone = events_ms(
        lambda: [wp.wcsph_pair_reference(*c[2]) for c in tc], 3)
    work_with = roofline.add(*[roofline.wcsph_work(*c[0]) for c in tc])
    work_without = roofline.add(*[roofline.wcsph_work(*c[1]) for c in tc])
    terms_work = {k: work_with[k] - work_without[k] for k in work_with}
    terms_bound, terms_by = roofline.bound(terms_work)
    print('wcsph_pair, the fluid call at dx=0.02 float32: %.3f ms in a graph '
          'with the delta terms, %.3f without, %.3f with them alone (plain '
          'torch %.3f ms); the terms\' bound %.4f ms (%s)' % (
              with_ms, without_ms, alone_ms, plain_alone, terms_bound,
              terms_by), flush=True)
    # the calls with the delta terms are one of the path's wcsph_pair calls
    terms_share = len(tc) / sum(c[2].op is wp.wcsph_pair for c in calls)
    del calls, dcalls, tc, app, linked_fn, margs, gargs
    runs[label, 'reuse'] = run = _drive(
        label, time_chunks.PATHS[label],
        ((wp.wcsph_pair, 3, 6), (dl.delta_pair, 2, 4, 0.5)), 1)
    kernels['delta_pair'] = _entry(
        'delta_pair', 'pysph_tpu/ops/resident.py:645',
        run['launches']['delta_pair'], found['by_kernel']['delta_pair'],
        delta_ms, delta_plain_ms, delta_work, None, eager_ms=delta_eager,
        share=roofline.bound(delta_work)[0] / delta_ms,
        per_launch_ms=[times['emit'], times['consume']],
        walking_ms=times['walking'],
        walking_per_launch_ms=[times['first walk'],
                               times['second walk']],
        two_walk_bound_ms=roofline.bound(two_walks)[0],
        flips=found['flips'] + linked['flips'],
        flipped_dests=found['flipped_dests'],
        overflowed=linked['overflowed'], max_count=linked['max_count'],
        capacity=linked['capacity'],
        path='dam_break_3d --delta-sph dx=0.02 after the damped steps, one '
        'eval (2 launches, linked: the moment emits, the gradient consumes)')
    terms_ms = with_ms - without_ms
    kernels['wcsph_pair']['delta_terms'] = dict(
        launches=round(run['launches']['wcsph_pair'] * terms_share),
        max_abs_err=found['by_kernel']['wcsph_pair'], ms=terms_ms,
        alone_ms=alone_ms, plain_ms=plain_alone, bound_ms=terms_bound,
        bound_by=terms_by, share=terms_bound / terms_ms
        if terms_ms > 0 else None, work=terms_work,
        path='dam_break_3d --delta-sph dx=0.02, the fluid call with the '
        'terms less without them (ms), the terms alone (alone_ms, and '
        'the plain version\'s plain_ms)')


def _wcsph2d_phase(runs, kernels, bins):
    """The WCSPH dam break in 2D (``examples.dam_break_2d``, its default
    ``--scheme wcsph``: PEC, WendlandQuintic, the Hughes-Graham walls):
    ``wcsph_pair`` against its plain version with a seeded velocity and
    density perturbation, dx=0.02 (7,603 particles) in float64 and
    float32 and dx=0.004 (137,803, the path's shapes) in float64 and
    float32, timed and counted there; then the path as the main path (2
    launches in the initial eval, 2 a step: PEC evaluates once).  Adds
    the path's numbers to the ``wcsph_pair`` entry."""
    for dx, dtype in ((0.02, torch.float64), (0.02, torch.float32),
                      (0.004, torch.float64)):
        calls, n = pair_calls(dx, dtype, cls=DamBreak2D)
        _compare(calls, dtype, 'wcsph_pair dam_break_2d wcsph dx=%g %s (%d '
                 'particles)' % (dx, str(dtype)[6:], n))
        del calls
    calls, n = pair_calls(0.004, torch.float32, cls=DamBreak2D)
    if n != 137803:
        raise AssertionError('dam_break_2d at dx=0.004 has %d particles, '
                             'not 137,803' % n)
    err = _compare(calls, torch.float32, 'wcsph_pair dam_break_2d wcsph '
                   'dx=0.004 float32 (%d particles)' % n)
    eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    work = _calls_work(calls, roofline.wcsph_work)
    bound_ms, bound_by = roofline.bound(work)
    print('wcsph_pair, pair phases of one eval of dam_break_2d wcsph at '
          'dx=0.004 float32 (%d launches, the pack included): kernel %.3f '
          'ms eager, %.3f ms in a graph, plain torch %.3f ms; bound %.4f ms '
          '(%s); %d candidates, %d visited, %d pairs' % (
              len(calls), eager, ms, plain_ms, bound_ms, bound_by,
              work['candidates'], work['visited'], work['pairs']),
          flush=True)
    del calls
    label = 'dam_break_2d wcsph dx=0.004'
    for config, (every, _) in time_chunks.CONFIGS.items():
        runs[label, config] = _drive(
            label, time_chunks.PATHS[label], ((wp.wcsph_pair, 2, 2),), 1,
            config=config, checks=() if every else (functools.partial(
                _bin_phase, label, out=bins),))
    kernels['wcsph_pair']['dam_break_2d_wcsph'] = dict(
        launches=runs[label, 'reuse']['launches']['wcsph_pair'],
        max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, work=work,
        path='dam_break_2d --scheme wcsph dx=0.004, one eval (2 launches)')


def _integrators_phase():
    """The WCSPH dam break's equations under each other integrator
    (``time_chunks.INTEGRATORS``: Euler, TVDRK3, LeapFrog, PEFRL; their
    chunks against the eager loop in float64 are gates of the chunk
    phase) at dx=0.02 in float64, 30 steps from ``n_damp = 0`` in 3
    captured chunks: the ``wcsph_pair`` launches a capture counts must be
    2 an eval, so the graph holds 1, 3, 1 and 4 evals a step."""
    for name, (_, evals) in time_chunks.INTEGRATORS.items():
        app = time_chunks.integrated(name)()
        app.setup(['--disable-output', '-q', '--use-double', '--device',
                   'cuda', '--dx', '0.02', '--max-steps', '30'])
        s = app.solver
        s.n_damp = 0
        bodies = _chunk_launches(s, [wp.wcsph_pair])
        app.solve()
        captured = [c[0] for it, c, cap in bodies if cap]
        print('%s on dam_break_2d wcsph dx=0.02 float64: %d steps, %d '
              'captures, %d replays; wcsph_pair launches a capture %s (%d '
              'evals a step); t=%.6g' % (
                  name, s.count, s.captures, s.replays, captured, evals,
                  s.t), flush=True)
        if s.count != 30 or s.captures != 1 or s.replays != 3 or \
                captured != [2 * evals * s.chunk_steps]:
            raise AssertionError('%s did not run its %d evals a step in '
                                 'captured chunks' % (name, evals))
        for name_, st in s.states.items():
            for p, v in st.items():
                if v.is_floating_point() and \
                        not bool(torch.isfinite(v).all()):
                    raise AssertionError('%s: non-finite %s.%s'
                                         % (name, name_, p))
        del app, s


def _tg_decay(out, solver, key='tvf', nx=400):
    """max |v| and the L1 error of |v| of the Taylor-Green run's final
    state against the exact decay (into ``out``); ``key``: the scheme and
    the option of the run.  ``tvf``: max |v|
    within 1% of the exact decay of the lattice's max |v| at t = 0, the
    L1 error below 2% of U (the pressure waves of the start, p = 0 from
    the summation density against the exact field's, hold it near 0.9%
    at t=0.011 at nx=64 and nx=100 in float32 on the CPU).  The others
    (``wcsph`` and its options, ``gtvf``, ``edac``): that ratio within
    1e-3 of the JAX package's for the same run, the L1 error within 5% of
    its (``JAX_DECAY[key]``); ``edac`` also the JAX package's own bar,
    max |v| within 5% of the exact decay
    (``tests/test_examples_quantitative.py:63-77``)."""
    st = {p: solver.states['fluid'][p].double().cpu().numpy()
          for p in 'xyuv'}
    vmax, exact, l1 = decay_errors(st['x'], st['y'], st['u'], st['v'],
                                   solver.t, 100.0)
    ratio = vmax / (out['vmax0'] * exact)
    out.update(t=solver.t, vmax=vmax, exact=exact, l1=l1, ratio=ratio)
    if key == 'tvf':
        bars = 'bar 1%; L1 bar 2e-2'
        ok = abs(ratio - 1.0) < 1e-2 and l1 < 2e-2
    else:
        jax_ratio, jax_l1 = JAX_DECAY[key]
        out.update(jax_ratio=jax_ratio, jax_l1=jax_l1)
        bars = 'JAX %.6f, bar 1e-3; JAX L1 %.4g, bar 5%%' % (jax_ratio,
                                                              jax_l1)
        ok = abs(ratio - jax_ratio) <= 1e-3 and \
            abs(l1 - jax_l1) <= 0.05 * jax_l1
        if key == 'edac':
            bars += '; exact bar 5%'
            ok = ok and abs(ratio - 1.0) < 0.05
    print('taylor_green %s nx=%d float32 at t=%.6g after %d steps: max|v| '
          '%.6f, exact decay of the start\'s %.6f: %.6f (ratio %.6f); L1 '
          'error of |v| %.4g (%s)' % (
              key, nx, solver.t, solver.count, vmax, out['vmax0'],
              out['vmax0'] * exact, ratio, l1, bars), flush=True)
    if not ok:
        raise AssertionError('the Taylor-Green vortex (%s) missed its '
                             'decay' % key)


def _tvf_linked(s):
    """The Taylor-Green run of ``s`` ran its density and momentum plans
    linked, with no dest past the list's capacity (the counter reset
    before the run)."""
    plans = [p for a in s.acceleration_evals for p in a._plans.values()
             if p is not None]
    links = {id(p.link) for p in plans if p.link is not None}
    overflowed = tp.overflowed('cuda')
    print('taylor_green nx=400: %d linked tvf_pair pair, %d dests past the '
          'list\'s capacity in the runs' % (len(links), overflowed),
          flush=True)
    if len(plans) != 2 or len(links) != 1 or overflowed:
        raise AssertionError('the Taylor-Green run was not linked, or %d '
                             'dests overflowed its list' % overflowed)


def _tvf_phase(runs, kernels, bins):
    """The Taylor-Green vortex (``examples.taylor_green``, ``--scheme
    tvf``): ``tvf_pair`` against its plain version on its periodic grid
    (``tools_dev/tvf_check.py``: perturbed, and with a tenth of the
    particles on the box's edges and corners) at nx=50 in both dtypes
    and nx=400 in float32, and its linked pair on each of these calls
    (``tvf_check.check_linked``: the density launch's neighbour list
    equal to ``neighbours_reference``, both launches equal to the
    walking ones bit for bit and within ``TOL`` of the plain version,
    one pack each, no dest past the capacity but in the edge cases,
    whose corners stack particles; at nx=50 in float64 also with the
    capacity one short of the largest count and with capacity 1, so that
    some and then all warps walk); timed and counted at nx=400
    (``_linked_times``: the linked pair against the two walking
    launches, each launch alone, graph replays alternated) with each
    mode's registers and spills; the kernel engine against the torch
    engine at nx=50 in float64 for 10 steps, from a start perturbed by a
    tenth of dx (on the unperturbed
    lattice rounding alone moves ``auhat avhat`` by ~2e-9 of their max
    in 10 steps, as ``tools_dev/tg_conditioning.py`` shows; from this
    start, every prop by <= ~4e-13); then the path at nx=400 as the main
    path under the binning reuse (2 launches in the initial eval, 2 a
    step, linked, one pack each), with its decay against the exact one.
    Adds the ``tvf_pair`` entry."""
    for nx, dtype, edges in ((50, torch.float64, False),
                             (50, torch.float64, True),
                             (50, torch.float32, False),
                             (50, torch.float32, True),
                             (400, torch.float32, True)):
        calls, n, moved = tvf_check.calls(nx, dtype, edges)
        if not calls[0][3][5].is_periodic:
            raise AssertionError('the Taylor-Green grid is not periodic')
        what = 'taylor_green nx=%d %s%s (%d particles%s)' % (
            nx, str(dtype)[6:], ' edges' * edges, n,
            ', %d on the edges' % moved if edges else '')
        _compare(calls, dtype, 'tvf_pair ' + what)
        # the corners of the edge cases stack particles: their dests past
        # the capacity are counted and walk
        found = tvf_check.check_linked(calls, what, TOL[dtype])
        if found['overflowed'] and not edges:
            raise AssertionError('%s: %d dests past the list\'s capacity'
                                 % (what, found['overflowed']))
        if (nx, dtype, edges) == (50, torch.float64, False):
            for cap in (found['max_count'] - 1, 1):
                small = tvf_check.check_linked(
                    calls, '%s, capacity %d' % (what, cap), TOL[dtype],
                    capacity=cap)
                if not small['overflowed']:
                    raise AssertionError('%s: no dest past capacity %d'
                                         % (what, cap))
        del calls
    calls, n, _ = tvf_check.calls(400, torch.float32)
    if n != 160000:
        raise AssertionError('taylor_green at nx=400 has %d particles, not '
                             '160,000' % n)
    what = 'taylor_green nx=400 float32 (%d particles)' % n
    err = _compare(calls, torch.float32, 'tvf_pair ' + what)
    linked = tvf_check.check_linked(calls, what, TOL[torch.float32])
    if linked['overflowed']:
        raise AssertionError('%s: %d dests past the list\'s capacity'
                             % (what, linked['overflowed']))
    err = max(err, linked['max_abs_err'])
    for k, dest, _, args in calls:
        _check_pack('taylor_green nx=400 ' + dest, tp.pack_sources(args[4]),
                    tp.pack_sources_reference(args[4]))
    times, linked_fn = _linked_times(tp.tvf_pair, calls)
    eager = events_ms(linked_fn, 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    ((_, _, _, dargs), (_, _, _, margs)), = linked_calls(calls)
    # the consuming momentum call tests no candidate: one walk's tests
    work = roofline.add(roofline.tvf_work(*dargs),
                        roofline.tvf_work(*margs, walks=False))
    two_walks = _calls_work(calls, roofline.tvf_work)
    bound_ms, bound_by = roofline.bound(work)
    resources = tvf_check.resources(build.build('tvf_pair'))
    print('tvf_pair, the 2 launches of one eval of taylor_green at nx=400 '
          'float32 (grid %s, periodic %s), graph replays alternated in this '
          'process: linked (emit + consume, each packing) %.4f ms, walking '
          '(2 walks) %.4f ms; alone: emit %.4f, consume %.4f, density walk '
          '%.4f, momentum walk %.4f; linked eager %.3f, plain torch %.3f '
          'ms; bound %.4f ms (%s, one walk: %.4g flops, %d candidates, %d '
          'pairs); counted with two walks %.4f ms (%s, %.4g flops, %d '
          'candidates); %.1f candidates and %.1f pairs a particle a walk; '
          'registers and spill bytes (stores, loads) by mode: %s' % ((
              calls[0][3][5].dims, calls[0][3][5].periodic, times['linked'],
              times['walking'], times['emit'], times['consume'],
              times['first walk'], times['second walk'], eager, plain_ms,
              bound_ms, bound_by, work['flops'], work['candidates'],
              work['pairs']) + roofline.bound(two_walks) + (
              two_walks['flops'], two_walks['candidates'],
              work['candidates'] / n, work['pairs'] / (2.0 * n),
              resources)), flush=True)
    del calls, linked_fn, dargs, margs
    _engines_agree('taylor_green nx=50', None, 10,
                   ('x', 'y', 'u', 'v', 'rho', 'p', 'V', 'au', 'av',
                    'auhat', 'avhat'), cls=TaylorGreen,
                   extra=('--nx', '50', '--perturb', '0.1'))
    label = 'taylor_green nx=400'
    decay = dict(vmax0=1.0)
    start = make_app(None, torch.float32, cls=TaylorGreen,
                     extra=('--nx', '400')).solver.states['fluid']
    decay['vmax0'] = float(torch.sqrt(start['u'] ** 2 +
                                      start['v'] ** 2).max())
    del start
    tp.reset_overflow('cuda')
    runs[label, 'reuse'] = _drive(
        label, time_chunks.PATHS[label], ((tp.tvf_pair, 2, 2),), 1,
        checks=(functools.partial(_bin_phase, label, out=bins),
                functools.partial(_tg_decay, decay), _tvf_linked))
    kernels['tvf_pair'] = _entry(
        'tvf_pair', 'pysph_tpu/ops/resident.py:645',
        runs[label, 'reuse']['launches']['tvf_pair'], err, times['linked'],
        plain_ms, work, None, eager_ms=eager,
        share=bound_ms / times['linked'],
        per_launch_ms=[times['emit'], times['consume']],
        walking_ms=times['walking'],
        walking_per_launch_ms=[times['first walk'], times['second walk']],
        two_walk_bound_ms=roofline.bound(two_walks)[0],
        overflowed=linked['overflowed'], max_count=linked['max_count'],
        capacity=linked['capacity'], resources=resources, decay=decay,
        path='taylor_green nx=400, one eval (2 launches, linked: the '
        'density emits, the momentum consumes)')


class TgRun(NamedTuple):
    """A Taylor-Green run of ``_tg_scheme_phase``: ``scheme`` on
    ``engine`` with the ``time_chunks.WCSPH_OPTIONS`` entry ``option``
    ('' for none); ``drive``: ``_drive``'s ops ((kernel wrapper, launches
    in the initial eval, a step[, packs a launch]), ...), the first the
    kernel whose periodic entry the run adds; ``bins``: reuse tests a
    step."""
    scheme: str
    engine: str
    option: str
    drive: tuple
    bins: int

    @property
    def flags(self):
        return time_chunks.WCSPH_OPTIONS[self.option] if self.option else ()

    @property
    def key(self):
        """The scheme and the option: ``JAX_DECAY``'s key."""
        return self.scheme + (' ' + self.option if self.option else '')

    @property
    def label(self):
        """Its ``time_chunks.PATHS`` label."""
        return 'taylor_green %s nx=400%s' % (
            self.key, ' dense' if self.engine == 'dense' else '')


#: the Taylor-Green vortex's other runs
TG_RUNS = (
    TgRun('wcsph', 'kernel', '', ((wp.wcsph_pair, 1, 1),), 1),
    TgRun('wcsph', 'dense', '', ((dp.dense_pair, 1, 1),), 1),
    TgRun('gtvf', 'kernel', '', ((gp.gtvf_pair, 1, 3),), 2),
    TgRun('wcsph', 'kernel', 'delta',
          ((dl.delta_pair, 2, 2, 0.5), (wp.wcsph_pair, 1, 1)), 1),
    TgRun('wcsph', 'kernel', 'summation', ((wp.wcsph_pair, 2, 2),), 1),
    TgRun('wcsph', 'kernel', 'tensile', ((wp.wcsph_pair, 1, 1),), 1),
)
#: by pair kernel: (its pack, the pack's plain version, its work count,
#: the TPU kernel it replaces, the mangled template flags after the kind
#: of its periodic instantiations on the runs' paths)
TG_KERNELS = {
    wp.wcsph_pair: (wp.pack_sources, wp.pack_sources_reference,
                    roofline.wcsph_work, 'pysph_tpu/ops/resident.py:645',
                    'ELb[01]ELb1ELb1E'),
    dp.dense_pair: (wp.pack_sources, wp.pack_sources_reference,
                    roofline.wcsph_work, 'pysph_tpu/ops/pallas_engine.py:574',
                    'ELb1ELb1E'),
    gp.gtvf_pair: (gp.pack_sources, gp.pack_sources_reference,
                   roofline.gtvf_work, 'pysph_tpu/ops/pallas_engine.py:1160',
                   'ELb1E'),
    dl.delta_pair: (dl.pack_sources, dl.pack_sources_reference,
                    roofline.delta_work, 'pysph_tpu/ops/resident.py:645',
                    r'ELi\dELb[01]ELb1E'),
}
#: the pair kernels that take a smoothing kernel's kind, each of whose
#: later kinds is a library of its own (``ops/build.py``)
KIND_KERNELS = ('tvf_pair', 'wcsph_pair', 'gtvf_pair', 'dense_pair',
                'delta_pair', 'gasd_pair')
#: the props the engines must agree on, by scheme
TG_PROPS = {'wcsph': ('x', 'y', 'u', 'v', 'rho', 'p', 'arho', 'au', 'av'),
            'gtvf': ('x', 'y', 'u', 'v', 'rho', 'p', 'rhodiv', 'au', 'av',
                     'auhat', 'avhat')}


def _path_resources(op):
    """{mangled name: (registers, spill store bytes, spill load bytes)} of
    the ``QuinticSpline`` instantiations of the kernel of ``op`` with the
    periodic flag that the Taylor-Green runs launch, in its built library
    (``build.resources``)."""
    path = re.compile(op.__name__ + '_kernelI[fd]Li3' + TG_KERNELS[op][4])
    return {name.split('_pair_kernel')[-1]: res
            for name, res in sorted(build.resources(
                build.build(op.__name__)).items())
            if path.search(name)}


def _delta_run_linked(s):
    """The Taylor-Green ``--delta-sph`` run of ``s`` ran its two
    ``delta_pair`` plans linked, with no dest past the list's capacity
    (the counter reset before the run)."""
    plans = [p for a in s.acceleration_evals for p in a._plans.values()
             if p is not None and p.op is dl.delta_pair]
    links = {id(p.link) for p in plans if p.link is not None}
    overflowed = dl.overflowed('cuda')
    print('taylor_green wcsph --delta-sph nx=400: %d linked delta_pair '
          'pair, %d dests past the list\'s capacity in the runs'
          % (len(links), overflowed), flush=True)
    if len(plans) != 2 or len(links) != 1 or overflowed:
        raise AssertionError('the Taylor-Green --delta-sph run was not '
                             'linked, or %d dests overflowed its list'
                             % overflowed)


def _tg_kernel_times(op, calls):
    """(ms in a graph, eager ms, plain ms, work, the linked pair's times
    or None) of ``op``'s calls of one eval, as the path runs them."""
    mine = [c for c in calls if c[2].op is op]
    count = TG_KERNELS[op][2]
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in mine], 3)
    if not linked_calls(mine):
        eager = events_ms(lambda: [op(*c[3]) for c in mine], 20)
        ms = graph_ms(lambda: [op(*c[3]) for c in mine], 20)
        return ms, eager, plain_ms, _calls_work(mine, count), None
    times, linked_fn = _linked_times(op, mine)
    ((_, _, _, first), (_, _, _, second)), = linked_calls(mine)
    # the consuming call tests no candidate: one walk's tests
    work = roofline.add(count(*first), count(*second, walks=False))
    return (times['linked'], events_ms(linked_fn, 20), plain_ms, work,
            times)


def _tg_scheme_phase(runs, kernels, run):
    """The Taylor-Green vortex under another scheme or option
    (``TG_RUNS``): each kernel's periodic branch against its plain
    version on the path's calls (``tvf_check.calls``: perturbed, and with
    a tenth of the particles on the box's edges and corners; after one
    eval for ``--delta-sph``, whose ``delta_pair`` calls are also held by
    ``delta_check``: the flipped accept decisions counted and 0, the
    linked pair bit for bit the walk and its list
    ``neighbours_reference``'s) at nx=50 in both dtypes and at nx=400 in
    float32, the pack of each call exact, timed and counted at nx=400
    with the path's kernels' registers and spills; the kernel engine
    against the torch engine at nx=50 from ``--perturb 0.1`` in float64
    for 10 steps; then the path at nx=400 as the main path under the
    binning reuse, every dest on its kernel (the launch counts), with its
    decay against the JAX package's (``_tg_decay``).  Adds an entry
    ``<kernel> periodic[ <option>]`` for each of its kernels."""
    ops = [d[0] for d in run.drive]
    delta = dl.delta_pair in ops
    what = 'taylor_green --scheme %s%s%s' % (
        run.scheme, ''.join(' ' + f for f in run.flags),
        ' --engine dense' if run.engine == 'dense' else '')
    flips = 0
    for nx, dtype, edges in ((50, torch.float64, False),
                             (50, torch.float64, True),
                             (50, torch.float32, False),
                             (50, torch.float32, True),
                             (400, torch.float32, True)):
        calls, n, moved = tvf_check.calls(nx, dtype, edges, run.scheme,
                                          run.engine, run.flags, delta)
        if not all(c[3][5].is_periodic for c in calls) or \
                {c[2].op for c in calls} != set(ops):
            raise AssertionError('%s: calls off the periodic %s' % (
                what, [op.__name__ for op in ops]))
        label = '%s nx=%d %s%s (%d particles%s)' % (
            what, nx, str(dtype)[6:], ' edges' * edges, n,
            ', %d on the edges' % moved if edges else '')
        _compare(calls, dtype, label)
        if delta:
            flips += delta_check.check(calls, label)['flips']
            flips += delta_check.check_linked(calls, label)['flips']
        del calls
    if flips:
        raise AssertionError('%s: %d flipped accept decisions' % (what,
                                                                   flips))
    calls, n, _ = tvf_check.calls(400, torch.float32, False, run.scheme,
                                  run.engine, run.flags, delta)
    if n != 160000:
        raise AssertionError('taylor_green at nx=400 has %d particles, not '
                             '160,000' % n)
    errs = {}
    for op in ops:
        errs[op] = _compare([c for c in calls if c[2].op is op],
                            torch.float32, '%s %s nx=400 float32 (%d '
                            'particles)' % (op.__name__, what, n))
    if delta:
        found = delta_check.check(calls, what + ' nx=400')
        linked = delta_check.check_linked(calls, what + ' nx=400')
        if found['flips'] + linked['flips']:
            raise AssertionError('%s nx=400: flipped accept decisions'
                                 % what)
    for k, dest, plan, args in calls:
        pack, pack_reference = TG_KERNELS[plan.op][:2]
        _check_pack('%s nx=400 eval %d %s' % (what, k, dest),
                    pack(args[4]), pack_reference(args[4]))
    timed = {}
    for op in ops:
        ms, eager, plain_ms, work, linked = timed[op] = _tg_kernel_times(
            op, calls)
        name = op.__name__
        print('%s, its %d launches of one step\'s evals of %s at nx=400 '
              'float32 (grid %s, periodic %s; the pack included%s): kernel '
              '%.4f ms in a graph, %.4f eager, plain torch %.3f ms; bound '
              '%.4f ms (%s: %.4g flops, %d B); %d candidates, %d visited, '
              '%d pairs; registers and spill bytes (stores, loads) of the '
              'periodic QuinticSpline kernels: %s' % ((
                  name, sum(c[2].op is op for c in calls), what,
                  calls[0][3][5].dims, calls[0][3][5].periodic,
                  ', linked: the moment emits, the gradient consumes; alone '
                  '%.4f and %.4f, the two walking launches %.4f' % (
                      linked['emit'], linked['consume'], linked['walking'])
                  if linked else '', ms, eager, plain_ms) +
                  roofline.bound(work) + (
                      work['flops'], work['bytes'], work['candidates'],
                      work['visited'], work['pairs'], _path_resources(op))),
              flush=True)
    del calls
    _engines_agree('%s nx=50' % what, None, 10,
                   TG_PROPS[run.scheme], cls=TaylorGreen, engine=run.engine,
                   extra=('--nx', '50', '--perturb', '0.1', '--scheme',
                          run.scheme) + run.flags)
    kw = time_chunks.PATHS[run.label]
    start = make_app(None, torch.float32, **{
        k: v for k, v in kw.items() if k != 'dx'}).solver.states['fluid']
    decay = dict(vmax0=float(torch.sqrt(start['u'] ** 2 +
                                        start['v'] ** 2).max()))
    del start
    dl.reset_overflow('cuda')
    runs[run.label, 'reuse'] = _drive(
        run.label, kw, run.drive, run.bins, engine=run.engine,
        checks=(functools.partial(_tg_decay, decay, key=run.key),) + (
            (_delta_run_linked,) if delta else ()))
    for op in ops:
        ms, eager, plain_ms, work, linked = timed[op]
        name = op.__name__
        extra = {} if linked is None else dict(
            per_launch_ms=[linked['emit'], linked['consume']],
            walking_ms=linked['walking'], flips=flips)
        entry = '%s periodic%s' % (name, ' ' + run.option if run.option
                                   else '')
        kernels[entry] = dict(_entry(
            name, TG_KERNELS[op][3],
            runs[run.label, 'reuse']['launches'][name], errs[op], ms,
            plain_ms, work, None, eager_ms=eager,
            resources=_path_resources(op),
            decay=decay, path='%s nx=400, the %s calls of one step (%d '
            'launches)' % (what, name, next(d[2] for d in run.drive
                                            if d[0] is op)), **extra),
            name=entry)


#: the TVF wall examples' checks of ``_tvf_wall_phase``: (example, its
#: arguments, dtypes, with the edge particles too)
WALL_CHECKS = (
    ('cavity', ('--nx', '50'), (torch.float64, torch.float32), True),
    ('poiseuille', (), (torch.float64, torch.float32), True),
    ('rayleigh_taylor', (), (torch.float32,), False),
    ('periodic_cylinders', (), (torch.float32,), False),
)


def _tvf_linked_runs(label, fluids, out=None):
    """A check of a solver (``_drive``'s ``checks``): each of its
    ``fluids`` fluids ran its ``tvf_pair`` density and momentum plans
    linked, with no dest past the list's capacity in the runs (the
    counter reset before them); with ``out``, the dests past it are
    counted into ``out['overflowed']`` instead (their warps walk: a run
    whose particles cluster, as Rayleigh-Taylor's two phases do under
    one reference density)."""
    def check(s):
        plans = [p for a in s.acceleration_evals for p in a._plans.values()
                 if p is not None and p.op is tp.tvf_pair]
        links = {id(p.link) for p in plans if p.link is not None}
        overflowed = tp.overflowed('cuda')
        print('%s: %d linked tvf_pair pairs of %d plans, %d dests past the '
              'list\'s capacity in the runs' % (label, len(links),
                                                len(plans), overflowed),
              flush=True)
        if out is not None:
            out['overflowed'] = overflowed
        if len(plans) != 2 * fluids or len(links) != fluids or \
                any(p.link is None for p in plans) or \
                (overflowed and out is None):
            raise AssertionError('%s: not linked, or %d dests overflowed '
                                 'the list' % (label, overflowed))
    return check


def _cavity_figures(out, solver, jax=JAX_CAVITY, label='cavity'):
    """The cavity's fluid max speed and kinetic energy after its run,
    against the JAX package's same run (``jax``: ``JAX_CAVITY``, or
    ``JAX_CAVITY_EDAC`` for ``--scheme edac``, to ``CAVITY_TOL``
    relative); into ``out``."""
    st = solver.states['fluid']
    u, v, m = (st[c].double() for c in ('u', 'v', 'm'))
    speed2 = u * u + v * v
    vmax, ke = float(speed2.max().sqrt()), float(0.5 * (m * speed2).sum())
    errs = (vmax / jax[0] - 1.0, ke / jax[1] - 1.0)
    out.update(t=solver.t, vmax=vmax, ke=ke, jax_vmax=jax[0],
               jax_ke=jax[1], rel_err=errs)
    print('%s nx=400 float32 at t=%.6g after %d steps: fluid max speed '
          '%.7f (JAX %.7f, relative %.3g), kinetic energy %.7g (JAX %.7g, '
          'relative %.3g); bar %.0e' % (
              label, solver.t, solver.count, vmax, jax[0], errs[0], ke,
              jax[1], errs[1], CAVITY_TOL), flush=True)
    if not max(abs(e) for e in errs) <= CAVITY_TOL:
        raise AssertionError('%s missed the JAX package\'s run' % label)


def _profile_run(example):
    """Poiseuille's or Couette's flow as the example defines itself (to
    its tf, float32, on the kernels, dumping into a temporary directory
    under ``build/``): the ``post_process`` error against the exact
    steady profile within ``PROFILE_SLACK`` of the JAX package's
    (``JAX_PROFILE``), every dest on a kernel, the fluid's pair linked
    with no dest past its capacity.  Returns what it measured."""
    cls = {'poiseuille': PoiseuilleFlow, 'couette': CouetteFlow}[example]
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix=example + '_', dir=build.BUILD_DIR)
    try:
        app = cls()
        app.setup(['-q', '--device', 'cuda', '-d', out])
        s = app.solver
        tp.reset_overflow('cuda')
        tp.tvf_pair.launches = gp.gtvf_pair.launches = 0
        start = time.perf_counter()
        app.solve()
        secs = time.perf_counter() - start
        launches = (tp.tvf_pair.launches, gp.gtvf_pair.launches)
        _tvf_linked_runs(example, 1)(s)
        for name, st in s.states.items():
            if not all(bool(v.isfinite().all()) for v in st.values()
                       if v.is_floating_point()):
                raise AssertionError('%s: non-finite %s' % (example, name))
        if set(s.acceleration_evals[0].engine_choices.values()) != \
                {'kernel'}:
            raise AssertionError('%s: a dest off the kernels' % example)
        _, u, ue = app.post_process(app.info_filename)
        err = profile_error(u, ue)
        bar = JAX_PROFILE[example] + PROFILE_SLACK
        print('%s float32 to t=%.6g (%d steps, %.1f s, %.4f ms/step with '
              'dumps; %d captures, %d replays, %d reads; launches counted '
              'eager and a capture once: tvf_pair %d, gtvf_pair %d): '
              'post_process error against the exact profile %.5f, JAX\'s '
              '%.5f, bar %.5f' % (
                  example, s.t, s.count, secs, 1e3 * secs / s.count,
                  s.captures, s.replays, s.reads, launches[0], launches[1],
                  err, JAX_PROFILE[example], bar), flush=True)
        if not (abs(s.t - s.tf) <= 1e-6 * s.tf and err <= bar):
            raise AssertionError('%s missed the exact profile' % example)
        return dict(t=s.t, steps=s.count, s=secs, err=err,
                    jax_err=JAX_PROFILE[example], bar=bar)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _tvf_wall_phase(runs, kernels, bins):
    """The Adami walls on ``tvf_pair`` (its no-slip term, the ``WALL``
    instantiations) and the TVF wall examples.  Every pair kernel of the
    wall examples' evals (each fluid's density and momentum on
    ``tvf_pair``, the wall's velocity and pressure on ``gtvf_pair``)
    against its plain version (``tvf_check.wall_calls``: the fluids
    jittered and seeded, and with a tenth of them on their box's edges
    and corners, after one eval) on the cavity's open grid at nx=50 and
    Poiseuille's channel, periodic in x, in float64 and float32, and on
    Rayleigh-Taylor and the periodic cylinders in float32, with the
    linked pair on each (``tvf_check.check_linked``: its list, its bits
    against the walk, no dest past the capacity but in the edge cases);
    the cavity at nx=400 (160,000 fluid and 8,921 wall particles) the
    same in float32, timed there (the linked pair against the two
    walking launches and each launch alone, the wall's ``gtvf_pair``
    calls) with the open-grid kernels' registers and spills; then the
    cavity at nx=400 as the main path under the binning reuse (2
    ``tvf_pair`` and 2 ``gtvf_pair`` launches in the initial eval and a
    step, linked, no overflow), with its fluid's max speed and kinetic
    energy against the JAX package's (``JAX_CAVITY``); Poiseuille's and
    Couette's flow to their tf with the ``post_process`` error against
    ``JAX_PROFILE``; Rayleigh-Taylor (two linked pairs) and the periodic
    cylinders for ``STEPS`` steps as the main path, the dests past the
    list's capacity counted (Rayleigh-Taylor's phases, under one
    reference density, cluster: their warps walk).  Adds the entries
    ``tvf_pair wall`` and ``gtvf_pair wall``."""
    for example, extra, dtypes, with_edges in WALL_CHECKS:
        for dtype in dtypes:
            for edges in (False, True) if with_edges else (False,):
                calls, n, moved = tvf_check.wall_calls(example, dtype, edges,
                                                       extra)
                what = '%s%s %s%s (%d particles%s)' % (
                    example, ''.join(' ' + a for a in extra),
                    str(dtype)[6:], ' edges' * edges, n,
                    ', %d on the edges' % moved if edges else '')
                _compare(calls, dtype, 'tvf_pair/gtvf_pair ' + what)
                found = tvf_check.check_linked(calls, what, TOL[dtype])
                if found['overflowed'] and not edges:
                    raise AssertionError('%s: %d dests past the list\'s '
                                         'capacity' % (what,
                                                       found['overflowed']))
                del calls
    calls, n, _ = tvf_check.wall_calls('cavity', torch.float32, False,
                                       ('--nx', '400'))
    if n != 168921 or calls[0][3][5].is_periodic:
        raise AssertionError('the cavity at nx=400 has %d particles, not '
                             '168,921, or a periodic grid' % n)
    what = 'cavity nx=400 float32 (%d particles)' % n
    tvf = [c for c in calls if c[2].op is tp.tvf_pair]
    gtvf = [c for c in calls if c[2].op is gp.gtvf_pair]
    err = _compare(tvf, torch.float32, 'tvf_pair ' + what)
    gtvf_err = _compare(gtvf, torch.float32, 'gtvf_pair ' + what)
    linked = tvf_check.check_linked(calls, what, TOL[torch.float32])
    if linked['overflowed']:
        raise AssertionError('%s: %d dests past the list\'s capacity'
                             % (what, linked['overflowed']))
    err = max(err, linked['max_abs_err'])
    for k, dest, plan, args in calls:
        pack, ref = ((tp.pack_sources, tp.pack_sources_reference)
                     if plan.op is tp.tvf_pair else
                     (gp.pack_sources, gp.pack_sources_reference))
        _check_pack('cavity nx=400 ' + dest, pack(args[4]), ref(args[4]))
    times, linked_fn = _linked_times(tp.tvf_pair, tvf)
    eager = events_ms(linked_fn, 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in tvf], 3)
    ((_, _, _, dargs), (_, _, _, margs)), = linked_calls(tvf)
    work = roofline.add(roofline.tvf_work(*dargs),
                        roofline.tvf_work(*margs, walks=False))
    bound_ms, bound_by = roofline.bound(work)
    resources = tvf_check.resources(build.build('tvf_pair'), periodic=False)
    gtvf_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in gtvf], 20)
    gtvf_eager = events_ms(lambda: [c[2].op(*c[3]) for c in gtvf], 20)
    gtvf_plain = events_ms(lambda: [c[2].reference(*c[3]) for c in gtvf],
                           3)
    gtvf_work = _calls_work(gtvf, roofline.gtvf_work)
    print('tvf_pair, the 2 launches of one eval of the cavity at nx=400 '
          'float32 (grid %s, open; the wall a source of the momentum call, '
          'its no-slip term), graph replays alternated in this process: '
          'linked (emit + consume, each packing) %.4f ms, walking (2 walks) '
          '%.4f ms; alone: emit %.4f, consume %.4f, density walk %.4f, '
          'momentum walk %.4f; linked eager %.3f, plain torch %.3f ms; bound '
          '%.4f ms (%s, one walk: %.4g flops, %d candidates, %d pairs, %d '
          'B); share %.1f%%; registers and spill bytes (stores, loads) of '
          'the open-grid kernels by mode: %s' % ((
              calls[0][3][5].dims, times['linked'], times['walking'],
              times['emit'], times['consume'], times['first walk'],
              times['second walk'], eager, plain_ms, bound_ms, bound_by,
              work['flops'], work['candidates'], work['pairs'],
              work['bytes'], 100 * bound_ms / times['linked'], resources)),
          flush=True)
    print('gtvf_pair, the wall\'s 2 launches (SetWallVelocity, '
          'SolidWallPressureBC) of one eval of the cavity at nx=400 float32: '
          '%.4f ms in a graph, %.4f eager, plain torch %.3f ms; bound %.4f '
          'ms (%s); %d candidates, %d pairs' % ((
              gtvf_ms, gtvf_eager, gtvf_plain) + roofline.bound(gtvf_work) +
              (gtvf_work['candidates'], gtvf_work['pairs'])), flush=True)
    del calls, tvf, gtvf, linked_fn, dargs, margs
    label = 'cavity nx=400'
    figures = {}
    tp.reset_overflow('cuda')
    runs[label, 'reuse'] = _drive(
        label, time_chunks.PATHS[label],
        ((tp.tvf_pair, 2, 2), (gp.gtvf_pair, 2, 2)), 1,
        checks=(functools.partial(_bin_phase, label, out=bins),
                _tvf_linked_runs(label, 1),
                functools.partial(_cavity_figures, figures)))
    if runs[label, 'reuse']['particles'] != 168921:
        raise AssertionError('the cavity at nx=400 has %d particles'
                             % runs[label, 'reuse']['particles'])
    profiles = {example: _profile_run(example)
                for example in ('poiseuille', 'couette')}
    overflows = {}
    for label, fluids in (('rayleigh_taylor', 2), ('periodic_cylinders', 1)):
        tp.reset_overflow('cuda')
        overflows[label] = {}
        runs[label, 'reuse'] = _drive(
            label, time_chunks.PATHS[label],
            ((tp.tvf_pair, 2 * fluids, 2 * fluids), (gp.gtvf_pair, 2, 2)), 1,
            checks=(_tvf_linked_runs(label, fluids, overflows[label]),))
    launches = runs['cavity nx=400', 'reuse']['launches']
    kernels['tvf_pair wall'] = dict(_entry(
        'tvf_pair', 'pysph_tpu/ops/resident.py:645', launches['tvf_pair'],
        err, times['linked'], plain_ms, work, None, eager_ms=eager,
        share=bound_ms / times['linked'],
        per_launch_ms=[times['emit'], times['consume']],
        walking_ms=times['walking'],
        walking_per_launch_ms=[times['first walk'], times['second walk']],
        overflowed=linked['overflowed'], max_count=linked['max_count'],
        capacity=linked['capacity'], resources=resources,
        cavity=figures, profiles=profiles, overflows=overflows,
        path='cavity nx=400, one eval (2 launches, linked: the density '
        'emits, the momentum with the no-slip wall consumes)'),
        name='tvf_pair wall')
    kernels['gtvf_pair wall'] = dict(_entry(
        'gtvf_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
        launches['gtvf_pair'], gtvf_err, gtvf_ms, gtvf_plain, gtvf_work,
        None, eager_ms=gtvf_eager,
        path='cavity nx=400, the wall\'s 2 calls of one eval'),
        name='gtvf_pair wall')


class EdacRun(NamedTuple):
    """An EDAC run of ``_edac_phase``: its ``time_chunks.PATHS`` label,
    its example, the arguments of the checks' small size and of the
    path's, the particles at the path's size, ``_drive``'s ops and the
    ``tvf_pair`` calls that read the density call's list."""
    label: str
    example: str
    small: tuple
    full: tuple
    particles: int
    drive: tuple
    consumers: int


#: EDACScheme's three runs
EDAC_RUNS = (
    EdacRun('taylor_green edac nx=400', 'taylor_green', ('--nx', '50'),
            ('--nx', '400'), 160000, ((tp.tvf_pair, 2, 2),), 1),
    EdacRun('cavity edac nx=400', 'cavity', ('--nx', '50'), ('--nx', '400'),
            168921, ((tp.tvf_pair, 3, 3), (gp.gtvf_pair, 1, 1)), 2),
    EdacRun('dam_break_2d edac dx=0.004', 'dam_break_2d', ('--dx', '0.02'),
            ('--dx', '0.004'), 137803,
            ((tp.tvf_pair, 2, 2), (gp.gtvf_pair, 1, 1)), 1),
)


def _edac_calls(run, dtype, edges, full):
    """(calls, particles, particles on the edges) of one eval of ``run``
    at its small or its full size (``tvf_check``: perturbed, the fluid's
    pressure seeded, and with ``edges`` a tenth of the fluid on its box's
    edges and corners)."""
    size = run.full if full else run.small
    if run.example == 'taylor_green':
        return tvf_check.calls(int(size[1]), dtype, edges, scheme='edac')
    return tvf_check.wall_calls(run.example, dtype, edges,
                                size + ('--scheme', 'edac'))


def _chain_times(calls, rounds=5, reps=20):
    """Median ms of CUDA graph replays of the linked ``tvf_pair`` calls
    of ``calls`` run as the path runs them (the density call emitting,
    the mean-pressure call and the momentum call consuming), of them all
    walking, and of each launch alone (the consuming ones on a hand-off
    emitted before), alternated over ``rounds`` rounds in this process;
    and the linked calls as a function."""
    (first, last), = linked_calls(calls)
    args = [first[3]] + [c[3] for c in tvf_check.middle_calls(
        calls, first)] + [last[3]]
    op = tp.tvf_pair

    def linked():
        _, handoff = op(*args[0], emit=True)
        return [op(*a, handoff=handoff) for a in args[1:]]

    _, held = op(*args[0], emit=True)
    fns = {'linked': linked,
           'walking': lambda: [op(*a) for a in args],
           'emit': lambda: op(*args[0], emit=True)}
    for k, a in enumerate(args[1:]):
        fns['consume %d' % k] = functools.partial(op, *a, handoff=held)
    for k, a in enumerate(args):
        fns['walk %d' % k] = functools.partial(op, *a)
    graphs = {k: capture(fn) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(events_ms(graph.replay, reps))
    del graphs, held
    work = roofline.add(roofline.tvf_work(*args[0]), *[
        roofline.tvf_work(*a, walks=False) for a in args[1:]])
    return {k: float(np.median(v)) for k, v in times.items()}, linked, work


def _edac_linked(run):
    """A check of ``_drive``: the run's fluid ran every ``tvf_pair`` plan
    through one link, the density plan emitting and each consuming plan
    (the momentum plan last) reading its list, with no dest past the
    list's capacity in the runs (the counter reset before them)."""
    def check(s):
        plans = [p for a in s.acceleration_evals for p in a._plans.values()
                 if p is not None and p.op is tp.tvf_pair]
        links = {id(p.link): p.link for p in plans if p.link is not None}
        overflowed = tp.overflowed('cuda')
        print('%s: %d linked tvf_pair plans of %d, %d consuming the density '
              'call\'s list (the momentum call last), %d dests past the '
              'list\'s capacity in the runs' % (
                  run.label, sum(p.link is not None for p in plans),
                  len(plans), sum(len(k.consumers) for k in links.values()),
                  overflowed), flush=True)
        consumer = [k.consumer for k in links.values()]
        if len(links) != 1 or len(plans) != 1 + run.consumers or \
                any(p.link is None for p in plans) or overflowed or \
                'au' not in consumer[0].outputs:
            raise AssertionError('%s: not linked, or %d dests overflowed '
                                 'the list' % (run.label, overflowed))
    return check


def _wall_pressure(label, wall):
    """A check of ``_drive``: the wall's pressure after the run is >= 0
    (``ClampWallPressure``)."""
    def check(s):
        low = float(s.states[wall]['p'].min())
        print('%s: the wall\'s least pressure after the run %.6g (>= 0)'
              % (label, low), flush=True)
        if not low >= 0.0:
            raise AssertionError('%s: a wall pressure below 0' % label)
    return check


def _dam_break_figures():
    """The EDAC dam break at ``DAM_BREAK_FIGURE_DX`` in float32 for
    ``STEPS`` steps per step, the wall's least pressure read before each
    step and after the last (>= 0 throughout), and the fluid's front
    (max x) and kinetic energy against the JAX package's same run
    (``JAX_DAM_BREAK_EDAC``, to ``CAVITY_TOL`` relative)."""
    app = make_app(DAM_BREAK_FIGURE_DX, torch.float32, steps=STEPS,
                   cls=DamBreak2D, extra=('--scheme', 'edac'))
    s = app.solver
    s.chunk_steps = 1
    low = []
    s.add_pre_step_callback(lambda solver: low.append(
        float(solver.states['boundary']['p'].min())))
    app.solve()
    low.append(float(s.states['boundary']['p'].min()))
    st = s.states['fluid']
    u, v, m = (st[c].double() for c in ('u', 'v', 'm'))
    front = float(st['x'].max())
    ke = float(0.5 * (m * (u * u + v * v)).sum())
    errs = (front / JAX_DAM_BREAK_EDAC[0] - 1.0,
            ke / JAX_DAM_BREAK_EDAC[1] - 1.0)
    print('dam_break_2d edac dx=%g float32 at t=%.6g after %d steps: front '
          '%.7f (JAX %.7f, relative %.3g), kinetic energy %.7g (JAX %.7g, '
          'relative %.3g); bar %.0e; the wall\'s least pressure over %d '
          'reads %.6g (>= 0)' % (
              DAM_BREAK_FIGURE_DX, s.t, s.count, front,
              JAX_DAM_BREAK_EDAC[0], errs[0], ke, JAX_DAM_BREAK_EDAC[1],
              errs[1], CAVITY_TOL, len(low), min(low)), flush=True)
    if s.count != STEPS or not max(abs(e) for e in errs) <= CAVITY_TOL or \
            not min(low) >= 0.0:
        raise AssertionError('the EDAC dam break missed the JAX package\'s '
                             'run, or a wall pressure fell below 0')
    return dict(t=s.t, front=front, ke=ke, rel_err=errs,
                jax=JAX_DAM_BREAK_EDAC, wall_p_min=min(low))


def _edac_phase(runs, kernels):
    """``EDACScheme``'s three runs (``EDAC_RUNS``: ``taylor_green``,
    ``cavity`` and ``dam_break_2d --scheme edac``): ``tvf_pair``'s EDAC
    terms and ``gtvf_pair``'s EDAC wall set against their plain versions
    on each run's calls (``_edac_calls``: perturbed, the pressure seeded,
    and with a tenth of the fluid on its box's edges and corners) at the
    small size in both dtypes and at the path's size in float32, the
    linked calls bit for bit the walk (``tvf_check.check_linked``: the
    density call emitting, the cavity's mean-pressure call and each
    momentum call reading its list), the dests whose ``nnbr`` differs
    counted (0 from these starts), each pack exact; timed at the path's
    size with the EDAC instantiations' registers and spills; the dests
    whose ``nnbr`` differs at the path's own start counted; then each
    path for ``STEPS`` steps as the main path under the binning reuse
    (every dest on a kernel, one link, no dest past the list), with its
    gate: the Taylor-Green decay against ``JAX_DECAY['edac']`` and the
    exact one, the cavity against ``JAX_CAVITY_EDAC``, the dam break's
    wall pressure >= 0 and, at ``DAM_BREAK_FIGURE_DX``, its front and
    energy against ``JAX_DAM_BREAK_EDAC``.  Adds the entries ``tvf_pair
    edac <example>`` and ``gtvf_pair edac <example>``."""
    edac_lib = build.build('tvf_pair', tp.EDAC_FLAGS)
    for run in EDAC_RUNS:
        for dtype, edges in ((torch.float64, False), (torch.float64, True),
                             (torch.float32, False), (torch.float32, True)):
            calls, n, moved = _edac_calls(run, dtype, edges, False)
            what = '%s edac %s %s%s (%d particles%s)' % (
                run.example, ' '.join(run.small), str(dtype)[6:],
                ' edges' * edges, n,
                ', %d on the edges' % moved if edges else '')
            _compare(calls, dtype, 'tvf_pair/gtvf_pair ' + what)
            found = tvf_check.check_linked(calls, what, TOL[dtype])
            if found['overflowed'] and not edges:
                raise AssertionError('%s: %d dests past the list\'s '
                                     'capacity' % (what, found['overflowed']))
            avgp, flips = tvf_check.nnbr_flips(calls)
            print('%s: %d ComputeAveragePressure calls, %d dests whose nnbr '
                  'differs from the plain version\'s' % (what, avgp, flips),
                  flush=True)
            if flips:
                raise AssertionError('%s: %d dests\' nnbr differ' % (what,
                                                                     flips))
            del calls
        calls, n, _ = _edac_calls(run, torch.float32, False, True)
        if n != run.particles:
            raise AssertionError('%s has %d particles, not %d'
                                 % (run.label, n, run.particles))
        what = '%s float32 (%d particles)' % (run.label, n)
        tvf = [c for c in calls if c[2].op is tp.tvf_pair]
        gtvf = [c for c in calls if c[2].op is gp.gtvf_pair]
        err = _compare(tvf, torch.float32, 'tvf_pair ' + what)
        linked = tvf_check.check_linked(calls, what, TOL[torch.float32])
        if linked['overflowed'] or linked['consumers'] != run.consumers:
            raise AssertionError('%s: %d dests past the list\'s capacity, '
                                 '%d consuming calls' % (
                                     what, linked['overflowed'],
                                     linked['consumers']))
        err = max(err, linked['max_abs_err'])
        avgp, flips = tvf_check.nnbr_flips(calls)
        if flips:
            raise AssertionError('%s: %d dests\' nnbr differ' % (what, flips))
        for k, dest, plan, args in calls:
            pack, ref = ((tp.pack_sources, tp.pack_sources_reference)
                         if plan.op is tp.tvf_pair else
                         (gp.pack_sources, gp.pack_sources_reference))
            _check_pack('%s %s' % (run.label, dest), pack(args[4]),
                        ref(args[4]))
        periodic = calls[0][3][5].is_periodic
        times, linked_fn, work = _chain_times(tvf)
        eager = events_ms(linked_fn, 20)
        plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in tvf], 3)
        bound_ms, bound_by = roofline.bound(work)
        resources = tvf_check.resources(edac_lib, periodic=periodic)
        print('tvf_pair, the %d launches of one eval of %s (grid %s, '
              'periodic %s), graph replays alternated in this process: '
              'linked (the density emits, %d consume; each packing) %.4f ms, '
              'walking %.4f ms; alone: %s; linked eager %.3f, plain torch '
              '%.3f ms; bound %.4f ms (%s, one walk: %.4g flops, %d '
              'candidates, %d pairs, %d B); share %.1f%%; %d dests whose '
              'nnbr differs in %d ComputeAveragePressure calls; the EDAC '
              'library\'s kernels, registers and spill bytes (stores, loads) '
              'by mode: %s' % (
                  len(tvf), what, calls[0][3][5].dims, periodic,
                  run.consumers, times['linked'], times['walking'],
                  ', '.join('%s %.4f' % (k, v) for k, v in times.items()
                            if k not in ('linked', 'walking')),
                  eager, plain_ms, bound_ms, bound_by, work['flops'],
                  work['candidates'], work['pairs'], work['bytes'],
                  100 * bound_ms / times['linked'], flips, avgp, resources),
              flush=True)
        wall = None
        if gtvf:
            gtvf_err = _compare(gtvf, torch.float32, 'gtvf_pair ' + what)
            gtvf_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in gtvf], 20)
            gtvf_eager = events_ms(lambda: [c[2].op(*c[3]) for c in gtvf],
                                   20)
            gtvf_plain = events_ms(
                lambda: [c[2].reference(*c[3]) for c in gtvf], 3)
            gtvf_work = _calls_work(gtvf, roofline.gtvf_work)
            wall = gtvf[0][1]
            print('gtvf_pair, the wall\'s EDAC set (SourceNumberDensity, '
                  'VolumeSummation, SolidWallPressureBC, SetWallVelocity) '
                  'of one eval of %s: %.4f ms in a graph, %.4f eager, plain '
                  'torch %.3f ms; bound %.4f ms (%s); %d candidates, %d '
                  'pairs' % ((what, gtvf_ms, gtvf_eager, gtvf_plain) +
                             roofline.bound(gtvf_work) + (
                                 gtvf_work['candidates'],
                                 gtvf_work['pairs'])), flush=True)
        del calls, tvf, gtvf, linked_fn
        kw = time_chunks.PATHS[run.label]
        start = make_app(dtype=torch.float32, **kw).solver
        avgp, start_flips = tvf_check.nnbr_flips(plan_calls(start, [0]))
        vmax0 = float(torch.sqrt(start.states['fluid']['u'] ** 2 +
                                 start.states['fluid']['v'] ** 2).max())
        print('%s at the example\'s own start: %d dests whose nnbr differs '
              'from the plain version\'s (a pair at the support\'s edge, '
              'W = 0, kept by one and dropped by the other) in %d '
              'ComputeAveragePressure calls' % (run.label, start_flips, avgp),
              flush=True)
        del start
        figures = dict(vmax0=vmax0)
        if run.example == 'taylor_green':
            gate = functools.partial(_tg_decay, figures, key='edac')
        elif run.example == 'cavity':
            gate = functools.partial(_cavity_figures, figures,
                                     jax=JAX_CAVITY_EDAC,
                                     label='cavity edac')
        else:
            gate = _wall_pressure(run.label, wall)
        tp.reset_overflow('cuda')
        runs[run.label, 'reuse'] = r = _drive(
            run.label, kw, run.drive, 1, checks=(_edac_linked(run), gate))
        for op, first, per_step in run.drive:
            want = first + per_step * (STEPS + r['counters']['captures'])
            print('%s: %s launches in the %d-step chunked run %d, the plan\'s '
                  '%d (%d in the initial eval, %d an eval, the warm-up step '
                  'of each capture once more)' % (
                      run.label, op.__name__, STEPS,
                      r['launches'][op.__name__], want, first, per_step),
                  flush=True)
            if r['launches'][op.__name__] != want:
                raise AssertionError('%s: %s launches off the plan'
                                     % (run.label, op.__name__))
        if run.example == 'dam_break_2d':
            figures.update(_dam_break_figures())
        name = 'tvf_pair edac ' + run.example
        kernels[name] = dict(_entry(
            'tvf_pair', 'pysph_tpu/ops/resident.py:645',
            r['launches']['tvf_pair'], err, times['linked'], plain_ms, work,
            None, eager_ms=eager, share=bound_ms / times['linked'],
            launch_ms=times, overflowed=linked['overflowed'],
            max_count=linked['max_count'], capacity=linked['capacity'],
            nnbr_flips_at_start=start_flips, resources=resources,
            figures=figures, path='%s, one eval (%d launches, linked: the '
            'density emits, %d consume)' % (run.label, 1 + run.consumers,
                                             run.consumers)), name=name)
        if wall is not None:
            name = 'gtvf_pair edac ' + run.example
            kernels[name] = dict(_entry(
                'gtvf_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
                r['launches']['gtvf_pair'], gtvf_err, gtvf_ms, gtvf_plain,
                gtvf_work, None, eager_ms=gtvf_eager,
                path='%s, the wall\'s EDAC set of one eval' % run.label),
                name=name)


class IisphRun(NamedTuple):
    """An IISPH run of ``_iisph_phase``: its ``time_chunks.STEP_PATHS``
    label, its ``iisph_check.RUNS`` name, the sizes of the checks and of
    the path, the particles at the path's size, the walking pair
    launches of an evaluation (2 more a pressure sweep), and the size
    and steps (None: to tf) of its gate against ``JAX_IISPH``."""
    label: str
    run: str
    small: object
    full: object
    particles: int
    fixed: int
    figure: object
    figure_steps: object


#: IISPHScheme's three runs
IISPH_RUNS = (
    IisphRun('taylor_green iisph nx=400', 'taylor_green', 50, 400, 160000,
             4, 400, 200),
    IisphRun('drop iisph nx=200', 'elliptical_drop', 40, 200, 125623, 4,
             50, None),
    IisphRun('dam_break_2d iisph dx=0.004', 'dam_break_2d', 0.02, 0.004,
             137803, 6, 0.02, 10),
)
#: the phase sets of iisph_pair, by phase id (ops/iisph_pair.py)
IISPH_SETS = ('density', 'advection', 'advected density', 'dijpj',
              'pressure sweep', 'pressure force')


def _iisph_set(call):
    terms = 0
    for ps in call[2].sources:
        terms |= ps.terms
    return IISPH_SETS[ip.phase_of(terms)]


def _iisph_times(calls, rounds=5, reps=20):
    """Median ms of CUDA graph replays, alternated over ``rounds`` rounds
    in this process, of the ``iisph_pair`` calls of one evaluation
    (``iisph_check.calls``) run as the path runs them (linked), all
    walking, and each phase set's calls alone (the consuming ones on a
    hand-off emitted before); the plain versions' ms a set; and the work
    a set (``roofline.iisph_work``, a consuming call's candidates
    uncounted)."""
    op = ip.iisph_pair
    (emitting, later), = iisph_check.chains(calls)
    consuming = {c[0] for c in later}
    _, held = op(*emitting[3], emit=True)
    sets = {}
    for c in calls:
        sets.setdefault(_iisph_set(c), []).append(c)

    def run_set(cs):
        for c in cs:
            if c[0] in consuming:
                op(*c[3], handoff=held)
            else:
                op(*c[3])
    fns = {'path': lambda: iisph_check.run_as_path(calls),
           'walking': lambda: [op(*c[3]) for c in calls]}
    for name, cs in sets.items():
        fns[name] = functools.partial(run_set, cs)
    graphs = {k: capture(fn) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(events_ms(graph.replay, reps))
    del graphs, held
    plain = {name: events_ms(lambda cs=cs: [c[2].reference(*c[3])
                                            for c in cs], 1)
             for name, cs in sets.items()}
    work = {name: roofline.add(*[roofline.iisph_work(
        *c[3], walks=c[0] not in consuming) for c in cs])
        for name, cs in sets.items()}
    return {k: float(np.median(v)) for k, v in times.items()}, plain, work


def _iisph_drive(run):
    """``run`` at full width in float32 for ``STEPS`` steps (the drop to
    tf if that comes first), in chunks of 10 replayed from a CUDA graph
    and per step, each timed by ``time_chunks.timed_solve`` (median
    ms/step: in chunks from the host clock after each chunk's read, per
    step from the host clock at each step's start, the card
    synchronised).  ``iisph_pair``'s, ``iisph_solve``'s and the pack's
    launches are set to 0 just before each run and read just after: per
    step, ``fixed`` pair launches and one solve an evaluation; in chunks,
    the eager launches (the initial eval and one warm-up step a capture)
    and a capture's ``fixed`` x K and K, the launches on the card the
    eager ones plus those of a capture x replays; a pack a launch.  Every
    dest on the kernel, no ``converged`` read, the final state finite, a
    wall's number density positive at its corners (the dests past the
    neighbour list printed: the dam break's, which diverges, walk), and
    the sweeps of every evaluation of the chunked run equal
    to the per-step run's (a step that differs printed with its mean
    compression's distance from the tolerance).  Returns the chunked
    run's figures, with ``per_step`` the other's and ``idle`` a replay's
    device idle share (``_iisph_idle``)."""
    ops = (ip.iisph_pair, isv.iisph_solve)
    out = {}
    for k in (10, 1):
        app = make_app(dtype=torch.float32, steps=STEPS,
                       **time_chunks.STEP_PATHS[run.label])
        s = app.solver
        a_eval, = s.acceleration_evals
        bodies = _chunk_launches(s, ops)
        comps = []
        if k == 1:
            # the mean compression after each step's solve, kept on the
            # card (a pre-step callback sees the step before's)
            s.add_pre_step_callback(lambda solver: comps.append(
                solver.states['fluid']['tmp_comp'].clone()))
        ip.iisph_pair.launches = isv.iisph_solve.launches = 0
        cell_pack.pack.launches = 0
        ip.reset_overflow('cuda')
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ms, samples = time_chunks.timed_solve(app, k)
        counted = [op.launches for op in ops]
        packs = cell_pack.pack.launches
        sweeps = list(a_eval.sweeps)
        overflowed = ip.overflowed('cuda')
        n = sum(st['x'].shape[0] for st in s.states.values())
        wall_v = [float(st['V'].min()) for name, st in s.states.items()
                  if name != 'fluid']
        per_step = (run.fixed, 1)
        if k == 1:
            on_card = counted
            ok = not bodies and counted == [f * (1 + s.count)
                                            for f in per_step]
        else:
            K = s.chunk_steps
            captured = [[c[q] for _, c, cap in bodies if cap]
                        for q in range(2)]
            warm = [[c[q] for _, c, cap in bodies if not cap]
                    for q in range(2)]
            eager = [c - sum(cap) for c, cap in zip(counted, captured)]
            on_card = [e + f * K * s.replays for e, f in zip(eager, per_step)]
            ok = s.captures >= 1 and all(
                set(captured[q]) == {f * K} and warm[q] == [f] * s.captures
                and eager[q] == f * (1 + s.n_damp + s.captures)
                for q, f in enumerate(per_step))
        row = dict(ms=ms, steps=s.count, t=s.t, particles=n,
                   launches=dict(zip(('iisph_pair', 'iisph_solve'),
                                     on_card)),
                   counted=counted, packs=packs, evals=len(sweeps),
                   sweeps=sweeps, converged_reads=a_eval.converged_reads,
                   reads=s.reads, reads_per_step=s.reads / s.count,
                   captures=s.captures, replays=s.replays,
                   rebuilds=s.rebuilds, overflowed=overflowed,
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                   vmax=float(torch.sqrt(s.states['fluid']['u'] ** 2 +
                                         s.states['fluid']['v'] ** 2).max()),
                   wall_v_min=min(wall_v) if wall_v else None)
        print('%s float32, chunk_steps=%d: %d steps to t=%.6g, median %.3f '
              'ms/step (min %.3f, max %.3f over %d samples from step %d), '
              '%.4g particle-steps/s; engines %s; launches counted %s, on '
              'the card %s (iisph_pair, iisph_solve; %d + %d a step); %d '
              'packs; %d evaluations, pressure sweeps min %d, mean %.3f, '
              'max %d; %d converged reads; host reads %.3f a step (%d); %d '
              'captures, %d replays; %d dests past the list\'s capacity; %d '
              'binnings; max |v| %.4g; the wall\'s least number density %s; '
              'peak device memory %.1f MiB' % (
                  run.label, k, s.count, s.t, ms, min(samples), max(samples),
                  len(samples), time_chunks.WARMUP, n / ms * 1e3,
                  a_eval.engine_choices, counted, on_card, run.fixed, 1,
                  packs, len(sweeps), min(sweeps), float(np.mean(sweeps)),
                  max(sweeps), a_eval.converged_reads, row['reads_per_step'],
                  s.reads, s.captures, s.replays, overflowed, s.rebuilds,
                  row['vmax'], row['wall_v_min'], row['peak_mib']),
              flush=True)
        finite = all(bool(torch.isfinite(v).all())
                     for st in s.states.values() for v in st.values()
                     if v.is_floating_point())
        if (not ok or set(a_eval.engine_choices.values()) != {'kernel'} or
                packs != sum(counted) or a_eval.converged_reads or
                not finite or
                len(sweeps) != 1 + s.count or
                not (s.count == STEPS or abs(s.t - s.tf) < 1e-9) or
                (wall_v and not min(wall_v) > 0.0)):
            raise AssertionError('%s, chunk_steps=%d did not run every pair '
                                 'phase through iisph_pair and the pressure '
                                 'group through iisph_solve, or ended '
                                 'non-finite: %s' % (run.label, k, bodies))
        if k == 10:
            out = row
            out['idle'] = _iisph_idle(run, s)
        else:
            out['per_step'] = row
            # the margin of each evaluation's last sweep (eval 0: the
            # initial one)
            spec, = [p.spec for p in a_eval._solves.values()]
            margins = [abs(t[1] / max(t[0], 1.0) - spec.rho0) / spec.rho0 -
                       spec.tolerance for t in torch.stack(
                           comps + [s.states['fluid']['tmp_comp']])
                       .double().tolist()]
        del app, s, a_eval
    differ = [(i, a, b, margins[i]) for i, (a, b) in
              enumerate(zip(out['sweeps'], out['per_step']['sweeps']))
              if a != b]
    out['sweeps_differ'] = differ
    print('%s: the sweeps of %d evaluations in chunks and per step %s%s; '
          'the mean compression\'s distance from the tolerance after a '
          'step: least %.4g; %.3f ms/step in chunks, %.3f per step' % (
              run.label, len(out['sweeps']),
              'equal' if not differ else 'differ at',
              '' if not differ else ' ' + '; '.join(
                  'eval %d: %d and %d sweeps, margin %s' % d
                  for d in differ), min(abs(m) for m in margins[1:]),
              out['ms'], out['per_step']['ms']), flush=True)
    return out


def _iisph_idle(run, s):
    """The device's busy time and idle share of a step replayed from the
    chunked run's graph (``s``), from the trace of one replay
    (``prof_chunk.replay_gaps``: its span from the first device operation
    to the last, and the time in it that no operation runs), and a
    step's replay time from CUDA events around replays."""
    K = s.chunk_steps
    gaps = prof_chunk.replay_gaps(s._graph)
    replay = events_ms(s._graph.replay, 10)
    out = dict(replay_ms=replay / K, span_ms=gaps['span_us'] / 1e3 / K,
               busy_ms=(gaps['span_us'] - gaps['idle_us']) / 1e3 / K,
               idle_share=gaps['idle_us'] / gaps['span_us'],
               operations=gaps['ops'] / K, gaps=gaps['gaps'])
    print('%s: a step replayed from the chunk\'s graph: replay %.4f ms '
          '(events); one replay\'s trace: %.4f ms a step from its first '
          'device operation to its last, busy %.4f ms (%.0f operations), '
          'idle share %.1f%%; longest gaps %s' % (
              run.label, out['replay_ms'], out['span_ms'], out['busy_ms'],
              out['operations'], 100 * out['idle_share'], out['gaps']),
          flush=True)
    return out


def _iisph_gate(run):
    """``run`` at its ``figure`` size in float32 in chunks for its
    ``figure_steps`` (to tf where None), its figures against the
    JAX package's same run (``JAX_IISPH``) to CAVITY_TOL relative:
    Taylor-Green's decay ratio, the drop's max |y|, the dam break's front
    and kinetic energy."""
    size = '--nx' if run.run != 'dam_break_2d' else '--dx'
    app = iisph_check.app(run.run, run.figure, torch.float32,
                          steps=run.figure_steps or 0)
    s = app.solver
    st = s.states['fluid']
    vmax0 = float(torch.sqrt(st['u'] ** 2 + st['v'] ** 2).max())
    s.solve()
    st = {p: v.double().cpu().numpy() for p, v in
          s.states['fluid'].items() if v.is_floating_point()}
    if run.run == 'taylor_green':
        vmax, exact, l1 = decay_errors(st['x'], st['y'], st['u'], st['v'],
                                       s.t, 100.0)
        got = (vmax / (vmax0 * exact),)
        names = ('decay ratio',)
    elif run.run == 'elliptical_drop':
        got = (float(np.abs(st['y']).max()),)
        names = ('max |y|',)
    else:
        got = (float(st['x'].max()), float(0.5 * np.sum(st['m'] * (
            st['u'] ** 2 + st['v'] ** 2))))
        names = ('front', 'kinetic energy')
    want = JAX_IISPH[run.run]
    errs = [g / w - 1.0 for g, w in zip(got, want)]
    sweeps = s.acceleration_evals[0].sweeps
    print('%s iisph %s=%s float32 at t=%.6g after %d steps (%d captures, %d '
          'replays, %d converged reads): %s; bar %.0e; pressure sweeps a '
          'step min %d, mean %.3f, max %d' % (
              run.run, size, run.figure, s.t, s.count, s.captures,
              s.replays, s.acceleration_evals[0].converged_reads, '; '.join(
                  '%s %.7g (JAX %.7g, relative %.3g)' % x
                  for x in zip(names, got, want, errs)), CAVITY_TOL,
              min(sweeps), float(np.mean(sweeps)), max(sweeps)),
          flush=True)
    if not max(abs(e) for e in errs) <= CAVITY_TOL:
        raise AssertionError('%s missed the JAX package\'s figures'
                             % run.label)
    if not s.captures or s.acceleration_evals[0].converged_reads:
        raise AssertionError('%s: the gate ran off the chunks' % run.label)
    return dict(size=run.figure, steps=s.count, t=s.t, figures=got,
                jax=want, rel_err=errs)


def _solve_times(calls, rounds=5, reps=20):
    """Median ms of CUDA graph replays, alternated over ``rounds`` rounds
    in this process, of one evaluation as the path runs it now
    (``iisph_check.run_as_path`` over ``calls``, recorded with the solve:
    the pair calls linked and the ``iisph_solve`` call) and of the solve
    call alone; its eager ms; the plain version's ms (on the card, with
    torch's deterministic algorithms)."""
    call, = iisph_check.solve_calls(calls)
    args = call[3]
    fns = {'eval': lambda: iisph_check.run_as_path(calls),
           'solve': lambda: isv.iisph_solve(*args)}
    graphs = {k: capture(fn) for k, fn in fns.items()}
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, graph in graphs.items():
            times[k].append(events_ms(graph.replay, reps))
    del graphs
    out = {k: float(np.median(v)) for k, v in times.items()}
    out['solve_eager'] = events_ms(lambda: isv.iisph_solve(*args), reps)
    out['plain'] = events_ms(lambda: iisph_check._deterministic(
        lambda: isv.iisph_solve_reference(*args[:12])), 1)
    return out


def _iisph_phase(kernels):
    """``IISPHScheme``'s three runs (``IISPH_RUNS``: ``taylor_green``,
    ``elliptical_drop`` and ``dam_break_2d --scheme iisph``):
    ``iisph_pair``'s six phase sets against their plain versions on
    every pair call of one evaluation, the pressure group swept as the
    per-launch chain (its ``dijpj`` and pressure launches each sweep),
    from each run's own state after 3 steps of a jittered start
    (``iisph_check.calls``) at the small size in float64 and float32,
    with and without a tenth of the fluid on its box's edges and corners,
    and at the path's size in float32, every link
    (``iisph_check.check_linked``) bit for bit the walk and its list
    ``neighbours_reference``'s, each pack exact; and ``iisph_solve``, the
    pressure group in one launch, on the same states
    (``iisph_check.check_solve``): within the tolerance of its plain
    version with the same sweeps and bit for bit the per-launch chain
    where the sweeps agree, at the call's tolerance, at one that forces
    30 sweeps and at one that stops at 2; timed at the path's size (the
    evaluation linked and walking as the chain, each phase set alone, the
    evaluation with the solve, the solve alone, the plain versions) with
    both libraries' registers and spills; each path for ``STEPS`` steps
    in chunks and per step (``_iisph_drive``), a replayed step's device
    idle share (``_iisph_idle``), and its gate against the JAX package's
    figures (``_iisph_gate``, in chunks).  Adds the entries
    ``iisph_pair`` and ``iisph_solve`` (Taylor-Green), ``... 
    elliptical_drop`` and ``... dam_break_2d``; returns {label: the run's
    ``_iisph_drive``}."""
    lib = build.build('iisph_pair')
    solve_lib = build.build('iisph_solve')
    solve_res = iisph_check.solve_resources(solve_lib)
    runs = {}
    for run in IISPH_RUNS:
        for dtype, edges in ((torch.float64, False), (torch.float64, True),
                             (torch.float32, False), (torch.float32, True)):
            calls, n, moved, sweeps = iisph_check.calls(run.run, run.small,
                                                        dtype, edges=edges)
            what = '%s iisph %s %s%s (%d particles%s, %d sweeps, %d calls)' \
                % (run.run, run.small, str(dtype)[6:], ' edges' * edges, n,
                   ', %d on the edges' % moved if edges else '', sweeps,
                   len(calls))
            if len(calls) != run.fixed + 2 * sweeps:
                raise AssertionError('%s: %d calls' % (what, len(calls)))
            _compare(calls, dtype, 'iisph_pair ' + what)
            found = iisph_check.check_linked(calls, what, TOL[dtype])
            if found['overflowed'] and not edges:
                raise AssertionError('%s: %d dests past the list\'s '
                                     'capacity' % (what, found['overflowed']))
            del calls
            calls, _, _, _ = iisph_check.calls(run.run, run.small, dtype,
                                               edges=edges, solve=True)
            iisph_check.check_solve(iisph_check.solve_calls(calls)[0],
                                    'iisph_solve ' + what, TOL[dtype])
            del calls
        calls, n, _, sweeps = iisph_check.calls(run.run, run.full,
                                                torch.float32)
        if n != run.particles:
            raise AssertionError('%s has %d particles, not %d'
                                 % (run.label, n, run.particles))
        what = '%s float32 (%d particles, %d sweeps, %d calls)' % (
            run.label, n, sweeps, len(calls))
        err = _compare(calls, torch.float32, 'iisph_pair ' + what)
        linked = iisph_check.check_linked(calls, what, TOL[torch.float32])
        if linked['overflowed']:
            raise AssertionError('%s: %d dests past the list\'s capacity'
                                 % (what, linked['overflowed']))
        err = max(err, linked['max_abs_err'])
        for _, dest, _, args in calls:
            _check_pack('%s %s' % (run.label, dest),
                        ip.pack_sources(args[4]),
                        ip.pack_sources_reference(args[4]))
        times, plain, work = _iisph_times(calls)
        eager = events_ms(lambda: iisph_check.run_as_path(calls), 20)
        total = roofline.add(*work.values())
        bound_ms, bound_by = roofline.bound(total)
        periodic = calls[0][3][5].is_periodic
        kind = kernel_kind(calls[0][3][6])
        resources = iisph_check.resources(lib, kind, periodic)
        sets = {name: dict(ms=times[name], plain_ms=plain[name],
                           bound_ms=roofline.bound(w)[0],
                           bound_by=roofline.bound(w)[1],
                           share=roofline.bound(w)[0] / times[name],
                           calls=sum(_iisph_set(c) == name for c in calls),
                           pairs=w['pairs'], flops=w['flops'],
                           bytes=w['bytes'])
                for name, w in work.items()}
        print('iisph_pair, the %d launches of one evaluation of %s (grid %s, '
              'periodic %s, kernel kind %d), the pressure group as the '
              'per-launch chain, graph replays alternated in this process: '
              'as the chain runs them (linked: one emits, %d read its list) '
              '%.4f ms, walking %.4f ms; eager %.3f ms; plain torch %.3f ms; '
              'bound %.4f ms (%s: %.4g flops, %d candidates, %d pairs, %d '
              'B), share %.1f%%; by phase set: %s; the library\'s kernels '
              'of this kind, registers and spill bytes (stores, loads) by '
              'mode: %s' % (
                  len(calls), what, calls[0][3][5].dims, periodic, kind,
                  linked['consumers'], times['path'], times['walking'],
                  eager, sum(plain.values()), bound_ms, bound_by,
                  total['flops'], total['candidates'], total['pairs'],
                  total['bytes'], 100 * bound_ms / times['path'], '; '.join(
                      '%s (%d calls) %.4f ms, plain %.3f, bound %.4f (%s), '
                      'share %.1f%%' % (k, v['calls'], v['ms'], v['plain_ms'],
                                        v['bound_ms'], v['bound_by'],
                                        100 * v['share'])
                      for k, v in sets.items()), resources), flush=True)
        del calls
        # the path now: 4 (6) pair calls and the solve
        calls, _, _, solve_sweeps = iisph_check.calls(
            run.run, run.full, torch.float32, solve=True)
        solve_call, = iisph_check.solve_calls(calls)
        checked = iisph_check.check_solve(solve_call, 'iisph_solve ' + what,
                                          TOL[torch.float32])
        solve_err = max(row.get('max_abs_err', 0.0)
                        for row in checked.values())
        st = _solve_times(calls)
        solve_work = roofline.iisph_solve_work(*solve_call[3],
                                               sweeps=solve_sweeps)
        pair_work = roofline.add(*[
            roofline.iisph_work(*c[3], walks=c[2] is c[2].link.emitter
                                if c[2].link is not None else True)
            for c in iisph_check.pair_calls(calls)])
        eval_bound = roofline.bound(roofline.add(pair_work, solve_work))[0]
        solve_bound, solve_by = roofline.bound(solve_work)
        chain_ms = sets['dijpj']['ms'] + sets['pressure sweep']['ms']
        print('iisph_solve, %s: %d sweeps; one evaluation as the path runs '
              'it (%d iisph_pair launches, linked, and the solve) %.4f ms '
              '(the chain above %.4f), bound %.4f ms; the solve alone %.4f '
              'ms (%.4f a sweep), eager %.4f, plain torch %.3f; the chain\'s '
              'dijpj and pressure sweep sets %.4f ms; bound %.4f ms (%s: '
              '%.4g flops, %d pairs, %d B), share %.1f%%; registers and '
              'spill bytes (stores, loads): %s' % (
                  what, solve_sweeps, len(calls) - 1, st['eval'],
                  times['path'], eval_bound, st['solve'],
                  st['solve'] / max(solve_sweeps, 1), st['solve_eager'],
                  st['plain'], chain_ms, solve_bound, solve_by,
                  solve_work['flops'], solve_work['pairs'],
                  solve_work['bytes'], 100 * solve_bound / st['solve'],
                  solve_res), flush=True)
        del calls
        runs[run.label] = drive = _iisph_drive(run)
        gate = _iisph_gate(run)
        suffix = '' if run.run == 'taylor_green' else ' ' + run.run
        kernels['iisph_pair' + suffix] = dict(_entry(
            'iisph_pair', 'pysph_tpu/ops/resident.py:645',
            drive['launches']['iisph_pair'], err, times['path'],
            sum(plain.values()), total, None, eager_ms=eager,
            walking_ms=times['walking'], share=bound_ms / times['path'],
            sets=sets, sweeps=sweeps, overflowed=linked['overflowed'],
            max_count=linked['max_count'], capacity=linked['capacity'],
            resources=resources, run=drive, gate=gate,
            path='%s, one evaluation as the per-launch chain (%d sweeps: %d '
            'launches, linked)' % (run.label, sweeps,
                                   run.fixed + 2 * sweeps)),
            name='iisph_pair' + suffix)
        kernels['iisph_solve' + suffix] = dict(_entry(
            'iisph_solve', 'pysph_tpu/ops/resident.py:645',
            drive['launches']['iisph_solve'], solve_err, st['solve'],
            st['plain'], solve_work, None, eager_ms=st['solve_eager'],
            eval_ms=st['eval'], chain_ms=chain_ms, checked=checked,
            sweeps=solve_sweeps, share=solve_bound / st['solve'],
            resources=solve_res, path='%s, the pressure group of one '
            'evaluation (%d sweeps, one launch)' % (run.label, solve_sweeps)),
            name='iisph_solve' + suffix)
    return runs


def _gasd_gate(run, size, dtype, steps=0):
    """``run`` (``gasd_check.RUNS``) at ``size`` from the example's own
    start, on the kernels, to its tf or for ``steps`` steps; returns
    (solver, its fluid state in float64 on the host, the launches of
    gasd_pair, packs, seconds)."""
    app = gasd_check.app(run, size, dtype, steps=steps)
    s = app.solver
    gd.gasd_pair.launches = gd.gasd_sweep.launches = 0
    cell_pack.pack.launches = 0
    start = time.perf_counter()
    app.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    st = {p: v.double().cpu().numpy() for p, v in s.states['fluid'].items()
          if v.is_floating_point()}
    launches = gd.gasd_pair.launches + gd.gasd_sweep.launches
    if not (gd.gasd_pair.launches and gd.gasd_sweep.launches):
        raise AssertionError('%s %d: gasd_pair %d, gasd_sweep %d launches'
                             % (run, size, gd.gasd_pair.launches,
                                gd.gasd_sweep.launches))
    return s, st, launches, cell_pack.pack.launches, secs


def _gasd_drive(label, size, steps, chunk_steps):
    """The Sedov blast at ``size`` in float32 for ``steps`` steps from the
    example's start with the CFL dt (``gasd_check.FULL_WIDTH``), in
    chunks of ``chunk_steps`` (1: per step), timed
    (``time_chunks.timed_solve``: per step the host clock at each step's
    start, the card synchronised; in chunks after each chunk's read, over
    the chunks replaying a graph captured before them; from step 20 on):
    ``gasd_pair``'s, ``gasd_sweep``'s, the pack's and the binning's
    launches set to 0 just before and read just after (each must have
    launched); after the initial evaluation (250 sweeps: its h0 is 0, so
    that no particle's h converges), kept apart: a step's sweeps (min,
    mean, max), host reads (the solver's and ``converged``'s), binnings
    (the integrator's reuse test and the sweeps' own, on the device), the
    slots, redos and captures; the hmax/hmin and candidates a dest at the
    end, the drift in total energy, and a step's device time by layer and
    idle share (per step: one step's ``torch.profiler`` trace; in chunks:
    one replay of the chunk's graph, a tenth of it).  Returns the row, the
    final state (float32 tensors on the card) and the run's grid."""
    app = gasd_check.app('sedov', size, torch.float32, steps=steps,
                         extra=gasd_check.FULL_WIDTH)
    s = app.solver
    a_eval, = s.acceleration_evals
    st = s.states['fluid']
    e0 = sedov.figures(*[st[p].double().cpu().numpy() for p in (
        'x', 'y', 'u', 'v', 'rho', 'm', 'e')])['energy']
    start = {}

    def counts():
        ig = s.integrator
        return dict(gasd_pair=gd.gasd_pair.launches,
                    gasd_sweep=gd.gasd_sweep.launches,
                    cell_pack=cell_pack.pack.launches,
                    bin_cells=bc.bin_cells.launches,
                    converged_reads=a_eval.converged_reads, reads=s.reads,
                    binnings=float(ig.rebuilds) + float(a_eval.rebuilds),
                    sweep_binnings=float(a_eval.rebuilds))

    initial = s.integrator.initial_acceleration

    def initial_acceleration(*args):
        out = initial(*args)
        start.update(counts())
        return out

    s.integrator.initial_acceleration = initial_acceleration
    dev = st['x'].device
    pl.reset_overflow('gasd_pair', dev)
    gd.gasd_pair.launches = gd.gasd_sweep.launches = 0
    cell_pack.pack.launches = bc.bin_cells.launches = 0
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ms, samples = time_chunks.timed_solve(app, chunk_steps)
    end = counts()
    launches = {k: end[k] for k in ('gasd_pair', 'gasd_sweep', 'cell_pack',
                                    'bin_cells')}
    per_step = {k: (end[k] - start[k]) / s.count for k in end}
    if not (launches['gasd_pair'] and launches['gasd_sweep'] and
            launches['bin_cells'] and launches['cell_pack'] ==
            launches['gasd_pair'] + launches['gasd_sweep']):
        raise AssertionError('%s did not run through gasd_pair, gasd_sweep, '
                             'the pack and the binning: %s' % (label,
                                                               launches))
    sweeps = list(a_eval.sweeps)
    n = st['x'].shape[0]
    # the dests past the list's entries: in every sweep that ran (on the
    # card, graph replays too), and in the last one
    past = pl.overflowed('gasd_pair', dev)
    plans = a_eval.sweep_plans()
    last = plans[0].buffers.count
    past_last = int((last > plans[0].buffers.nbr.shape[0]).sum())
    st = s.states['fluid']
    hmax_hmin = float(st['h'].max() / st['h'].min())
    final = {p: v.clone() for p, v in st.items()}
    fin = {p: st[p].double().cpu().numpy() for p in (
        'x', 'y', 'u', 'v', 'rho', 'm', 'e', 'h')}
    figs = sedov.figures(*[fin[p] for p in ('x', 'y', 'u', 'v', 'rho', 'm',
                                            'e')])
    cells = s.grid.bin_all(s.states)['fluid']
    candidates = roofline.stencil(s.grid, cells, cells)[0]
    finite = all(bool(torch.isfinite(v).all()) for v in st.values()
                 if v.is_floating_point())
    steps_run = s.count
    # after the counts: the state moves on
    if chunk_steps > 1:
        trace = prof_chunk.replay_gaps(s._graph)
        per = chunk_steps
    else:
        trace = prof_chunk.trace_gaps(
            lambda: s.integrator.step(s.states, s.t, s.dt))
        per = 1
    layers = {}
    for name, us in trace['busy'].items():
        key = ('gasd_pair density' if 'gasd_pair' in name and 'Density'
               in name else 'gasd_pair momentum' if 'gasd_pair' in name
               else 'pack' if 'pack' in name else 'binning'
               if 'bin::' in name else 'elementwise and copies')
        layers[key] = layers.get(key, 0.0) + us / 1e3 / per
    busy = (trace['span_us'] - trace['idle_us']) / 1e3 / per
    row = dict(ms=ms, samples=len(samples), steps=steps_run, t=s.t,
               chunk_steps=chunk_steps, particles=n, launches=launches,
               initial=start, per_step=per_step,
               launches_per_step=per_step['gasd_pair'] +
               per_step['gasd_sweep'],
               evals=len(sweeps), sweeps_initial=sweeps[0],
               sweeps_steps=(min(sweeps[1:]), float(np.mean(sweeps[1:])),
                             max(sweeps[1:])),
               reads_per_step=per_step['converged_reads'] +
               per_step['reads'],
               binnings_per_step=per_step['binnings'],
               sweep_binnings_per_step=per_step['sweep_binnings'],
               slots=[p.slots for p in plans], redos=s.redos,
               past_sweeps=past / max(sum(sweeps), 1), past_last=past_last,
               most_pairs=int(last.max()),
               captures=s.captures, replays=s.replays,
               hmax_hmin=hmax_hmin, candidates_per_dest=candidates / n,
               energy_drift=figs['energy'] / e0 - 1.0, figures=figs,
               grows=s.grid.grows, dims=s.grid.dims,
               peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
               step_span_ms=trace['span_us'] / 1e3 / per, step_busy_ms=busy,
               idle_share=trace['idle_us'] / trace['span_us'],
               step_ops=trace['ops'] / per, layers=layers,
               gaps=trace['gaps'])
    how = 'in chunks of %d' % chunk_steps if chunk_steps > 1 else \
        'per step'
    print('%s float32, %s (the CFL dt): %d steps to t=%.6g, median %.4f '
          'ms/step (min %.4f, max %.4f over %d samples from step %d); '
          'launches in the run %s; the initial evaluation %d sweeps; a '
          'step, the steps alone: sweeps %d / %.3f / %d (min / mean / max), '
          'launches %.3f (gasd_sweep and gasd_pair), host reads %.3f '
          '(converged %.3f, the solver\'s %.3f), binnings %.3f (in the '
          'sweeps %.3f); slots %s, redos %d, captures %d, replays %d; '
          'dests past the list\'s entries %.1f a sweep, %d in the last '
          '(the most pairs %d); '
          'largest hmax/hmin %.4f; %.1f stencil candidates a dest at the '
          'end (grid %s, %d grows); total energy drift %.3g; figures %s; '
          'peak device memory %.1f MiB; finite %s' % (
              label, how, steps_run, s.t, ms, min(samples), max(samples),
              len(samples), time_chunks.WARMUP, launches, sweeps[0],
              *row['sweeps_steps'], row['launches_per_step'],
              row['reads_per_step'], per_step['converged_reads'],
              per_step['reads'], row['binnings_per_step'],
              row['sweep_binnings_per_step'], row['slots'], s.redos,
              s.captures, s.replays, row['past_sweeps'], past_last,
              row['most_pairs'], hmax_hmin, row['candidates_per_dest'],
              s.grid.dims, s.grid.grows, row['energy_drift'], figs,
              row['peak_mib'], finite), flush=True)
    print('%s %s: a step\'s trace (%s): %.4f ms from its first device '
          'operation to its last, busy %.4f ms (%.0f operations), idle '
          'share %.1f%%; device ms by layer %s; longest gaps %s' % (
              label, how, 'one replay of the chunk, a tenth' if per > 1
              else 'one step', row['step_span_ms'], busy, row['step_ops'],
              100 * row['idle_share'], {k: round(v, 4) for k, v in
                                        layers.items()}, trace['gaps']),
          flush=True)
    if not finite or steps_run != steps or \
            set(a_eval.engine_choices.values()) != {'kernel'}:
        raise AssertionError('%s did not run every pair phase on gasd_pair '
                             'or ended non-finite' % label)
    if chunk_steps > 1 and not (s.replays and plans and
                                row['reads_per_step'] <= 0.2):
        raise AssertionError('%s did not run its sweeps in chunks on the '
                             'card: %s' % (label, row))
    return row, final, s.grid


def _gasd_chunk_gate():
    """20 steps of Sedov nx=401 in float32 (``gasd_check.FULL_WIDTH``)
    under ``mpm`` and ``--adaptive-h gsph`` in chunks of 10 replayed from
    CUDA graphs against the per-step loop: every prop equal bit for bit,
    t, dt and the count too."""
    out = {}
    for scheme in ('mpm', 'gsph'):
        got = {}
        for k in (10, 1):
            app = gasd_check.app('sedov', 401, torch.float32, steps=20,
                                 extra=gasd_check.FULL_WIDTH +
                                 ('--adaptive-h', scheme))
            s = app.solver
            s.chunk_steps = k
            app.solve()
            got[k] = s
        a, b = got[10], got[1]
        differ = [p for p, v in b.states['fluid'].items()
                  if not torch.equal(v, a.states['fluid'][p])]
        out[scheme] = dict(steps=a.count, replays=a.replays,
                           captures=a.captures, redos=a.redos,
                           reads=(a.reads, b.reads), differ=differ)
        print('gas chunk gate: sedov nx=401 float32 --adaptive-h %s, 20 '
              'steps in chunks of 10 (%d captures, %d replays, %d redos, %d '
              'reads) against per step (%d reads): props that differ %s; '
              't %s, dt %s, count %s equal' % (
                  scheme, a.captures, a.replays, a.redos, a.reads, b.reads,
                  differ, a.t == b.t, a.dt == b.dt, a.count == b.count),
              flush=True)
        if differ or not (a.t == b.t and a.dt == b.dt and a.count ==
                          b.count == 20 and a.replays):
            raise AssertionError('sedov --adaptive-h %s: the chunks differ '
                                 'from the per-step loop' % scheme)
    return out


#: seconds a guarded binning (``_bin_guard_phase``) may take
BIN_GUARD_SECONDS = 10.0


def _bin_guard_phase(sedov_state):
    """The binning's guards on the card, each within
    ``BIN_GUARD_SECONDS``: 160,801 particles crowded into one cell, and
    onto the clamped edges of a grid of 4 x 4 cells, binned with
    ``order`` equal to ``torch.sort(cid, stable=True)``'s, timed against
    that sort; Sedov nx=401's state with one x made NaN binned: nothing
    binned, the grid's flag set, ``check_finite`` raising; and a chunked
    Sedov nx=101 run whose h is made NaN raising ``FloatingPointError``
    at its first read, and one whose h is made NaN after a first chunk
    raising at the next chunk's read with no redo.  Returns the times."""
    out = {}
    rng = np.random.default_rng(4)
    n = 160801
    for label, spread, dims in (('one cell', 1e-3, None),
                                ('clamped edges', 400.0, (4, 4, 1))):
        pa = get_particle_array_gasd(name='fluid', x=rng.uniform(0, spread, n),
                                     y=rng.uniform(0, spread, n), h=1.0,
                                     m=1.0)
        grid = CellGrid.from_particles([pa], dim=2, radius_scale=3.0)
        if dims is not None:
            grid._set_dims(dims)
        states = {'fluid': pa.to_device(Config(device='cuda',
                                               dtype=torch.float32))}
        handle = grid.handle_for(None, states)
        torch.cuda.synchronize()
        t = time.perf_counter()
        bc.bin_cells(grid, states, handle, force=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        cid = handle.lists['fluid'].cell.long()
        largest = int(torch.bincount(cid, minlength=grid.ncells).max())
        stable = torch.equal(handle.lists['fluid'].order.long(),
                             torch.sort(cid, stable=True).indices)
        ms = graph_ms(lambda: bc.bin_cells(grid, states, handle, force=True),
                      5)
        sort_ms = events_ms(lambda: torch.sort(cid, stable=True), 5)
        calls = bin_check.check(grid, states, label=label)
        out[label] = dict(seconds=secs, ms=ms, sort_ms=sort_ms,
                          largest=largest)
        print('bin_cells, %d particles %s (grid %s, the largest cell %d): '
              'order equal to torch.sort(cid, stable=True) %s, exactly the '
              'plain version in %d calls; first call %.4f s, rebuilt %.4f '
              'ms in a graph, torch.sort stable %.4f ms' % (
                  n, label, grid.dims, largest, stable, calls, secs, ms,
                  sort_ms), flush=True)
        if not (stable and secs < BIN_GUARD_SECONDS and largest >= n // 10):
            raise AssertionError('bin_cells on %s' % label)
    grid, states = sedov_state
    handle = grid.handle_for(None, states)
    bc.bin_cells(grid, states, handle, force=True)
    kept = [t.clone() for t in handle.lists['fluid']]
    st = dict(states['fluid'])
    st['x'] = st['x'].clone()
    st['x'][12345] = float('nan')
    torch.cuda.synchronize()
    t = time.perf_counter()
    flag = bc.bin_cells(grid, {'fluid': st}, handle, force=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(kept, handle.lists['fluid']))
    try:
        grid.check_finite()
        raised = False
    except FloatingPointError:
        raised = True
    print('bin_cells, Sedov nx=401 with one x NaN: binned in %.4f s, flag '
          '%s, the lists unchanged %s, FloatingPointError raised %s' % (
              secs, bool(flag), unchanged, raised), flush=True)
    if bool(flag) or not (unchanged and raised and
                          secs < BIN_GUARD_SECONDS):
        raise AssertionError('bin_cells on a NaN state')
    app = gasd_check.app('sedov', 101, torch.float32, steps=30,
                         extra=gasd_check.FULL_WIDTH)
    s = app.solver
    s.states['fluid']['h'][77] = float('nan')
    t = time.perf_counter()
    try:
        app.solve()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    secs = time.perf_counter() - t
    print('sedov nx=101 float32 in chunks with one h NaN: %s after %.2f s '
          '(%d steps, %d reads)' % (raised, secs, s.count, s.reads),
          flush=True)
    if raised is None or secs > BIN_GUARD_SECONDS:
        raise AssertionError('a NaN h did not raise at the solver\'s read')
    out['nan'] = dict(seconds=secs, steps=s.count)
    # the NaN after a first chunk, at the example's fixed dt (no per-step
    # read first): the next chunk's sweeps never converge, and its read
    # raises before any redo with more slots
    app = gasd_check.app('sedov', 101, torch.float32, steps=10)
    s = app.solver
    app.solve()
    done, replays, redos = s.count, s.replays, s.redos
    s.max_steps = 30
    s.states['fluid']['h'][77] = float('nan')
    t = time.perf_counter()
    try:
        s.solve()
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    secs = time.perf_counter() - t
    print('sedov nx=101 float32 in chunks with one h NaN after a first '
          'chunk of %d steps: %s after %.2f s (%d steps, %d redos, %d '
          'replays)' % (done, raised, secs, s.count, s.redos - redos,
                        s.replays - replays), flush=True)
    if raised is None or s.redos != redos or s.count != done or \
            secs > BIN_GUARD_SECONDS:
        raise AssertionError('a NaN h after a chunk did not raise at the '
                             'next chunk\'s read with no redo')
    out['nan_later'] = dict(seconds=secs, steps=s.count)
    return out


def _gasd_phase(kernels):
    """``GasDScheme``'s two runs on ``gasd_pair``: both sets against their
    plain version (``gasd_check.check``: each output within TOL of
    max|ref|, the pairs and every dest's pair count equal) on the
    jittered Sedov lattice at nx=41 and the shock tube at nl=80 (h jumping
    by 8 at the diaphragm) in float64 and float32, and at the Sedov
    blast's full width, nx=401 in float32 after 50 steps (h varies); GHI
    against ``Gaussian.gradient_h`` in 1D and 2D; every other kernel with
    a shape function in both dtypes (``gasd_check.kinds``: the Sedov
    lattice at nx=21, the 1D splines on the shock tube at nl=40); timed
    there (with the bound of the pairs alone beside the bound) (each set
    alone, the two in a graph and eager, the plain version) with the
    library's registers and spills; the shock tube at nl=320 in float64
    to tf, its L1 errors against the exact solution within CAVITY_TOL of
    the JAX package's (``JAX_SHOCKTUBE``); the Sedov blast at nx=41 in
    float32 for 200 steps, its figures within CAVITY_TOL of
    ``JAX_SEDOV``; and the blast at nx=401 for ``STEPS`` steps per step
    (``_gasd_drive``).  Adds the entry ``gasd_pair``."""
    lib = build.build('gasd_pair')
    resources = gasd_check.resources(lib)
    for dtype in (torch.float64, torch.float32):
        for run, size in (('sedov', 41), ('shocktube', 80)):
            calls, n, _ = gasd_check.calls(run, size, dtype)
            found = gasd_check.check(calls, '%s %s' % (run, dtype),
                                     TOL[dtype])
            print('compare gasd_pair %s %d %s (%d particles, jittered, both '
                  'sets): max abs err %.3g, max scaled err %.3g (tol %.0e); '
                  '%d pairs, 0 dests whose count differs' % (
                      run, size, str(dtype)[6:], n, found['max_abs_err'],
                      found['max_scaled_err'], TOL[dtype], found['pairs']),
                  flush=True)
        for dim in (1, 2):
            err = gasd_check.gradient_h(dim, dtype)
            print('gasd_pair GHI %dD %s against Gaussian.gradient_h: scaled '
                  'error %.3g' % (dim, str(dtype)[6:], err), flush=True)
            if not err <= (1e-13 if dtype == torch.float64 else 1e-5):
                raise AssertionError('gasd_pair GHI %dD' % dim)
        for label, f in gasd_check.kinds(dtype, TOL[dtype]).items():
            print('compare gasd_pair %s (kind %d, jittered, both sets): max '
                  'abs err %.3g, max scaled err %.3g; %d pairs, 0 dests '
                  'whose count differs' % (label, f['kind'], f['max_abs_err'],
                                           f['max_scaled_err'], f['pairs']),
                  flush=True)
    calls, n, app = gasd_check.calls('sedov', 401, torch.float32, steps=50,
                                     jitter_start=False,
                                     extra=gasd_check.FULL_WIDTH)
    st = app.solver.states['fluid']
    hmax_hmin = float(st['h'].max() / st['h'].min())
    what = 'sedov nx=401 float32 after 50 steps (%d particles, hmax/hmin ' \
        '%.4f)' % (n, hmax_hmin)
    found = gasd_check.check(calls, what, TOL[torch.float32])
    print('compare gasd_pair %s: max abs err %.3g, max scaled err %.3g; %d '
          'pairs, 0 dests whose count differs' % (
              what, found['max_abs_err'], found['max_scaled_err'],
              found['pairs']), flush=True)
    for _, dest, _, args in calls:
        _check_pack('sedov nx=401 ' + dest, gd.pack_sources(args[4]),
                    gd.pack_sources_reference(args[4]))
    sets = {}
    for name, call in zip(('density', 'momentum'), calls):
        args = call[3]
        w = roofline.gasd_work(*args)
        ms = graph_ms(lambda: gd.gasd_pair(*args), 20)
        plain = events_ms(lambda: tvf_check.reference(call[2], args), 3)
        sets[name] = dict(ms=ms, eager_ms=events_ms(
            lambda: gd.gasd_pair(*args), 20), plain_ms=plain,
            bound_ms=roofline.bound(w)[0], bound_by=roofline.bound(w)[1],
            pair_bound_ms=roofline.bound(dict(w, flops=w['pair_flops']))[0],
            candidates=w['candidates'], pairs=w['pairs'], flops=w['flops'],
            pair_flops=w['pair_flops'], bytes=w['bytes'])
    both = graph_ms(lambda: [gd.gasd_pair(*c[3]) for c in calls], 20)
    eager = events_ms(lambda: [gd.gasd_pair(*c[3]) for c in calls], 20)
    plain = sum(v['plain_ms'] for v in sets.values())
    work = _calls_work(calls, roofline.gasd_work)
    bound_ms, bound_by = roofline.bound(work)
    pair_bound_ms = roofline.bound(dict(work, flops=work['pair_flops']))[0]
    print('gasd_pair, %s, in a graph: a density launch %.4f ms (eager %.4f, '
          'plain %.3f; bound %.4f ms, %s; of the pairs alone %.4f ms) and '
          'the momentum launch %.4f ms (eager %.4f, plain %.3f; bound %.4f '
          'ms, %s; of the pairs alone %.4f ms); the two %.4f ms, eager '
          '%.4f; bound %.4f ms (%s: %.4g flops, %d candidates, %d pairs, %d '
          'B), share %.1f%%; of the pairs alone (%.4g flops, no support '
          'tests of the candidates) %.4f ms, share %.1f%%; %.1f candidates '
          'and %.1f pairs a dest; registers and spill bytes (stores, '
          'loads) at kind 2: %s' % (
              what, sets['density']['ms'], sets['density']['eager_ms'],
              sets['density']['plain_ms'], sets['density']['bound_ms'],
              sets['density']['bound_by'], sets['density']['pair_bound_ms'],
              sets['momentum']['ms'], sets['momentum']['eager_ms'],
              sets['momentum']['plain_ms'], sets['momentum']['bound_ms'],
              sets['momentum']['bound_by'],
              sets['momentum']['pair_bound_ms'], both, eager, bound_ms,
              bound_by, work['flops'], work['candidates'], work['pairs'],
              work['bytes'], 100 * bound_ms / both, work['pair_flops'],
              pair_bound_ms, 100 * pair_bound_ms / both,
              work['candidates'] / 2 / n, work['pairs'] / 2 / n, resources),
          flush=True)
    err = found['max_abs_err']
    del calls, app, st
    # the shock tube against the exact solution and the JAX package's
    s, st, launches, packs, secs = _gasd_gate('shocktube', 320,
                                              torch.float64)
    l1 = shocktube.l1_errors(st['x'], st['rho'], st['p'], st['u'], s.t)
    errs = {k: l1[k] / JAX_SHOCKTUBE[k] - 1.0 for k in l1}
    sweeps = s.acceleration_evals[0].sweeps
    print('shocktube nl=320 float64 at t=%.8g after %d steps (%.1f s; %d '
          'gasd_pair launches, %d packs; sweeps min %d / mean %.3f / max %d; '
          'hmax/hmin %.4f): L1 errors against the exact solution %s; the '
          'JAX package\'s %s; relative %s; bar %.0e' % (
              s.t, s.count, secs, launches, packs, min(sweeps),
              float(np.mean(sweeps)), max(sweeps),
              st['h'].max() / st['h'].min(), l1, JAX_SHOCKTUBE, errs,
              CAVITY_TOL), flush=True)
    if not (abs(s.t - 0.15) < 1e-9 and launches and packs == launches and
            max(abs(e) for e in errs.values()) <= CAVITY_TOL):
        raise AssertionError('the shock tube missed the JAX package\'s L1 '
                             'errors')
    tube = dict(t=s.t, steps=s.count, l1=l1, jax=JAX_SHOCKTUBE,
                rel_err=errs, launches=launches, seconds=secs)
    # the Sedov blast at nx=41 against the JAX package's figures
    s, st, launches, packs, secs = _gasd_gate('sedov', 41, torch.float32,
                                              steps=STEPS)
    figs = sedov.figures(*[st[p] for p in ('x', 'y', 'u', 'v', 'rho', 'm',
                                           'e')])
    errs = {k: figs[k] / JAX_SEDOV[k] - 1.0 for k in figs}
    print('sedov nx=41 float32 at t=%.6g after %d steps (%.1f s; %d '
          'gasd_pair launches, %d packs; hmax/hmin %.4f): %s; the JAX '
          'package\'s %s; relative %s; bar %.0e' % (
              s.t, s.count, secs, launches, packs,
              st['h'].max() / st['h'].min(), figs, JAX_SEDOV, errs,
              CAVITY_TOL), flush=True)
    if not (s.count == STEPS and launches and packs == launches and
            max(abs(e) for e in errs.values()) <= CAVITY_TOL):
        raise AssertionError('the Sedov blast missed the JAX package\'s '
                             'figures')
    blast = dict(t=s.t, steps=s.count, figures=figs, jax=JAX_SEDOV,
                 rel_err=errs, launches=launches, seconds=secs)
    del s, st
    sweep = _gasd_sweep_checks()
    gate = _gasd_chunk_gate()
    drive, final, sedov_grid = _gasd_drive('sedov nx=401', 401, STEPS, 10)
    per_step, stepped, _ = _gasd_drive('sedov nx=401', 401, STEPS, 1)
    differ = [p for p, v in stepped.items() if not torch.equal(v, final[p])]
    print('sedov nx=401 float32, %d steps in chunks against per step: props '
          'that differ %s' % (STEPS, differ), flush=True)
    if differ:
        raise AssertionError('sedov nx=401: the chunks differ from the '
                             'per-step loop in %s' % differ)
    del stepped
    states = {'fluid': final}
    guard = _bin_guard_phase((sedov_grid, states))
    sedov_bins = bin_check.times(sedov_grid, states)
    cid = sedov_grid.bin_all(states)['fluid'].cell.long()
    sedov_bins['sort_ms'] = events_ms(lambda: torch.sort(cid, stable=True),
                                      20)
    print('bin_cells, Sedov nx=401 float32 after %d steps in chunks (%d '
          'cells): kept %.4f ms, rebuilt %.4f ms in a graph (by kernel %s), '
          'plain %.3f ms; torch.sort(cid, stable=True) on its cell ids '
          '%.4f ms' % (
              STEPS, sedov_grid.ncells, sedov_bins['kept_ms'],
              sedov_bins['rebuilt_ms'], {
                  k.split('(')[0].split(' ')[-1]: round(v, 4)
                  for k, v in sedov_bins['rebuilt_kernels'].items()},
              sedov_bins['plain_ms'], sedov_bins['sort_ms']), flush=True)
    kernels['gasd_pair'] = dict(_entry(
        'gasd_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
        drive['launches']['gasd_pair'], err, both, plain, work, None,
        eager_ms=eager, share=bound_ms / both, pair_bound_ms=pair_bound_ms,
        sets=sets, linked_ms=sweep['times']['linked_ms'],
        linked_walk_ms=sweep['times']['walk_ms'],
        linked_bound_ms=roofline.bound(sweep['times']['linked_work'])[0],
        overflowed_dests=sweep['times']['overflowed'],
        resources=resources, hmax_hmin=hmax_hmin, run=drive,
        per_step_run=per_step, chunk_gate=gate,
        shocktube=tube, sedov_nx41=blast,
        path='sedov nx=401 after 50 steps, one density launch and the '
        'momentum launch, walking; linked_ms: the momentum launch on the '
        'last sweep\'s list'))
    t = sweep['times']
    kernels['gasd_sweep'] = dict(_entry(
        'gasd_sweep', 'pysph_tpu/ops/pallas_engine.py:1160',
        drive['launches']['gasd_sweep'], sweep['max_abs_err'], t['ms'],
        t['plain_ms'], t['work'], None, eager_ms=t['eager_ms'],
        checks=sweep['checks'], guard=guard,
        path='sedov nx=401 after 50 steps, one gated density sweep (the '
        'pack, initialize, the sums, post_loop, the count, the list)'),
        source='pysph_tpu_torch/csrc/gasd_pair.cu')
    return drive, per_step, sedov_bins


def _gasd_sweep_checks():
    """``gasd_sweep`` against its plain version (``gasd_check.
    check_sweep``: every sweep of an iteration from a state whose h moved
    by up to 5%, the list against ``neighbours_reference``, the linked
    momentum launch bit for bit the walk) on the Sedov lattice at nx=41
    and the shock tube at nl=80 in both dtypes, with a list of one entry
    (every warp walks), and at Sedov nx=401 in float32 after 50 steps,
    where it is timed (``gasd_check.sweep_times``)."""
    found, worst = [], 0.0
    cases = [(run, size, dtype, 0, None) for dtype in (torch.float64,
                                                      torch.float32)
             for run, size in (('sedov', 41), ('shocktube', 80))]
    cases.append(('sedov', 41, torch.float64, 0, 1))
    for run, size, dtype, steps, cap in cases:
        s = gasd_check.sweep_start(run, size, dtype, steps=steps)
        label = '%s %d %s%s' % (run, size, str(dtype)[6:],
                                '' if cap is None else ', list of %d' % cap)
        f = gasd_check.check_sweep(s, label, TOL[dtype], capacity=cap)
        found.append(dict(f, label=label))
        print('compare gasd_sweep %s (h moved by up to 5%%): %d sweeps (the '
              'kernel alone %d, the plain version alone %d), max abs err '
              '%.3g, max scaled err %.3g; %d converged flags apart; %d pairs '
              'listed, the list as neighbours_reference, %d dests past its '
              '%d entries (the most pairs %d); the momentum launch on it '
              'bit for bit the walk' % (
                  label, f['sweeps'], f['sweeps_kernel'], f['sweeps_plain'],
                  f['max_abs_err'], f['max_scaled_err'], f['flags_differ'],
                  f['pairs'], f['overflowed'], f['capacity'],
                  f['max_count']), flush=True)
    s = gasd_check.sweep_start('sedov', 401, torch.float32, steps=50,
                               jitter_start=False,
                               extra=gasd_check.FULL_WIDTH)
    label = 'sedov 401 float32 after 50 steps'
    f = gasd_check.check_sweep(s, label, TOL[torch.float32])
    found.append(dict(f, label=label))
    worst = f['max_abs_err']
    t = gasd_check.sweep_times(s)
    bound_ms, bound_by = roofline.bound(t['work'])
    lbound = roofline.bound(t['linked_work'])[0]
    print('compare gasd_sweep %s: %d sweeps (kernel %d, plain %d), max abs '
          'err %.3g, max scaled err %.3g; %d converged flags apart (steps '
          'within %.3g of htol of it); %d pairs listed, %d dests past the '
          '%d entries' % (
              label, f['sweeps'], f['sweeps_kernel'], f['sweeps_plain'],
              f['max_abs_err'], f['max_scaled_err'], f['flags_differ'],
              f.get('flip_off', 0.0), f['pairs'], f['overflowed'],
              f['capacity']), flush=True)
    print('gasd_sweep, %s: a gated sweep launch %.4f ms in a graph (eager '
          '%.4f, plain %.3f); bound %.4f ms (%s: %.4g flops, %d candidates, '
          '%d pairs, %d B), share %.1f%%; the momentum launch on the last '
          'sweep\'s list %.4f ms, walking %.4f (the list read where the '
          'iteration ended converged: %s); its bound %.4f ms, share %.1f%%; '
          '%d of %d dests past the list\'s 64 entries (the most pairs %d)'
          % (label, t['ms'], t['eager_ms'], t['plain_ms'], bound_ms,
             bound_by, t['work']['flops'], t['work']['candidates'],
             t['work']['pairs'], t['work']['bytes'], 100 * bound_ms / t['ms'],
             t['linked_ms'], t['walk_ms'], t['converged'], lbound,
             100 * lbound / t['linked_ms'], t['overflowed'], t['dests'],
             t['max_count']), flush=True)
    return dict(checks=found, times=t, max_abs_err=worst)



def _scheme_gate(run, size, scheme, steps=0):
    """``run`` (``gasd_check.RUNS``) under ``--scheme scheme`` at ``size``
    in float64 from the example's start, in chunks, to its tf or for
    ``steps`` steps: (solver, its fluid state in float64 on the host, the
    launches of gsph_pair and gasd_pair, seconds); every pair phase on a
    kernel, and a kernel of the scheme launched."""
    app = gasd_check.app(run, size, torch.float64, steps=steps,
                         extra=('--scheme', scheme))
    s = app.solver
    gs.gsph_pair.launches = gd.gasd_pair.launches = 0
    gd.gasd_sweep.launches = gd.gasd_pair.adke_launches = 0
    start = time.perf_counter()
    app.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    st = {p: v.double().cpu().numpy() for p, v in s.states['fluid'].items()
          if v.is_floating_point()}
    launches = dict(gsph_pair=gs.gsph_pair.launches,
                    gasd_pair=gd.gasd_pair.launches,
                    gasd_sweep=gd.gasd_sweep.launches,
                    adke_pair=gd.gasd_pair.adke_launches)
    ours = launches['gsph_pair'] if scheme == 'gsph' else \
        launches['adke_pair'] if scheme == 'adke' else launches['gasd_pair']
    if not ours or set(s.acceleration_evals[0].engine_choices.values()) \
            != {'kernel'}:
        raise AssertionError('%s %s %d: not every pair phase on a kernel '
                             '(%s)' % (run, scheme, size, launches))
    return s, st, launches, secs


def _gate_row(label, got, want, extra):
    errs = {k: got[k] / want[k] - 1.0 for k in want}
    print('%s: %s; the JAX package\'s %s; relative %s; bar %.0e; %s' % (
        label, got, want, errs, CAVITY_TOL, extra), flush=True)
    if not max(abs(e) for e in errs.values()) <= CAVITY_TOL:
        raise AssertionError('%s missed the JAX package\'s figures' % label)
    return dict(got=got, jax=want, rel_err=errs)


def _scheme_gates():
    """The new runs against the JAX package's figures: accuracy_test_2d
    (gsph, mpm, adke) at 64^2 to tf, hydrostatic_box (gsph, mpm, adke) at
    nx=50 for 200 steps, the shock tube (gsph, adke) at nl=320 to tf, all
    in float64 in chunks.  Returns the rows."""
    rows = {}
    for scheme in ('gsph', 'mpm', 'adke'):
        s, st, launches, secs = _scheme_gate('accuracy_test_2d', 64, scheme)
        l1 = accuracy_test_2d.l1_norm(st['x'], st['y'], st['rho'])
        rows['accuracy %s' % scheme] = _gate_row(
            'accuracy_test_2d --scheme %s --nparticles 64 float64 at t=%.8g '
            'after %d steps' % (scheme, s.t, s.count), dict(l1=l1),
            dict(l1=JAX_ACCURACY[scheme]),
            '%.1f s, launches %s' % (secs, launches))
    for scheme in ('gsph', 'mpm', 'adke'):
        s, st, launches, secs = _scheme_gate('hydrostatic_box', 50, scheme,
                                             steps=STEPS)
        figs = hydrostatic_box.figures(st['u'], st['v'], st['rho'],
                                       st['m'], 1.0 / 50)
        rows['hydrostatic %s' % scheme] = _gate_row(
            'hydrostatic_box --scheme %s --nx 50 float64 at t=%.8g after %d '
            'steps' % (scheme, s.t, s.count), figs, JAX_HYDROSTATIC[scheme],
            '%.1f s, launches %s' % (secs, launches))
    for scheme in ('gsph', 'adke'):
        s, st, launches, secs = _scheme_gate('shocktube', 320, scheme)
        l1 = shocktube.l1_errors(st['x'], st['rho'], st['p'], st['u'], s.t)
        if abs(s.t - 0.15) >= 1e-9:
            raise AssertionError('shocktube %s ended at t=%r' % (scheme,
                                                                   s.t))
        rows['shocktube %s' % scheme] = _gate_row(
            'shocktube --scheme %s --nl 320 float64 at t=%.8g after %d steps'
            % (scheme, s.t, s.count), l1, JAX_SHOCKTUBE_SCHEMES[scheme],
            '%.1f s, launches %s, hmax/hmin %.4f' % (
                secs, launches, st['h'].max() / st['h'].min()))
    return rows


def _scheme_checks():
    """Each new set against its plain version (``gasd_check.check``: every
    output within TOL of max|ref|, the pairs and each dest's count equal):
    on jittered small states (the accuracy test at 24^2 and the
    hydrostatic box at nx=20, periodic, and the shock tube at nl=80 with
    its free ends) in float64 and float32, and at full width (the
    accuracy test at 256^2) in float32; the acceleration under every
    entry of ``gasd_check.BRANCHES`` (every Riemann solver, limiter,
    interpolation, interface, the hybrid blend, the conduction) on the
    small states in both dtypes; the eleven device Riemann solvers
    against the torch ones on Toro's problems and 10^5 seeded states;
    ADKE's sets at the accuracy test's full width in float64 and at the
    shock tube's (nl=320) in float32, and at the accuracy test's full
    width in float32 against the plain version in float64
    (``_adke_full_check``).  Returns the largest abs errors (``gsph
    full`` and ``adke full``: of the full-width float32 calls that are
    timed) and those calls."""
    errs = {}
    for dtype in (torch.float64, torch.float32):
        found = gasd_check.riemann_check(dtype, n=100000)
        print('riemann %s (the device solvers of gsph_pair against '
              'riemann_solver.py, Toro\'s 4 problems and 10^5 seeded '
              'states): scaled error, NaNs apart by solver %s' % (
                  str(dtype)[6:], {k: (float('%.3g' % v[0]), v[1])
                                   for k, v in found.items()}), flush=True)
        for run, size in (('accuracy_test_2d', 24), ('hydrostatic_box', 20),
                          ('shocktube', 80)):
            for scheme in ('gsph', 'adke'):
                calls, n, _ = gasd_check.calls(run, size, dtype,
                                               extra=('--scheme', scheme))
                label = '%s %s %d %s' % (run, scheme, size, str(dtype)[6:])
                f = gasd_check.check(calls, label, TOL[dtype])
                errs[scheme] = max(errs.get(scheme, 0.0), f['max_abs_err'])
                print('compare %s (%d particles, jittered, %d calls): max '
                      'abs err %.3g, max scaled err %.3g (tol %.0e); %d pairs,'
                      ' 0 dests whose count differs' % (
                          label, n, len(calls), f['max_abs_err'],
                          f['max_scaled_err'], TOL[dtype], f['pairs']),
                      flush=True)
                if scheme != 'gsph' or run == 'hydrostatic_box':
                    continue
                worst = {}
                for blabel, call in gasd_check.branch_calls(calls).items():
                    f = gasd_check.check([call], label + ' ' + blabel,
                                         TOL[dtype])
                    worst[blabel] = float('%.3g' % f['max_scaled_err'])
                print('compare gsph_pair acceleration %s under every branch '
                      '(scaled errors; pairs and counts equal): %s' % (
                          label, worst), flush=True)
                _print_linked(gasd_check.check_gsph_linked(
                    calls, label, TOL[dtype]), label)
    full = {}
    # full width: the accuracy test in float32, ADKE's also in float64
    # and the shock tube's at its full width, nl=320, in float32
    for run, size, scheme, dtype in (
            ('accuracy_test_2d', ACCURACY_FULL, 'gsph', torch.float32),
            ('accuracy_test_2d', ACCURACY_FULL, 'adke', torch.float64),
            ('shocktube', 320, 'adke', torch.float32)):
        calls, n, _ = gasd_check.calls(run, size, dtype,
                                       extra=('--scheme', scheme))
        label = '%s %s %d %s' % (run, scheme, size, str(dtype)[6:])
        f = gasd_check.check(calls, label, TOL[dtype])
        print('compare %s (%d particles): max abs err %.3g, max scaled err '
              '%.3g (tol %.0e); %d pairs, 0 dests whose count differs' % (
                  label, n, f['max_abs_err'], f['max_scaled_err'],
                  TOL[dtype], f['pairs']), flush=True)
        if scheme == 'gsph':
            errs['gsph full'] = f['max_abs_err']
            full[scheme] = calls
            _print_linked(gasd_check.check_gsph_linked(
                calls, label, TOL[dtype]), label)
    errs['adke full'], full['adke'] = _adke_full_check()
    return errs, full


def _print_linked(found, label):
    print('compare gsph_pair linked %s: the gradients launch\'s list as '
          'neighbours_reference (%d dests, %d pairs, the most %d, capacity '
          '%d, %d past it); the acceleration on it bit for bit the walking '
          'launch; max abs err %.3g of the plain version' % (
              label, found['dests'], found['pairs'], found['max_count'],
              found['capacity'], found['overflowed'], found['max_abs_err']),
          flush=True)


def _adke_full_check():
    """ADKE's calls at the accuracy test's full width in float32, each
    output held to the plain version in float64 on the same inputs
    (``gasd_check.against_float64``: the kernel's error within 1e-4 of
    max|ref| or within ``gasd_check.F32_ROUNDING_FACTOR`` times the plain
    float32 version's own error against it).  Returns (the kernel's max
    abs err against its float32 plain version, the calls)."""
    calls, n, _ = gasd_check.calls('accuracy_test_2d', ACCURACY_FULL,
                                   torch.float32,
                                   extra=('--scheme', 'adke'))
    label = 'accuracy_test_2d adke %d float32' % ACCURACY_FULL
    err32, readings = 0.0, {}
    for _, dest, plan, args in calls:
        got = plan.op(*args)
        ref32 = tvf_check.reference(plan, args)
        ref64 = tvf_check.reference(plan, gasd_check.double(args))
        torch.cuda.synchronize()
        for p, r in gasd_check.against_float64(
                got, ref32, ref64, plan.outputs, label,
                TOL[torch.float32]).items():
            readings['%s %s' % (plan.op.__name__, p)] = r
            err32 = max(err32, float(
                (got[p].double() - ref32[p].double()).abs().max()))
    print('compare %s (%d particles) against the plain version in float64 '
          '(scaled errors of the kernel and of the plain float32 version, '
          'by output; held within %.0e or %g times the plain one\'s): %s; '
          'the kernel against the plain float32 version: max abs err %.3g'
          % (label, n, TOL[torch.float32], gasd_check.F32_ROUNDING_FACTOR,
             readings, err32), flush=True)
    return err32, calls


def _set_times(calls, op, terms_of, work_of):
    """{set: ms in a graph, eager, plain, work} of the calls of ``op``."""
    out = {}
    for call in calls:
        if call[2].op is not op:
            continue
        args = call[3]
        name = terms_of[call[2].sources[0].terms]
        w = work_of(*args)
        out[name] = dict(ms=graph_ms(lambda: op(*args), 20),
                         eager_ms=events_ms(lambda: op(*args), 20),
                         plain_ms=events_ms(
                             lambda: tvf_check.reference(call[2], args), 3),
                         bound_ms=roofline.bound(w)[0],
                         bound_by=roofline.bound(w)[1], work=w)
    return out


def _gsph_linked_times(calls):
    """GSPH's linked pair at full width (``calls``: one evaluation's, as
    ``gasd_check.calls`` records them), each in a CUDA graph: the
    emitting gradients launch, the acceleration on its hand-off, the pair
    as the path runs it, eagerly too, and the two walking launches; the
    work of the pair (the gradients' walk and the acceleration's pairs
    alone, ``roofline.gsph_linked_work``)."""
    (_, _, _, gargs), (_, _, _, aargs) = linked_calls(calls)[0]
    _, handoff = gs.gsph_pair(*gargs, emit=True)

    def pair():
        gs.gsph_pair(*aargs, handoff=gs.gsph_pair(*gargs, emit=True)[1])
    return dict(
        emit_ms=graph_ms(lambda: gs.gsph_pair(*gargs, emit=True), 20),
        consume_ms=graph_ms(lambda: gs.gsph_pair(*aargs, handoff=handoff),
                            20),
        linked_ms=graph_ms(pair, 20), eager_ms=events_ms(pair, 20),
        walking_ms=graph_ms(lambda: (gs.gsph_pair(*gargs),
                                     gs.gsph_pair(*aargs)), 20),
        work=roofline.add(roofline.gsph_work(*gargs),
                          roofline.gsph_linked_work(*aargs)))


#: the launches of one evaluation of GSPHScheme, in order
GSPH_LAUNCHES = ('scaled density', 'density', 'gradients', 'acceleration')


def _gsph_path_candidates():
    """The four pair launches of one evaluation of the accuracy test at
    full width in float32 after its first chunk (10 steps), as the path
    makes them (``gasd_check.path_calls``): each one's cells, candidates
    a pair in support on its binning's cells (the walk's) and on cells
    fitted to its h (``roofline``); the walk's at most
    ``MAX_CANDIDATES_A_PAIR`` and ``FITTED_SLACK`` times the fitted
    count.  Returns {launch: row}."""
    calls, _ = gasd_check.path_calls('accuracy_test_2d', ACCURACY_FULL,
                                     torch.float32, steps=10,
                                     extra=('--scheme', 'gsph'))
    rows = {}
    for name, (_, _, plan, args) in zip(GSPH_LAUNCHES, calls):
        count = roofline.gsph_work if plan.op is gs.gsph_pair else \
            roofline.gasd_work
        w = count(*args[:7])
        rows[name] = dict(kernel=plan.op.__name__, dims=args[5].dims,
                          hmax=float(args[0]['h'].max()),
                          candidates=w['candidates'],
                          walk_candidates=w['walk_candidates'],
                          pairs=w['pairs'], work=w)
    # the two density launches (gasd_pair) as the path makes them
    dens = [c for c in calls if c[2].op is gd.gasd_pair]
    dwork = roofline.add(*[rows[n]['work'] for n in GSPH_LAUNCHES[:2]])
    dbound = roofline.bound(dwork)
    dms = graph_ms(lambda: [c[2].op(*c[3]) for c in dens], 20)
    rows['density launches'] = dict(ms=dms, bound_ms=dbound[0],
                                    bound_by=dbound[1], work=dwork)
    print('accuracy_test_2d gsph %d float32, the two density launches '
          '(gasd_pair) of an evaluation after the first chunk: %.4f ms in a '
          'graph; bound %.4f ms (%s: %.4g flops, %d candidates, %d pairs, '
          '%d B), share %.1f%%' % (
              ACCURACY_FULL, dms, dbound[0], dbound[1], dwork['flops'],
              dwork['candidates'], dwork['pairs'], dwork['bytes'],
              100 * dbound[0] / dms), flush=True)
    print('accuracy_test_2d gsph %d float32, an evaluation after the first '
          'chunk, each launch on its binning\'s cells: %s' % (
              ACCURACY_FULL, {k: '%s %s hmax %.4g: %.2f candidates a pair '
                              '(%.2f on fitted cells)' % (
                                  r['kernel'], r['dims'][:2], r['hmax'],
                                  r['walk_candidates'] / r['pairs'],
                                  r['candidates'] / r['pairs'])
                              for k, r in rows.items() if k in GSPH_LAUNCHES
                              }), flush=True)
    for name in GSPH_LAUNCHES:
        r = rows[name]
        if not (r['walk_candidates'] <= FITTED_SLACK * r['candidates'] and
                r['walk_candidates'] <= MAX_CANDIDATES_A_PAIR * r['pairs']):
            raise AssertionError('accuracy gsph %s: %d candidates for %d '
                                 'pairs (%d on fitted cells)' % (
                                     name, r['walk_candidates'], r['pairs'],
                                     r['candidates']))
    return rows


#: the pair kernels of the accuracy test's path under each scheme
ACCURACY_KERNELS = {'gsph': (gs.gsph_pair, gd.gasd_pair),
                    'adke': (gd.gasd_pair, wp.wcsph_pair),
                    'crksph': (cp.crksph_pair, crk_solve),
                    'tsph': (ts.tsph_pair, ts.tsph_sweep)}
#: a crksph_pair kernel's set, by its functor's name in a trace
CRKSPH_SETS = {'NumDen': 'number density', 'Moments': 'moments',
               'Density': 'density', 'GradV': 'velocity gradient',
               'Mom<': 'momentum', 'Energy': 'energy'}


#: a tsph_pair kernel's set, by its functor's name in a trace (the density
#: set runs on the path as the sweep alone)
TSPH_SETS = {'Density': 'tsph_sweep', 'Gradient': 'tsph_pair velocity '
             'gradient', 'Momentum': 'tsph_pair momentum',
             'tsph_terms': 'tsph_pair per-source terms'}


def _layer(name):
    """The layer of a kernel of the accuracy test's trace."""
    if 'tsph_' in name:
        return next((v for k, v in TSPH_SETS.items() if k in name), 'tsph?')
    if 'crksph_pair' in name:
        return 'crksph_pair ' + next(
            (v for k, v in CRKSPH_SETS.items() if k in name), '?')
    if 'crk_solve' in name:
        return 'crk_solve'

    return ('gsph_pair acceleration' if 'gsph_pair' in name and
            'Acceleration' in name else 'gsph_pair gradients'
            if 'gsph_pair' in name else 'gasd_pair'
            if 'gasd_pair' in name else 'adke_pair'
            if 'adke_' in name else 'wcsph_pair'
            if 'wcsph_pair' in name else 'pack' if 'pack' in name
            else 'binning' if 'bin::' in name
            else 'elementwise and copies')


def _accuracy_drive(steps, chunk_steps, scheme='gsph'):
    """accuracy_test_2d --scheme ``scheme`` at full width in float32 for
    ``steps`` steps from the example's start in chunks of ``chunk_steps``
    (1: per step), timed (``time_chunks.timed_solve``, from step 20), the
    launches of the scheme's pair kernels (``ACCURACY_KERNELS``), the
    pack and the binning set to 0 just before and read just after (each
    must have launched); a step's launches and host reads, and a step's
    device time by layer and idle share (in chunks: a replay of the
    chunk's graph, a tenth of it; per step: one step's trace).  Returns
    (row, final state)."""
    app = gasd_check.app('accuracy_test_2d', ACCURACY_FULL, torch.float32,
                         steps=steps, extra=('--scheme', scheme))
    s = app.solver
    gc.collect()
    ops = ACCURACY_KERNELS[scheme] + (cell_pack.pack, bc.bin_cells)
    for op in ops:
        op.launches = 0
    gd.gasd_pair.adke_launches = 0
    ms, samples = time_chunks.timed_solve(app, chunk_steps)
    launches = {op.__name__: op.launches for op in ops}
    if scheme == 'adke':
        # csrc/adke_pair.cu's, counted apart by the gasd_pair wrapper
        launches['adke_pair'] = gd.gasd_pair.adke_launches
    if not all(launches.values()):
        raise AssertionError('accuracy %s did not run through every kernel '
                             'of its path: %s' % (scheme, launches))
    st = s.states['fluid']
    final = {p: v.clone() for p, v in st.items()}
    finite = all(bool(torch.isfinite(v).all()) for v in st.values()
                 if v.is_floating_point())
    if chunk_steps > 1:
        trace = prof_chunk.replay_gaps(s._graph)
        per = chunk_steps
    else:
        trace = prof_chunk.trace_gaps(
            lambda: s.integrator.step(s.states, s.t, s.dt))
        per = 1
    layers = {}
    for name, us in trace['busy'].items():
        key = _layer(name)
        layers[key] = layers.get(key, 0.0) + us / 1e3 / per
    cells = {b.name: b.cells(s.grid).dims
             for b in s.acceleration_evals[0].kept_binnings()}
    # an iterated group's sweeps: each evaluation's count, the slots a
    # chunk's evaluation holds, the redos that grew them
    swept = s.acceleration_evals[0].sweeps
    sweeps = dict(evaluations=len(swept), total=sum(swept),
                  most=max(swept, default=0),
                  slots=[p.slots for p in
                         s.acceleration_evals[0].sweep_plans()])
    row = dict(ms=ms, samples=len(samples), steps=s.count, t=s.t,
               sweeps=sweeps,
               chunk_steps=chunk_steps, launches=launches, cells=cells,
               shrinks=s.grid.shrinks,
               launches_per_step={k: v / s.count for k, v in
                                  launches.items()},
               reads_per_step=s.reads / s.count, captures=s.captures,
               replays=s.replays, grows=s.grid.grows, redos=s.redos,
               dims=s.grid.dims,
               step_busy_ms=(trace['span_us'] - trace['idle_us']) / 1e3 / per,
               step_span_ms=trace['span_us'] / 1e3 / per,
               idle_share=trace['idle_us'] / trace['span_us'],
               layers=layers, gaps=trace['gaps'],
               engines=[sorted(set(a.engine_choices.values()))
                        for a in s.acceleration_evals])
    how = 'in chunks of %d' % chunk_steps if chunk_steps > 1 else 'per step'
    print('accuracy_test_2d --scheme %s --nparticles %d float32 %s: %d '
          'steps to t=%.6g, median %.4f ms/step (min %.4f, max %.4f over %d '
          'samples from step %d); wrapper calls a step %s (in chunks a '
          'capture\'s count once); host reads a step %.3f; captures %d, '
          'replays %d; grid %s (%d grows, %d redos); each binning\'s '
          'periodic counts %s (%d sized down); a step\'s trace: busy '
          '%.4f ms of '
          '%.4f, idle share %.1f%%; device ms by layer %s; sweeps %s; '
          'finite %s' % (
              scheme, ACCURACY_FULL, how, s.count, s.t, ms, min(samples),
              max(samples), len(samples), time_chunks.WARMUP,
              row['launches_per_step'], row['reads_per_step'], s.captures,
              s.replays, s.grid.dims, s.grid.grows, s.redos, cells,
              s.grid.shrinks,
              row['step_busy_ms'],
              row['step_span_ms'], 100 * row['idle_share'],
              {k: round(v, 4) for k, v in layers.items()}, sweeps, finite),
          flush=True)
    if not finite or s.count != steps:
        raise AssertionError('accuracy %s %s ended non-finite' % (scheme,
                                                                  how))
    return row, final


def _chunks_match(scheme, steps=20):
    """accuracy_test_2d --scheme ``scheme`` at full width in float32,
    ``steps`` steps in chunks of 10 against the per-step loop: every prop,
    t, dt and the count bit for bit."""
    got = {}
    for k in (10, 1):
        app = gasd_check.app('accuracy_test_2d', ACCURACY_FULL,
                             torch.float32, steps=steps,
                             extra=('--scheme', scheme))
        app.solver.chunk_steps = k
        app.solve()
        got[k] = app.solver
    a, b = got[10], got[1]
    differ = [p for p, v in b.states['fluid'].items()
              if not torch.equal(v, a.states['fluid'][p])]
    print('accuracy_test_2d %s %d float32, %d steps in chunks of 10 (%d '
          'captures, %d replays) against per step: props that differ %s; t '
          '%s, dt %s, count %s equal' % (
              scheme, ACCURACY_FULL, steps, a.captures, a.replays, differ,
              a.t == b.t, a.dt == b.dt, a.count == b.count), flush=True)
    if differ or not (a.t == b.t and a.count == b.count == steps and
                      a.replays):
        raise AssertionError('accuracy %s: the chunks differ from the '
                             'per-step loop' % scheme)


#: ``_adke_checks``' float64 runs beyond ``_scheme_checks``': (run, size)
ADKE_F64_RUNS = (('shocktube', 320), ('accuracy_test_2d', 64),
                 ('hydrostatic_box', 50))


def _adke_checks(full):
    """ADKE's sets on ``csrc/adke_pair.cu`` beyond ``_scheme_checks``, in
    float64: on ``ADKE_F64_RUNS``, on periodic grids of 1, 2, 3, 5 and 8
    cells an axis and on an open grid's probe dests
    (``gasd_check.adke_calls``; float32 too in
    ``tests/test_torch_gsph_cuda.py``) (``gasd_check.check``: within TOL
    of max|ref|, the pairs and each dest's count equal); and each launch
    of ``full`` (the accuracy test's at full width in float32) repeated
    bit for bit.  Returns {label: largest scaled error}."""
    found = {}
    for run, size in ADKE_F64_RUNS:
        calls, n, _ = gasd_check.calls(run, size, torch.float64,
                                       extra=('--scheme', 'adke'))
        label = '%s adke %d float64' % (run, size)
        f = gasd_check.check(calls, label, TOL[torch.float64])
        found[label] = f['max_scaled_err']
        print('compare %s (%d particles): max scaled err %.3g (tol %.0e); '
              '%d pairs, 0 dests whose count differs' % (
                  label, n, f['max_scaled_err'], TOL[torch.float64],
                  f['pairs']), flush=True)
    for cells in (1, 2, 3, 5, 8, None):
        calls = gasd_check.adke_calls(cells, torch.float64)
        label = 'adke_pair %s float64' % (
            'periodic %d^2 cells' % cells if cells else
            'open grid, %d probe dests' % gasd_check.ADKE_PROBES)
        gd.gasd_pair.adke_launches = 0
        f = gasd_check.check(calls, label, TOL[torch.float64])
        if gd.gasd_pair.adke_launches != len(calls):
            raise AssertionError('%s: %d ADKE launches for %d calls' % (
                label, gd.gasd_pair.adke_launches, len(calls)))
        found[label] = f['max_scaled_err']
        print('compare %s: max scaled err %.3g (tol %.0e); %d pairs, 0 '
              'dests whose count differs' % (
                  label, f['max_scaled_err'], TOL[torch.float64],
                  f['pairs']), flush=True)
    dests = gasd_check.repeats(full)
    print('adke_pair accuracy_test_2d %d float32: each launch twice, %d '
          'dests\' outputs and counts bit for bit' % (ACCURACY_FULL, dests),
          flush=True)
    return found


def _gas_schemes_phase(kernels):
    """``GSPHScheme`` on ``gsph_pair`` and ``ADKEScheme`` on ``gasd_pair``'s
    ADKE sets: the kernels against their plain versions
    (``_scheme_checks``), the runs against the JAX package's figures
    (``_scheme_gates``), and the accuracy test at full width in float32:
    20 steps in chunks bit for bit the per-step loop, 200 steps timed in
    chunks of 10 and per step (``_accuracy_drive``), the run to tf = 1.0
    with its L1 under ``ACCURACY_L1_BAR``; ``--scheme adke`` at full width
    in float32 for ``ADKE_STEPS`` steps per step, whose launches of
    ``csrc/adke_pair.cu`` the ``gasd_pair adke`` entry reports, 20 steps
    in chunks bit for bit the per-step loop and 200 steps timed in chunks
    of 10, its sets' further checks (``_adke_checks``), its lanes,
    registers and spills; each set timed at full width, its
    bound from ``roofline.py`` (the support tests counted on cells that
    fit the call's h, ``fitted_cells``; the walk's extra candidates on the
    grid's cells printed beside it).  Adds the entries ``gsph_pair`` and
    ``gasd_pair adke``."""
    resources = gasd_check.resources(build.build('gsph_pair'),
                                     kernel='gsph_pair')
    adke_res = gasd_check.resources(build.build('adke_pair'),
                                    kernel='adke_pair')
    lanes = build.load_library('adke_pair', gd._Args).adke_pair_lanes()
    print('adke_pair: %d lanes a dest; registers and spill bytes (stores, '
          'loads) at kind 2: %s' % (lanes, adke_res), flush=True)
    errs, full = _scheme_checks()
    adke_checks = _adke_checks(full['adke'])
    gates = _scheme_gates()
    # full width: chunks against per step, bit for bit
    for scheme in ('gsph', 'adke'):
        _chunks_match(scheme)
    drive, _ = _accuracy_drive(STEPS, 10)
    per_step, _ = _accuracy_drive(STEPS, 1)
    adke_run, _ = _accuracy_drive(ADKE_STEPS, 1, 'adke')
    adke_chunks, _ = _accuracy_drive(STEPS, 10, 'adke')
    # the whole run to tf = 1.0 in chunks
    app = gasd_check.app('accuracy_test_2d', ACCURACY_FULL, torch.float32,
                         extra=('--scheme', 'gsph'))
    start = time.perf_counter()
    app.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    s = app.solver
    st = {p: s.states['fluid'][p].double().cpu().numpy()
          for p in ('x', 'y', 'rho')}
    l1 = accuracy_test_2d.l1_norm(st['x'], st['y'], st['rho'])
    print('accuracy_test_2d --scheme gsph --nparticles %d float32 to t=%.8g: '
          '%d steps in %.1f s; L1 of rho %.6g (bar %.2f, the JAX package\'s '
          'slow test\'s)' % (ACCURACY_FULL, s.t, s.count, secs, l1,
                              ACCURACY_L1_BAR), flush=True)
    if not (abs(s.t - 1.0) < 1e-6 and l1 < ACCURACY_L1_BAR):
        raise AssertionError('accuracy gsph at full width: L1 %r' % l1)
    whole = dict(t=s.t, steps=s.count, seconds=secs, l1=l1)
    del app, s
    candidates = _gsph_path_candidates()
    # each set at full width
    gsets = _set_times(full['gsph'], gs.gsph_pair,
                       {gs.GRAD: 'gradients', gs.ACC: 'acceleration'},
                       roofline.gsph_work)
    linked = _gsph_linked_times(full['gsph'])
    asets = _set_times(full['adke'], gd.gasd_pair,
                       {gd.ADEN: 'adke density', gd.ADKE: 'adke accel'},
                       roofline.gasd_work)
    for label, sets in (('gsph_pair', gsets), ('gasd_pair adke', asets)):
        for name, t in sets.items():
            w = t['work']
            print('%s %s, accuracy_test_2d %d float32: %.4f ms in a graph '
                  '(eager %.4f, plain %.3f); bound %.4f ms (%s: %.4g flops, '
                  '%d candidates on cells that fit its h, %d pairs, %d B), '
                  'share %.1f%%; its walk on the grid\'s cells tests %d '
                  'candidates (%.1f a pair, %.1f on fitted cells)' % (
                      label, name, ACCURACY_FULL, t['ms'], t['eager_ms'],
                      t['plain_ms'], t['bound_ms'], t['bound_by'],
                      w['flops'], w['candidates'], w['pairs'], w['bytes'],
                      100 * t['bound_ms'] / t['ms'], w['walk_candidates'],
                      w['walk_candidates'] / w['pairs'],
                      w['candidates'] / w['pairs']), flush=True)
    print('gsph_pair registers and spill bytes (stores, loads) at kind 2: %s'
          % resources, flush=True)
    lbound = roofline.bound(linked['work'])
    print('gsph_pair linked, accuracy_test_2d %d float32: the pair %.4f ms '
          'in a graph (eager %.4f): emit %.4f, the acceleration on its list '
          '%.4f; the two walking launches %.4f; bound %.4f ms (%s: the '
          'gradients\' walk and the acceleration\'s pairs), share %.1f%%'
          % (ACCURACY_FULL, linked['linked_ms'], linked['eager_ms'],
             linked['emit_ms'], linked['consume_ms'], linked['walking_ms'],
             lbound[0], lbound[1], 100 * lbound[0] / linked['linked_ms']),
          flush=True)
    gwork = roofline.add(*[t['work'] for t in gsets.values()])
    awork = roofline.add(*[t['work'] for t in asets.values()])
    # the per-step run's launches: a captured chunk's replays launch the
    # kernels without calling their wrappers
    kernels['gsph_pair'] = _entry(
        'gsph_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
        per_step['launches']['gsph_pair'], errs['gsph full'],
        linked['linked_ms'],
        sum(t['plain_ms'] for t in gsets.values()), linked['work'], None,
        eager_ms=linked['eager_ms'], sets={
            k: {n: v for n, v in t.items() if n != 'work'}
            for k, t in gsets.items()},
        linked={k: v for k, v in linked.items() if k != 'work'},
        walking_bound_ms=roofline.bound(gwork)[0],
        candidates=candidates, resources=resources, gates=gates, run=drive,
        per_step_run=per_step, whole_run=whole,
        path='accuracy_test_2d --scheme gsph %d^2 float32, the gradients '
        'and the acceleration of one evaluation, linked as the path runs '
        'them' % ACCURACY_FULL)
    kernels['gasd_pair adke'] = dict(_entry(
        'gasd_pair adke', 'pysph_tpu/ops/pallas_engine.py:1160',
        adke_run['launches']['adke_pair'], errs['adke full'],
        sum(t['ms'] for t in asets.values()),
        sum(t['plain_ms'] for t in asets.values()), awork, None,
        eager_ms=sum(t['eager_ms'] for t in asets.values()), sets={
            k: {n: v for n, v in t.items() if n != 'work'}
            for k, t in asets.items()},
        run=adke_run, chunked_run=adke_chunks, lanes=lanes,
        resources=adke_res, checks=adke_checks,
        path='accuracy_test_2d --scheme adke %d^2 float32, the ADKE density '
        'and accelerations of one evaluation; launches: %d steps of that run '
        'per step' % (ACCURACY_FULL, ADKE_STEPS)),
        source='pysph_tpu_torch/csrc/adke_pair.cu')
    return drive, per_step, adke_chunks, adke_run


def _crksph_gates():
    """The CRKSPH runs against the JAX package's figures (``JAX_CRKSPH``):
    the accuracy test at 32^2 to tf and the hydrostatic box at nx=50 for
    200 steps in float64, Taylor-Green at ``TG_CRKSPH_NX`` for 200 steps in
    float32,
    each in chunks with every pair phase of both evaluators on
    ``crksph_pair``, the first evaluator's five on one list (0 dests past
    its capacity; each run's most pairs a dest, ``crk_nnbr``, printed).
    Returns the rows."""
    rows = {}

    def run(name, size, dtype, steps=0):
        app = crksph_check.app(name, size, dtype, steps=steps)
        s = app.solver
        engines = [set(a.engine_choices.values())
                   for a in s.acceleration_evals]
        if engines != [{'kernel'}, {'kernel'}]:
            raise AssertionError('crksph %s: pair phases off crksph_pair: '
                                 '%s' % (name, engines))
        cp.reset_launches()
        cp.reset_overflow('cuda')
        st0 = {p: s.states['fluid'][p].double().cpu().numpy()
               for p in 'uv'}
        start = time.perf_counter()
        app.solve()
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        if not all(cp.crksph_pair.by_set):
            raise AssertionError('crksph %s: a set never launched: %s' % (
                name, cp.crksph_pair.by_set))
        over = cp.overflowed('cuda')
        if over:
            raise AssertionError('crksph %s: %d dests past the list\'s '
                                 'capacity' % (name, over))
        st = {p: v.double().cpu().numpy() for p, v in s.states['fluid'].items()
              if v.is_floating_point()}
        return s, st0, st, '%.1f s, launches by set %s, most pairs a dest ' \
            '%d (0 past the capacity)' % (secs, cp.crksph_pair.by_set,
                                          int(st['crk_nnbr'].max()))

    size, l1_jax = JAX_CRKSPH['accuracy']
    s, _, st, extra = run('accuracy_test_2d', size, torch.float64)
    l1 = accuracy_test_2d.l1_norm(st['x'], st['y'], st['rho'])
    if abs(s.t - 1.0) >= 1e-9:
        raise AssertionError('accuracy crksph ended at t=%r' % s.t)
    rows['accuracy'] = _gate_row(
        'accuracy_test_2d --scheme crksph --nparticles %d float64 at t=%.8g '
        'after %d steps' % (size, s.t, s.count), dict(l1=l1),
        dict(l1=l1_jax), extra)
    s, _, st, extra = run('hydrostatic_box', 50, torch.float64, STEPS)
    figs = hydrostatic_box.figures(st['u'], st['v'], st['rho'], st['m'],
                                   1.0 / 50)
    want = JAX_CRKSPH['hydrostatic']
    rows['hydrostatic'] = _gate_row(
        'hydrostatic_box (crksph) --nx 50 float64 at t=%.8g after %d steps, '
        'rho\'s spread' % (s.t, s.count), dict(rho_spread=figs['rho_spread']),
        dict(rho_spread=want['rho_spread']), extra)
    print('hydrostatic_box (crksph) --nx 50: largest speed %.3g (the JAX '
          'package\'s %.3g; bar %.0e, HYDROSTATIC_STILL)' % (
              figs['max_speed'], want['max_speed'], HYDROSTATIC_STILL),
          flush=True)
    if not figs['max_speed'] < HYDROSTATIC_STILL:
        raise AssertionError('the hydrostatic box moved under crksph')
    rows['hydrostatic']['max_speed'] = figs['max_speed']
    s, st0, _, extra = run('taylor_green', TG_CRKSPH_NX, torch.float32,
                           STEPS)
    out = dict(vmax0=float(np.sqrt(st0['u'] ** 2 + st0['v'] ** 2).max()))
    _tg_decay(out, s, key='crksph', nx=TG_CRKSPH_NX)
    rows['taylor_green'] = out
    print('taylor_green crksph nx=%d: %s' % (TG_CRKSPH_NX, extra),
          flush=True)
    return rows


def _crksph_phase(kernels):
    """``CRKSPHScheme`` on ``crksph_pair`` and its ``post_loop`` solve on
    ``crk_solve``: the six sets of both evaluators against their plain
    versions in float64 and float32 (``crksph_check.check``, each call
    walking) on the accuracy test at full width (periodic) after a
    jittered step, on an open 2D box with a singular particle and on an
    open 3D box; the first evaluator's linked chain on the accuracy test
    and the open 2D box (``crksph_check.check_linked``: the number density
    emitting, four calls reading its list, against the plain version and
    the walking calls, the list against ``neighbours_reference``, 0 dests
    past the capacity at full width; the 3D box unlinked); the solve
    against its plain version on the three (``crksph_check.check_solve``,
    the same particles singular); the JAX package's figures
    (``_crksph_gates``); the accuracy test at full width in float32: 20
    steps in chunks bit for bit the per-step loop, 200 steps timed in
    chunks of 10 and per step (``_accuracy_drive``: every pair phase of
    both evaluators on the kernel, the solve on its own, a step's
    launches, host reads, device ms by layer and idle share; 0 dests past
    the list's capacity); each set timed there walking and as the path
    runs it, beside its bound, the solve beside its plain version; lanes,
    registers and spills by instantiation.  Adds the entries
    ``crksph_pair`` and ``crk_solve``; returns (chunked run, per-step
    run)."""
    t0 = time.perf_counter()
    resources = crksph_check.resources()
    lanes = crksph_check.lanes()
    solve_res = build.resources(build.build('crk_solve'))
    print('crksph_pair lanes a dest by set (float32, float64): %s; '
          'registers and spill bytes (stores, loads) by instantiation '
          '(QuinticSpline): %s; crk_solve: %s' % (lanes, resources,
                                                 solve_res), flush=True)
    errs, linked, solves, full = {}, {}, {}, None
    for dtype in (torch.float64, torch.float32):
        tol = TOL[dtype]
        acc_calls, _, acc_app = crksph_check.calls(
            'accuracy_test_2d', ACCURACY_FULL, dtype)
        cases = [('accuracy_test_2d %d periodic' % ACCURACY_FULL, acc_calls)]
        cases += [('%s box' % case, crksph_check.box_calls(case, dtype))
                  for case in ('open', '3d')]
        for label, calls in cases:
            label = '%s %s' % (label, str(dtype)[6:])
            if [c[2].op for c in calls] != [cp.crksph_pair] * 6:
                raise AssertionError('crksph %s: not six crksph_pair calls'
                                     % label)
            f = crksph_check.check(calls, label, tol)
            errs[label] = f
            print('compare crksph_pair %s: max scaled err %.3g (tol %.0e), '
                  'by set %s; %d pairs, 0 dests whose count differs' % (
                      label, f['max_scaled_err'], tol,
                      {k: float('%.3g' % v) for k, v in f['by_set'].items()},
                      f['pairs']), flush=True)
            if '3d' in label:
                if any(c[2].link is not None for c in calls):
                    raise AssertionError('crksph %s: linked in 3D' % label)
                continue
            f = crksph_check.check_linked(calls, label, tol)
            linked[label] = f
            print('crksph_pair %s linked (the number density emitting, 4 '
                  'launches reading its list): max scaled err %.3g against '
                  'the plain version, %.3g against the walking launches; '
                  'the list as neighbours_reference; most pairs a dest %d, '
                  '%d past the capacity %d' % (
                      label, f['max_scaled_err'], f['against_walk'],
                      f['most_pairs'], f['overflowed'],
                      cp.CAPACITY[2]), flush=True)
            if 'accuracy' in label and f['overflowed']:
                raise AssertionError('crksph %s: %d dests past the list\'s '
                                     'capacity' % (label, f['overflowed']))
        # the solve on the moments after the moments set: the accuracy
        # test's evaluated state, each box's state as its density call
        # saw it (the open box's far particle singular)
        states = [(cases[0][0], acc_app.solver.states['fluid'], 2)] + [
            (label, calls[2][3][0], 3 if '3d' in label else 2)
            for label, calls in cases[1:]]
        for label, st, dim in states:
            label = '%s %s' % (label, str(dtype)[6:])
            err, scaled, singular = crksph_check.check_solve(st, dim, tol,
                                                             label)
            solves[label] = dict(max_abs_err=err, max_scaled_err=scaled,
                                 singular=singular)
            print('compare crk_solve %s: max abs err %.3g, scaled %.3g (tol '
                  '%.0e); %d particles singular or with fewer than 2 '
                  'neighbours, the same in both' % (label, err, scaled, tol,
                                                    singular), flush=True)
        if dtype == torch.float32:
            full = cases[0][1]
    gates = _crksph_gates()
    _chunks_match('crksph')
    cp.reset_overflow('cuda')
    drive, _ = _accuracy_drive(STEPS, 10, 'crksph')
    per_step, final = _accuracy_drive(STEPS, 1, 'crksph')
    overflowed = cp.overflowed('cuda')
    most = int(final['crk_nnbr'].max())
    print('accuracy_test_2d --scheme crksph %d float32, the two 200-step '
          'runs: %d dests past the list\'s capacity %d; most pairs a dest '
          'at the end %d' % (ACCURACY_FULL, overflowed, cp.CAPACITY[2],
                             most), flush=True)
    if overflowed:
        raise AssertionError('accuracy crksph: %d dests past the list\'s '
                             'capacity' % overflowed)
    for r in (drive, per_step):
        if r['engines'] != [['kernel'], ['kernel']]:
            raise AssertionError('accuracy crksph: pair phases off the '
                                 'kernel: %s' % r['engines'])
    # the post_loop's solve alone, on the run's moments, and its plain
    # version (the torch ops that ran before it)
    moments = crksph_check.solve_moments(final, 2)
    solve_ms = graph_ms(lambda: crksph.crk_solve(*moments), 20)
    solve_plain_ms = graph_ms(lambda: crk_solve_reference(*moments), 20)
    solve_work = roofline.crk_solve_work(final['x'].shape[0], 2,
                                         final['x'].element_size())
    sets = crksph_check.set_times(full)
    chain = crksph_check.chain_times(full)
    for name, t in sets.items():
        w = t['work']
        print('crksph_pair %s, accuracy_test_2d %d float32, walking: %.4f '
              'ms in a graph (eager %.4f, plain %.3f); bound %.4f ms (%s: '
              '%.4g flops, %d candidates, %d pairs, %d B), share %.1f%%; on '
              'the path %s ms' % (
                  name, ACCURACY_FULL, t['ms'], t['eager_ms'], t['plain_ms'],
                  t['bound_ms'], t['bound_by'], w['flops'], w['candidates'],
                  w['pairs'], w['bytes'], 100 * t['bound_ms'] / t['ms'],
                  '%.4f' % chain.get(name, chain['emit'] if name ==
                                     'number density' else t['ms'])),
              flush=True)
    work = roofline.crksph_path_work(full)
    walking = roofline.add(*[t['work'] for t in sets.values()])
    print('crksph_pair accuracy_test_2d %d float32, a step\'s six launches '
          'as the path runs them: %.4f ms in a graph (the linked chain %.4f, '
          'the six walking %.4f); bound %.4f ms (%s: one walk, four list '
          'reads, the energy\'s walk), %.4f counting six walks; share %.1f%%'
          % (ACCURACY_FULL, chain['six'], chain['chain'],
             sum(t['ms'] for t in sets.values()), roofline.bound(work)[0],
             roofline.bound(work)[1], roofline.bound(walking)[0],
             100 * roofline.bound(work)[0] / chain['six']), flush=True)
    print('crk_solve, accuracy_test_2d %d float32: %.4f ms in a graph, its '
          'plain version (the torch ops) %.4f; bound %.4f ms (%s)' % (
              ACCURACY_FULL, solve_ms, solve_plain_ms,
              roofline.bound(solve_work)[0], roofline.bound(solve_work)[1]),
          flush=True)
    kernels['crksph_pair'] = _entry(
        'crksph_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
        per_step['launches']['crksph_pair'],
        errs['accuracy_test_2d %d periodic float32' % ACCURACY_FULL][
            'max_abs_err'],
        chain['six'], sum(t['plain_ms'] for t in sets.values()), work, None,
        eager_ms=sum(t['eager_ms'] for t in sets.values()), sets={
            k: {n: v for n, v in t.items() if n != 'work'}
            for k, t in sets.items()}, linked_ms=chain,
        walking_bound_ms=roofline.bound(walking)[0], lanes=lanes,
        resources=resources, gates=gates, run=drive, per_step_run=per_step,
        checks={k: v['max_scaled_err'] for k, v in errs.items()},
        linked=linked, overflowed=overflowed, most_pairs=most,
        seconds=time.perf_counter() - t0,
        path='accuracy_test_2d --scheme crksph %d^2 float32, the six pair '
        'calls of one step (two evaluators) as the path runs them: the '
        'first evaluator\'s five linked, the energy walking; launches: %d '
        'steps of that run per step' % (ACCURACY_FULL, STEPS))
    kernels['crk_solve'] = dict(_entry(
        'crk_solve', 'pysph_tpu/sph/wc/crksph.py:86',
        per_step['launches']['crk_solve'],
        solves['accuracy_test_2d %d periodic float32' % ACCURACY_FULL][
            'max_abs_err'], solve_ms, solve_plain_ms, solve_work, None,
        checks=solves, resources=solve_res,
        path='accuracy_test_2d --scheme crksph %d^2 float32, the post_loop '
        'solve of one step on its moments after 200 steps; launches: %d '
        'steps of that run per step' % (ACCURACY_FULL, STEPS)),
        note='CRKSPHPreStep.post_loop\'s solve; the JAX package computes it '
        'in jnp (crk_solve, jnp.linalg.det and inv), not in a pallas_call')
    return drive, per_step


def _tsph_gate(run, size, dtype, steps=0, scheme='tsph'):
    """``run`` (``tsph_check.RUNS``) under ``--scheme scheme`` at ``size``
    in ``dtype`` from the example's start, in chunks, to its tf or for
    ``steps`` steps: (solver, its fluid state in float64 on the host,
    launches, seconds); every pair phase on a kernel, each of the scheme's
    kernels launched, and the run finite."""
    app = tsph_check.app(run, size, dtype, steps=steps,
                         extra=('--scheme', scheme))
    s = app.solver
    ops = (ts.tsph_pair, ts.tsph_sweep) if scheme == 'tsph' else \
        (gs.gsph_pair, gd.gasd_pair)
    ts.reset_launches()
    for op in ops:
        op.launches = 0
    start = time.perf_counter()
    app.solve()
    torch.cuda.synchronize()
    secs = time.perf_counter() - start
    st = {p: v.double().cpu().numpy() for p, v in s.states['fluid'].items()
          if v.is_floating_point()}
    launches = {op.__name__: op.launches for op in ops}
    if scheme == 'tsph':
        launches['tsph_pair by set'] = list(ts.tsph_pair.by_set)
    engines = set(s.acceleration_evals[0].engine_choices.values())
    finite = all(np.isfinite(v).all() for v in st.values())
    if not all(op.launches for op in ops) or engines != {'kernel'} or \
            not finite:
        raise AssertionError('%s %s %d: not every pair phase on a kernel '
                             'or not finite (%s, %s, finite %s)' % (
                                 run, scheme, size, launches, engines,
                                 finite))
    return s, st, launches, '%.1f s, launches %s, sweeps %d in %d ' \
        'evaluations (most %d), captures %d, redos %d' % (
            secs, launches, sum(s.acceleration_evals[0].sweeps),
            len(s.acceleration_evals[0].sweeps),
            max(s.acceleration_evals[0].sweeps, default=0), s.captures,
            s.redos)


def _tsph_gates():
    """The TSPH runs, and Cheng-Shu's ``gsph`` in 1D, against the JAX
    package's figures (``JAX_TSPH``, ``JAX_CHENG_SHU_GSPH``): the accuracy
    test at 32^2 to tf, the hydrostatic box at nx=50 for 200 steps and
    Cheng-Shu's 1,000 particles for 200 steps in float64, Sedov at nx=41
    for 200 steps in float32, each in chunks with every pair phase on a
    kernel.  Returns the rows."""
    rows = {}
    size, l1_jax = JAX_TSPH['accuracy']
    s, st, _, extra = _tsph_gate('accuracy_test_2d', size, torch.float64)
    if abs(s.t - 1.0) >= 1e-9:
        raise AssertionError('accuracy tsph ended at t=%r' % s.t)
    rows['accuracy'] = _gate_row(
        'accuracy_test_2d --scheme tsph --nparticles %d float64 at t=%.8g '
        'after %d steps' % (size, s.t, s.count),
        dict(l1=accuracy_test_2d.l1_norm(st['x'], st['y'], st['rho'])),
        dict(l1=l1_jax), extra)
    s, st, _, extra = _tsph_gate('hydrostatic_box', 50, torch.float64,
                                 STEPS)
    rows['hydrostatic'] = _gate_row(
        'hydrostatic_box --scheme tsph --nx 50 float64 at t=%.8g after %d '
        'steps' % (s.t, s.count),
        hydrostatic_box.figures(st['u'], st['v'], st['rho'], st['m'],
                                1.0 / 50), JAX_TSPH['hydrostatic'], extra)
    s, st, _, extra = _tsph_gate('sedov', 41, torch.float32, STEPS)
    rows['sedov'] = _gate_row(
        'sedov --scheme tsph --nx 41 float32 at t=%.8g after %d steps' % (
            s.t, s.count),
        sedov.figures(st['x'], st['y'], st['u'], st['v'], st['rho'],
                      st['m'], st['e']), JAX_TSPH['sedov'], extra)
    for scheme, want in (('tsph', JAX_TSPH['cheng_shu_1d']),
                         ('gsph', JAX_CHENG_SHU_GSPH)):
        s, st, _, extra = _tsph_gate('cheng_shu_1d', 1000, torch.float64,
                                     STEPS, scheme)
        rows['cheng_shu_1d %s' % scheme] = _gate_row(
            'cheng_shu_1d --scheme %s 1000 particles (1D, periodic) float64 '
            'at t=%.8g after %d steps' % (scheme, s.t, s.count),
            cheng_shu_1d.figures(st['x'], st['rho'], st['u'], s.t), want,
            extra)
    return rows


#: TSPH's small runs for the kernel checks: (run, size)
TSPH_RUNS = (('accuracy_test_2d', 24), ('hydrostatic_box', 20),
             ('cheng_shu_1d', 1000))


def _tsph_phase(kernels):
    """``TSPHScheme`` on ``tsph_pair`` (``_tsph_phase``): its three sets
    against their plain versions (``tsph_check.check``: within TOL of
    max|ref|, each dest's pairs equal, each walking) on jittered small
    states (``TSPH_RUNS``: the accuracy test at 24^2, the hydrostatic box
    at nx=20, Cheng-Shu's 1,000 particles in 1D) in float64 and float32
    and the accuracy test at 256^2 in float32; the gated sweep
    (``gasd_check.check_sweep``: every sweep of an iteration from an h
    moved by 5% against its plain version, the converged flags and the
    count equal, its list against ``neighbours_reference``, the velocity
    gradient and the momentum on the last sweep's list bit for bit their
    walks) on the same states; the JAX package's figures
    (``_tsph_gates``); the accuracy test at 256^2 in float32: 20 steps in
    chunks bit for bit the per-step loop, 200 steps in chunks of 10 and
    ``ADKE_STEPS`` per step (``_accuracy_drive``: every pair phase on a
    kernel, both ops launched, a step's launches, host reads, sweeps and
    slots, device ms by layer and idle share); each set timed there
    walking, the sweep and the two readers on its list as the path runs
    them, beside their bounds; registers and spills by instantiation.
    Adds the entries ``tsph_pair`` and ``tsph_sweep``; returns (chunked
    run, per-step run)."""
    t0 = time.perf_counter()
    resources = tsph_check.resources()
    print('tsph_pair registers and spill bytes (stores, loads) by '
          'instantiation (Gaussian): %s' % resources, flush=True)
    errs, sweeps, full = {}, {}, None
    for dtype in (torch.float64, torch.float32):
        tol = TOL[dtype]
        runs = list(TSPH_RUNS)
        if dtype == torch.float32:
            runs.append(('accuracy_test_2d', ACCURACY_FULL))
        for run, size in runs:
            label = '%s %d %s' % (run, size, str(dtype)[6:])
            calls, n, _ = tsph_check.calls(run, size, dtype)
            if [c[2].op for c in calls] != [ts.tsph_pair] * 3:
                raise AssertionError('tsph %s: not three tsph_pair calls'
                                     % label)
            f = errs[label] = tsph_check.check(calls, label, tol)
            print('compare tsph_pair %s (%d particles): max scaled err %.3g '
                  '(tol %.0e), by set %s; %d pairs, 0 dests whose count '
                  'differs' % (
                      label, n, f['max_scaled_err'], tol,
                      {k: float('%.3g' % v) for k, v in f['by_set'].items()},
                      f['pairs']), flush=True)
            if size == ACCURACY_FULL:
                full = calls
            # after two steps: the start's h (2 dx in the accuracy test)
            # has met hfact's
            sw = tsph_check.sweep_start(run, size, dtype, steps=2)
            f = sweeps[label] = gasd_check.check_sweep(sw, label, tol)
            print('tsph_sweep %s: %d sweeps (kernel alone %d, plain alone '
                  '%d), max scaled err %.3g, %d converged flags apart '
                  '(float32 within %.0e of htol); the list as '
                  'neighbours_reference, most pairs a dest %d, %d past the '
                  'capacity %d; the velocity gradient and the momentum on '
                  'it bit for bit their walks (%d on the list, %d walking)'
                  % (label, f['sweeps'], f['sweeps_kernel'],
                     f['sweeps_plain'], f['max_scaled_err'],
                     f['flags_differ'], gasd_check.FLIP_BAR, f['max_count'],
                     f['overflowed'], f['capacity'], f['linked'],
                     f['walked']), flush=True)
            del calls, sw
    gates = _tsph_gates()
    _chunks_match('tsph')
    drive, _ = _accuracy_drive(STEPS, 10, 'tsph')
    per_step, _ = _accuracy_drive(ADKE_STEPS, 1, 'tsph')
    for r in (drive, per_step):
        if r['engines'] != [['kernel']]:
            raise AssertionError('accuracy tsph: pair phases off the '
                                 'kernel: %s' % r['engines'])
    print('accuracy_test_2d --scheme tsph %d float32: sweeps in chunks %s, '
          'per step %s; redos %d and %d' % (
              ACCURACY_FULL, drive['sweeps'], per_step['sweeps'],
              drive['redos'], per_step['redos']), flush=True)
    sets = tsph_check.set_times(full)
    for name, t in sets.items():
        w = t['work']
        print('tsph_pair %s, accuracy_test_2d %d float32, walking: %.4f '
              'ms in a graph (eager %.4f, plain %.3f); bound %.4f ms (%s: '
              '%.4g flops, %d candidates, %d pairs, %d B), share %.1f%%' % (
                  name, ACCURACY_FULL, t['ms'], t['eager_ms'],
                  t['plain_ms'], t['bound_ms'], t['bound_by'], w['flops'],
                  w['candidates'], w['pairs'], w['bytes'],
                  100 * t['bound_ms'] / t['ms']), flush=True)
    sw = tsph_check.sweep_start('accuracy_test_2d', ACCURACY_FULL,
                                torch.float32, steps=2)
    st = gasd_check.sweep_times(sw)
    sweep_bound = roofline.bound(st['work'])
    linked_bound = roofline.bound(st['linked_work'])
    print('tsph_sweep, accuracy_test_2d %d float32 after two steps, from an '
          'h moved by 5%%: '
          'a sweep %.4f ms in a graph (eager %.4f, plain %.3f); bound %.4f '
          'ms (%s: %.4g flops, %d candidates, %d pairs, %d B), share '
          '%.1f%%; the iteration %d sweeps (converged %s), %d dests past '
          'the capacity %d (most pairs %d); the velocity gradient and the '
          'momentum on its list %.4f ms in a graph (walking %.4f), bound '
          '%.4f ms (%s), by reader %s' % (
              ACCURACY_FULL, st['ms'], st['eager_ms'], st['plain_ms'],
              sweep_bound[0], sweep_bound[1], st['work']['flops'],
              st['work']['candidates'], st['work']['pairs'],
              st['work']['bytes'], 100 * sweep_bound[0] / st['ms'],
              st['sweeps'], st['converged'], st['overflowed'],
              ts.CAPACITY[2], st['max_count'], st['linked_ms'],
              st['walk_ms'], linked_bound[0], linked_bound[1],
              [(r['outputs'], round(r['linked_ms'], 4),
                round(r['walk_ms'], 4)) for r in st['readers']]),
          flush=True)
    full_label = 'accuracy_test_2d %d float32' % ACCURACY_FULL
    readers_plain = sets['velocity gradient']['plain_ms'] + \
        sets['momentum']['plain_ms']
    kernels['tsph_pair'] = _entry(
        'tsph_pair', 'pysph_tpu/ops/pallas_engine.py:1160',
        per_step['launches']['tsph_pair'], errs[full_label]['max_abs_err'],
        st['linked_ms'], readers_plain, st['linked_work'], None,
        walk_ms=st['walk_ms'], sets={
            k: {n: v for n, v in t.items() if n != 'work'}
            for k, t in sets.items()},
        readers=[{k: v for k, v in r.items() if not k.endswith('work')}
                 for r in st['readers']], resources=resources, gates=gates,
        run=drive, per_step_run=per_step,
        checks={k: v['max_scaled_err'] for k, v in errs.items()},
        seconds=time.perf_counter() - t0,
        path='accuracy_test_2d --scheme tsph %d^2 float32, the velocity '
        'gradient and the momentum of one evaluation on the last sweep\'s '
        'list (bound: their pairs alone); launches: %d steps of that run '
        'per step' % (ACCURACY_FULL, ADKE_STEPS))
    kernels['tsph_sweep'] = dict(_entry(
        'tsph_sweep', 'pysph_tpu/ops/pallas_engine.py:1160',
        per_step['launches']['tsph_sweep'],
        max(v['max_abs_err'] for k, v in sweeps.items()
            if 'float32' in k), st['ms'], st['plain_ms'], st['work'],
        None, eager_ms=st['eager_ms'], sweeps=sweeps,
        path='accuracy_test_2d --scheme tsph %d^2 float32 after two steps, '
        'one gated sweep (pack, initialize, sums, post_loop, count, list) '
        'from an h moved by 5%%; launches: %d steps of that run per step' % (
            ACCURACY_FULL, ADKE_STEPS)),
        source='pysph_tpu_torch/csrc/tsph_pair.cu')
    return drive, per_step


def _kinds_row():
    """``gtvf_pair`` at kind 4 on the Taylor-Green vortex's ``--scheme
    gtvf --nx 400 --kernel WendlandQuinticC4`` (float32, perturbed): a
    step's launches against their plain versions, timed in a graph and
    eagerly, the plain version, and the bound from ``roofline.py``, as
    the ``gtvf_pair periodic`` entry is measured."""
    calls, n, _ = tvf_check.calls(400, torch.float32, False, 'gtvf',
                                  flags=('--kernel', 'WendlandQuinticC4'))
    err = _compare(calls, torch.float32, 'gtvf_pair C4 taylor_green gtvf '
                   'nx=400 float32 (%d particles)' % n)
    ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    plain = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    work = _calls_work(calls, roofline.gtvf_work)
    bound_ms, bound_by = roofline.bound(work)
    print('gtvf_pair at kind 4 (WendlandQuinticC4), the %d launches of a '
          'step of taylor_green --scheme gtvf nx=400 float32: %.4f ms in a '
          'graph, %.4f eager, plain torch %.3f ms; bound %.4f ms (%s: %.4g '
          'flops, %d B; %d candidates, %d pairs); share %.1f%%; max abs err '
          '%.3g' % (len(calls), ms, eager, plain, bound_ms, bound_by,
                    work['flops'], work['bytes'], work['candidates'],
                    work['pairs'], 100 * bound_ms / ms, err), flush=True)
    del calls


def _kinds_phase():
    """Each later kind (``kind_check.NEW_KINDS``) in every pair kernel
    that takes kinds against its plain version, in both dtypes
    (``tools_dev/kind_check.py``: the Taylor-Green vortex at nx=50 under
    ``tvf``, ``gtvf``, ``wcsph`` on both engines and ``wcsph
    --delta-sph``, dam_break_3d at dx=0.04 on both engines and with
    ``--delta-sph``; 0 flipped accept decisions)."""
    for kernel in kind_check.NEW_KINDS:
        for dtype in (torch.float64, torch.float32):
            for label, f in kind_check.check(kernel, dtype).items():
                print('%s (kinds %s): max abs err %.3g, max scaled err '
                      '%.3g%s' % (label, f['kinds'], f['max_abs_err'],
                                  f['max_scaled_err'],
                                  '; %d linked pairs, %d flips' % (
                                      f['linked'], f['flips'])
                                  if 'flips' in f else ''), flush=True)


def _c4_phase(runs, kernels):
    """dam_break_3d with ``--kernel WendlandQuinticC4``: ``wcsph_pair`` at
    kind 4 against its plain version at dx=0.02 in float32 on the
    perturbed state (float64 and both engines at dx=0.04 are
    ``_kinds_phase``'s), timed there with its registers and spills; then
    the path as the main path under the binning reuse (3 launches in the
    initial eval, 6 a step).  Adds the ``wcsph_pair C4`` entry."""
    label = 'dam_break_3d dx=0.02 C4'
    flags = time_chunks.PATHS[label]['extra']
    calls, n = pair_calls(0.02, torch.float32, extra=flags)
    err = _compare(calls, torch.float32, 'wcsph_pair %s float32 (%d '
                   'particles)' % (label, n))
    eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    plain_ms = events_ms(lambda: [c[2].reference(*c[3]) for c in calls], 3)
    work = _calls_work(calls, roofline.wcsph_work)
    lib = build.build('wcsph_pair', build.kind_flags(4))
    resources = {name.split('_pair_kernel')[-1]: res
                 for name, res in sorted(build.resources(lib).items())
                 if 'Lb0ELb0ELb0E' in name}
    print('wcsph_pair, pair phases of one eval of %s float32 (the pack '
          'included): kernel %.3f ms eager, %.3f ms in a graph, plain torch '
          '%.3f ms; bound %.4f ms (%s); %d candidates, %d pairs; registers '
          'and spill bytes (stores, loads) of its open-grid kernels: %s' % ((
              label, eager, ms, plain_ms) + roofline.bound(work) + (
              work['candidates'], work['pairs'], resources)), flush=True)
    del calls
    runs[label, 'reuse'] = _drive(label, time_chunks.PATHS[label],
                                  ((wp.wcsph_pair, 3, 6),), 1)
    kernels['wcsph_pair C4'] = dict(_entry(
        'wcsph_pair', 'pysph_tpu/ops/resident.py:645',
        runs[label, 'reuse']['launches']['wcsph_pair'], err, ms, plain_ms,
        work, None, eager_ms=eager, resources=resources,
        path='%s, one eval (3 launches)' % label), name='wcsph_pair C4')


def _dense_delta_phase():
    """dam_break_3d ``--engine dense --delta-sph`` at dx=0.02 in float32:
    the delta-SPH groups on the torch pair engine, the boundary's on
    ``dense_pair``, for its 50 damped steps and 3 chunks, per step and in
    captured chunks, with ms/step both ways; in the chunked run the
    capacities are cut to half before the first chunk, so that it
    overflows and is redone: grown, captured again, replayed from the
    state before it (1 + redos captures, 3 + redos replays).  Returns
    {ms: {chunk steps: ms/step}, rebuilds: {chunk steps: binnings},
    counters: the chunked run's solver counters}."""
    label = 'dam_break_3d dx=0.02 dense delta'
    steps = 80
    ms, rebuilds, counters = {}, {}, {}
    for k in (1, 10):
        app = make_app(0.02, torch.float32, steps=steps, engine='dense',
                       extra=('--delta-sph',))
        s = app.solver
        if k == 10:
            run_chunk = s._run_chunk

            def cut_first():
                if s.count == s.n_damp and not s.redos:
                    for cap in s.grid.pair_caps.values():
                        cap.candidates //= 2
                        cap.pairs //= 2
                run_chunk()
            s._run_chunk = cut_first
        bodies = _chunk_launches(s, [dp.dense_pair])
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ms[k], samples = time_chunks.timed_solve(app, k)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        rebuilds[k] = s.rebuilds
        caps = {'%s<-%s' % key: (c.candidates, c.pairs)
                for key, c in s.grid.pair_caps.items()}
        print('%s, chunk_steps=%d: median %.3f ms/step (min %.3f, max %.3f '
              'over %d samples); %d captures, %d replays, %d redos, %d '
              'reads; capacities (candidates, pairs) %s; engines %s; peak '
              'device memory %.1f MiB' % (
                  label, k, ms[k], min(samples), max(samples), len(samples),
                  s.captures, s.replays, s.redos, s.reads, caps,
                  s.acceleration_evals[0].engine_choices, peak), flush=True)
        if 'torch' not in s.acceleration_evals[0].engine_choices.values() \
                or s.count != steps:
            raise AssertionError('%s: no torch engine dest, or %d steps'
                                 % (label, s.count))
        if k == 10:
            captured = [c for it, c, cap in bodies if cap]
            if not (s.redos >= 1 and
                    s.captures == 1 + s.redos + s.grid.grows and
                    len(captured) == s.captures and
                    s.replays == 3 + s.redos):
                raise AssertionError('%s: %d captures, %d replays, %d redos '
                                     'in chunks' % (label, s.captures,
                                                    s.replays, s.redos))
            counters = dict(captures=s.captures, replays=s.replays,
                            redos=s.redos, reads=s.reads, chunk_steps=10)
        for name, st in s.states.items():
            for p, v in st.items():
                if v.is_floating_point() and \
                        not bool(torch.isfinite(v).all()):
                    raise AssertionError('non-finite %s.%s' % (name, p))
        del app, s
    print('%s: %.3f ms/step per step (eager), %.3f in captured chunks '
          '(%.2fx)' % (label, ms[1], ms[10], ms[1] / ms[10]), flush=True)
    return dict(ms=ms, rebuilds=rebuilds, counters=counters, steps=steps)


def _rhodiv(solver):
    rhodiv = solver.states['fluid']['rhodiv']
    if bool((rhodiv == -float('inf')).any()):
        raise AssertionError('rhodiv holds -inf')
    print('fluid rhodiv: %d inf, %d nan of %d (a boundary neighbour, whose '
          'rho0 is 0)' % (int(torch.isinf(rhodiv).sum()),
                          int(torch.isnan(rhodiv).sum()), rhodiv.numel()))


def _fused_check(nx, dtype):
    """``fused_continuity_momentum`` on the perturbed drop at ``nx``
    with CubicSpline: the kernel against its plain version (timed in
    float32), then, with its launches counted, m times its rates
    against ``wcsph_pair``'s Continuity + Momentum on the same state
    (pre = 0).  Returns (launches, max abs err, and in float32 the
    times and work)."""
    st, cells, grid, kw, app = fused_call(nx, dtype)
    n = st['x'].shape[0]
    tol = TOL[dtype]
    label = 'fused_pair nx=%d %s (%d particles)' % (nx, str(dtype)[6:], n)
    _check_pack(label, [fp.pack(st, cells)], [fp.pack_reference(st, cells)])
    got = fp.fused_continuity_momentum(st, cells, grid, **kw)
    ref = fp.fused_continuity_momentum_reference(st, cells, grid, **kw)
    torch.cuda.synchronize()
    worst = worst_scaled = 0.0
    for name, g, r in zip(('arho', 'au', 'av', 'aw'), got, ref):
        d = float((g - r).abs().max())
        scale = max(float(r.abs().max()), 1e-300)
        worst = max(worst, d)
        worst_scaled = max(worst_scaled, d / scale)
        if not d <= tol * scale:
            raise AssertionError('%s %s: error %.3g > %.1g * %.3g'
                                 % (label, name, d, tol, scale))
    print('compare %s: kernel against plain, max abs err %.3g, max scaled '
          'err %.3g (tol %.0e)' % (label, worst, worst_scaled, tol),
          flush=True)
    timed = None
    if dtype == torch.float32:
        timed = dict(
            eager_ms=events_ms(lambda: fp.fused_continuity_momentum(
                st, cells, grid, **kw), 20),
            ms=graph_ms(lambda: fp.fused_continuity_momentum(
                st, cells, grid, **kw), 20),
            plain_ms=events_ms(lambda: fp.fused_continuity_momentum_reference(
                st, cells, grid, **kw), 3),
            work=roofline.fused_work(st, cells, grid))
        print('fused_pair at nx=%d float32: kernel %.3f ms eager, %.3f ms '
              'in a graph, plain torch %.3f ms' % (
                  nx, timed['eager_ms'], timed['ms'], timed['plain_ms']),
              flush=True)

    # the drop's Continuity + Momentum rates through the fused kernel,
    # against wcsph_pair with the same kernel on the same cells (the
    # fused kernel's viscosity takes a fixed c0, wcsph_pair's the mean
    # of the pair's sound speeds, which TaitEOS set from rho)
    terms = wp.CONT | wp.MOM
    ps = PairSource('fluid', terms, c0=app.co, alpha=app.alpha, beta=0.0)
    pre = {p: torch.zeros_like(st['x']) for p in wp.outputs_for(terms)}
    st = dict(st, cs=torch.full_like(st['x'], app.co))
    fp.fused_continuity_momentum.launches = 0
    rates = fp.fused_continuity_momentum(st, cells, grid, **kw)
    torch.cuda.synchronize()
    launches = fp.fused_continuity_momentum.launches
    if launches != 1:
        raise AssertionError('fused_pair launched %d times' % launches)
    want = wp.wcsph_pair(st, cells, None, pre, [(st, cells, ps)], grid,
                         CubicSpline(dim=2))
    torch.cuda.synchronize()
    m = st['m']
    for name, r in zip(('arho', 'au', 'av', 'aw'), rates):
        d = float((m * r - want[name]).abs().max())
        scale = max(float(want[name].abs().max()), 1e-300)
        if not d <= tol * scale:
            raise AssertionError('%s: m * %s against wcsph_pair: %.3g > '
                                 '%.1g * %.3g' % (label, name, d, tol, scale))
    print('%s: m x rates against wcsph_pair CONT|MOM within %.0e scaled'
          % (label, tol), flush=True)
    return launches, worst, timed


def _candidates(solver):
    """Stencil candidates of the drop's fluid on the solver's grid."""
    cells = solver.grid.bin_all(solver.states)['fluid']
    return roofline.stencil(solver.grid, cells, cells)[0]


def _physics_gate():
    """The drop at nx=40 in float64 to tf=0.0076 on the dense engine:
    max |y| against the exact semi-major axis (3%), post_process through
    the ported load, and the cell grid grown with the drop."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = tempfile.mkdtemp(prefix='elliptical_drop_', dir=build.BUILD_DIR)
    try:
        app = EllipticalDrop()
        app.setup(['--nx', '40', '--use-double', '--device', 'cuda',
                   '--engine', 'dense', '-q', '-d', out])
        s = app.solver
        dims, first = s.grid.dims, _candidates(s)
        start = time.perf_counter()
        app.solve()
        secs = time.perf_counter() - start
        last = _candidates(s)
        print('elliptical_drop nx=40: the cell grid grew %d times, %s -> '
              '%s; stencil candidates %d at the start, %d at the end '
              '(%.3gx; bar 2x); %d chunk captures, %d replays, %d reads'
              % (s.grid.grows, dims, s.grid.dims, first, last, last / first,
                 s.captures, s.replays, s.reads), flush=True)
        if s.grid.grows < 1 or last > 2 * first:
            raise AssertionError('the drop\'s cell grid did not grow with '
                                 'it')
        # a grow after the first capture captures the chunk again
        if not 2 <= s.captures <= 1 + s.grid.grows:
            raise AssertionError('%d captures for %d grows'
                                 % (s.captures, s.grid.grows))
        y = s.states['fluid']['y']
        if not bool(torch.isfinite(y).all()):
            raise AssertionError('the drop has non-finite positions')
        computed = float(y.abs().max())
        exact = 1.0 / exact_solution(s.t)[0]
        err = abs(computed - exact) / exact
        print('elliptical_drop nx=40 float64 dense: t=%.6g after %d steps '
              '(%.1f s); max|y| %.5f, exact semi-major axis %.5f, error '
              '%.2f%% (bar 3%%); %d dump files' % (
                  s.t, s.count, secs, computed, exact, 100 * err,
                  len(app.output_files)), flush=True)
        if not (abs(s.t - 0.0076) < 1e-12 and err < 0.03):
            raise AssertionError('the drop missed the exact semi-major axis')
        result = app.post_process(app.info_filename)
        if not (result and np.isfinite(result['a_num'])):
            raise AssertionError('post_process gave %r' % (result,))
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _entry(name, replaces, launches, err, ms, plain_ms, work, library_ms,
           **extra):
    """One kernel of the JSON line, with its bound from ``work``."""
    bound_ms, bound_by = roofline.bound(work)
    return dict(name=name, route='cuda',
                source='pysph_tpu_torch/csrc/%s.cu' % name,
                replaces=replaces, launches=launches, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, **extra,
                work=work)


def _calls_work(calls, count):
    return roofline.add(*[count(*c[3]) for c in calls])


def _check_close(label, got, ref):
    """Max abs error of ``got`` against ``ref``, within 1e-4 of
    max|ref| (float32 sums in another order)."""
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= TOL[torch.float32] * scale:
        raise AssertionError('%s: error %.3g > %.0e * %.3g'
                             % (label, err, TOL[torch.float32], scale))
    return err


def _micro_launch_phase():
    """``micro_launch`` against its plain version on the tool's nine
    cases (seeded inputs); the tool's run with the launches counted;
    the fluid dest phase case timed beside its plain version and
    ``embedding_bag``."""
    worst = 0.0
    for label, progs, views, tz, lanes, planes in tool_launch.CASES:
        src = tool_launch.make_src(tz, lanes, planes, 'cuda', seed=21)
        worst = max(worst, _check_close(
            'micro_launch ' + label, micro.micro_launch(src, progs, views),
            micro.micro_launch_reference(src, progs, views)))
    print('compare micro_launch, nine cases: max abs err %.3g (tol 1e-4 '
          'scaled)' % worst, flush=True)
    micro.micro_launch.launches = 0
    rows = tool_launch.main()
    torch.cuda.synchronize()
    launches = micro.micro_launch.launches
    if launches == 0:
        raise AssertionError('the micro_launch tool launched no kernel')
    label, progs, views, tz, lanes, planes = tool_launch.CASES[3]
    src = tool_launch.make_src(tz, lanes, planes, 'cuda', seed=21)
    n_blocks = src.shape[0]
    bags = (micro.launch_map(progs, views, n_blocks, 'cuda')[:, :, None] *
            planes + torch.arange(planes, device='cuda')).reshape(progs, -1)
    weight = src.view(n_blocks * planes, tz * lanes)

    def library():
        return torch.nn.functional.embedding_bag(bags, weight, mode='sum')

    _check_close('embedding_bag', library().view(progs, 1, tz, lanes)[
        ..., :micro.OUT_LANES], micro.micro_launch_reference(src, progs,
                                                             views))
    plain_ms = events_ms(
        lambda: micro.micro_launch_reference(src, progs, views), 5)
    library_ms = events_ms(library, 20)
    print('micro_launch %s: kernel %.4f ms (graph), plain torch %.4f ms, '
          'embedding_bag (every lane) %.4f ms' % (
              label, rows[3]['kernel_ms'], plain_ms, library_ms), flush=True)
    return _entry('micro_launch', 'tools_dev/micro_launch.py:39', launches,
                  worst, rows[3]['kernel_ms'], plain_ms,
                  roofline.micro_launch_work(src, progs, views), library_ms,
                  case=label, eager_ms=rows[3]['eager_ms'],
                  graph_ms=rows[3]['graph_ms'])


def _micro_engine_phase():
    """``micro_engine`` against its plain version on ``fluid-full`` with
    ``dyn_maps`` both ways and 9 and 3 views (seeded inputs); the tool's
    run with the launches counted."""
    worst = 0.0
    for dyn_maps in (True, False):
        for n_views in (9, 3):
            _, args, kw = tool_engine.make_case('fluid-full', 'cuda', seed=22)
            kw.update(dyn_maps=dyn_maps, n_views=n_views)
            worst = max(worst, _check_close(
                'micro_engine fluid-full %s' % kw,
                micro.micro_engine(*args, **kw),
                micro.micro_engine_reference(*args, **kw)))
    print('compare micro_engine fluid-full, dyn_maps both ways, 9 and 3 '
          'views: max abs err %.3g (tol 1e-4 scaled)' % worst, flush=True)
    micro.micro_engine.launches = 0
    rows = tool_engine.main([])
    torch.cuda.synchronize()
    launches = micro.micro_engine.launches
    if launches == 0:
        raise AssertionError('the micro_engine tool launched no kernel')
    _, args, kw = tool_engine.make_case('fluid-full', 'cuda', seed=22)
    plain_ms = events_ms(lambda: micro.micro_engine_reference(*args, **kw),
                         5)
    row = rows[0]
    print('micro_engine fluid-full: kernel %.4f ms (graph), plain torch '
          '%.4f ms' % (row['kernel_ms'], plain_ms), flush=True)
    return _entry('micro_engine', 'tools_dev/micro_engine.py:69', launches,
                  worst, row['kernel_ms'], plain_ms,
                  roofline.micro_engine_work(*args, **kw), None,
                  case='fluid-full', eager_ms=row['eager_ms'],
                  graph_ms=row['graph_ms'])


def _sass_counts(lib, opcode):
    """{kernel function: SASS lines holding ``opcode``} of a library."""
    cuobjdump = Path(build.nvcc()).with_name('cuobjdump')
    sass = subprocess.run([str(cuobjdump), '-sass', str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if 'Function :' in line:
            name = line.split(':', 1)[1].strip()
            counts[name] = 0
        elif name is not None and opcode in line:
            counts[name] += 1
    return counts


def _sass_loads(lib):
    """{stub mode: global loads (LDG) in the float kernel's SASS}."""
    counts = _sass_counts(lib, 'LDG')
    return {mode: next(v for k, v in counts.items()
                       if 'pair_stub_kernelIfLi%dE' % k_mode in k)
            for k_mode, mode in enumerate(stub.MODES)}


def _check_pack(label, copies, refs):
    """The pack kernel's copies against its plain version's: exactly
    equal."""
    torch.cuda.synchronize()
    for k, (got, ref) in enumerate(zip(copies, refs)):
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError('%s: the packed copy of source %d differs '
                                 'from its plain version' % (label, k))


def _walk_cases(dense_lib):
    """``wcsph_pair``, ``dense_pair`` and the pack against their plain
    versions on the walk's edge cases (``tools_dev/walk_cases.py``: a
    clamped cell longer than a stage, a 2D grid, four sources, write
    masks, an empty dest array) in float64 and float32; then the bulk
    copy in ``dense_pair``'s SASS."""
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        for case in walk_cases.CASES:
            args = walk_cases.make_case(case, 'cuda', dtype, seed=31)
            _check_pack('walk case ' + case, wp.pack_sources(args[4]),
                        wp.pack_sources_reference(args[4]))
            for op in (wp.wcsph_pair, dp.dense_pair):
                try:
                    worst = max(worst, walk_cases.check_kernel(
                        op, args, TOL[dtype]))
                except AssertionError as e:
                    raise AssertionError('walk case %s %s: %s'
                                         % (case, str(dtype)[6:], e)) from e
    print('compare wcsph_pair, dense_pair on the walk cases %s, float64 and '
          'float32: max scaled err %.3g (tol 1e-10, 1e-04); the pack exact'
          % (walk_cases.CASES, worst), flush=True)
    copies = {k: v for k, v in _sass_counts(dense_lib, 'UBLKCP').items()
              if 'dense_pair_kernel' in k}
    print('dense_pair SASS bulk copies (UBLKCP) by kernel: %s'
          % sorted(copies.values()))
    if not copies or min(copies.values()) == 0:
        raise AssertionError('dense_pair compiled without the bulk copy: %s'
                             % copies)


def _pair_stub_phase(lib):
    """``pair_stub`` in every mode on dam_break_3d dx=0.02's calls: exact
    zeros (pre set to 7), global loads in the SASS of every mode but
    ``none``, each mode timed; then the prof tools' run with the
    launches counted."""
    calls, n = pair_calls(0.02, torch.float32)
    calls = [c[:3] + (c[3][:3] + ({p: torch.full_like(v, 7.0) for p, v in
                                   c[3][3].items()},) + c[3][4:],)
             for c in calls]
    for mode in stub.MODES:
        for _, dest, _, args in calls:
            out = stub.pair_stub(*args, mode=mode)
            torch.cuda.synchronize()
            if not all(bool((v == 0).all()) for v in out.values()):
                raise AssertionError('pair_stub %s wrote a non-zero to %s'
                                     % (mode, dest))
    print('compare pair_stub, every mode, dam_break_3d dx=0.02 (%d '
          'particles): exact zeros' % n, flush=True)
    loads = _sass_loads(lib)
    print('pair_stub float SASS global loads by mode: %s' % loads)
    if not (loads['none'] == 0 < loads['dest'] < loads['all'] and
            loads['third'] > loads['dest']):
        raise AssertionError('pair_stub: the compiler dropped loads: %s'
                             % loads)
    times = {}
    for mode in stub.MODES:
        times[mode] = graph_ms(lambda: [stub.pair_stub(*c[3], mode=mode)
                                        for c in calls], 20)
        work = _calls_work(calls, functools.partial(roofline.stub_work,
                                                    mode))
        print('pair_stub %-5s one eval (3 launches): %.4f ms (graph); %.4g '
              'candidates, %.4g B, bound %.4f ms (%s)' % (
                  (mode, times[mode], work['candidates'], work['bytes']) +
                  roofline.bound(work)), flush=True)
    if not times['all'] > times['none']:
        raise AssertionError('pair_stub all (%.4f ms) is not slower than '
                             'none (%.4f ms)' % (times['all'],
                                                 times['none']))
    plain_ms = events_ms(lambda: [stub.pair_stub_reference(*c[3])
                                  for c in calls], 20)
    work = _calls_work(calls, functools.partial(roofline.stub_work, 'all'))
    del calls

    stub.pair_stub.launches = 0
    prof_dma.main(0.02)
    prof_phases.main(0.02)
    torch.cuda.synchronize()
    launches = stub.pair_stub.launches
    if launches == 0:
        raise AssertionError('the prof tools launched no pair_stub')
    print('pair_stub launches in the prof_dma and prof_phases runs: %d'
          % launches, flush=True)
    return _entry('pair_stub', 'tools_dev/prof_dma.py:105', launches, 0.0,
                  times['all'], plain_ms, work, None,
                  also_replaces='tools_dev/prof_phases.py:86', mode='all',
                  mode_ms=times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs an NVIDIA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print('torch %s, CUDA %s, device %s' % (torch.__version__,
                                            torch.version.cuda, kind))

    t0 = time.perf_counter()
    laps = [t0]

    def lap(label):
        """Print the seconds since the last lap: the time each phase
        takes of the script's limit."""
        laps.append(time.perf_counter())
        print('phase %s: %.1f s (%.1f s since the builds began)' % (
            label, laps[-1] - laps[-2], laps[-1] - t0), flush=True)

    names = ('gsph_pair', 'crksph_pair', 'iisph_pair', 'iisph_solve',
             'crk_solve', 'tsph_pair',
             'gasd_pair', 'adke_pair', 'tvf_pair',
             'wcsph_pair',
             'gtvf_pair', 'dense_pair', 'fused_pair', 'micro_launch',
             'micro_engine', 'pair_stub', 'cell_pack', 'bin_cells',
             'delta_pair')
    # and each later kind's library of the pair kernels that take kinds
    jobs = [(n, ()) for n in names] + [('tvf_pair', tp.EDAC_FLAGS)] + [
        (n, build.kind_flags(k)) for n in KIND_KERNELS
        for k in range(build.BASE_KINDS, build.KINDS)]

    def timed_build(job):
        t = time.perf_counter()
        return build.build(*job), time.perf_counter() - t

    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(timed_build, jobs)))
    libs = {n: built[n, ()][0] for n in names}
    print('built %d libraries in %.1f s, all at once (%d nvcc in parallel); '
          'each one\'s seconds: %s' % (
              len(jobs), time.perf_counter() - t0, len(jobs), ', '.join(
                  '%s%s %.1f' % (n, ''.join(' ' + f for f in extra), sec)
                  for (n, extra), (_, sec) in built.items())), flush=True)
    for lib, _ in built.values():
        print(lib.with_suffix('.log').read_text().strip(), flush=True)
    lap('build')
    kernels = {}

    # wcsph_pair against its plain version
    for dx, dtype in ((0.04, torch.float64), (0.04, torch.float32)):
        calls, n = pair_calls(dx, dtype)
        _compare(calls, dtype, 'wcsph_pair dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = pair_calls(0.02, torch.float32)
    wcsph_err = _compare(calls, torch.float32, 'wcsph_pair dx=0.02 float32 '
                         '(%d particles)' % n)
    wcsph_eager = events_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    wcsph_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    wcsph_plain_ms = events_ms(
        lambda: [c[2].reference(*c[3]) for c in calls], 3)
    wcsph_work = _calls_work(calls, roofline.wcsph_work)
    print('wcsph_pair, pair phases of one eval at dx=0.02 float32 (the pack '
          'included): kernel %.3f ms eager, %.3f ms in a graph, plain torch '
          '%.3f ms; %d candidates, %d visited' % (
              wcsph_eager, wcsph_ms, wcsph_plain_ms,
              wcsph_work['candidates'], wcsph_work['visited']), flush=True)
    # the source pack of each call: exact, and timed alone
    for _, dest, _, args in calls:
        _check_pack('dam_break_3d dx=0.02 ' + dest, wp.pack_sources(args[4]),
                    wp.pack_sources_reference(args[4]))
    pack_ms = graph_ms(lambda: [wp.pack_sources(c[3][4]) for c in calls], 20)
    pack_eager = events_ms(
        lambda: [wp.pack_sources(c[3][4]) for c in calls], 20)
    pack_plain_ms = events_ms(
        lambda: [wp.pack_sources_reference(c[3][4]) for c in calls], 20)
    pack_work = roofline.add(*[roofline.pack_work(c[3][4]) for c in calls])
    print('pack_sources, the 3 calls of one eval at dx=0.02 float32: exact; '
          '%.4f ms in a graph, %.4f eager, plain torch %.4f ms; %d B'
          % (pack_ms, pack_eager, pack_plain_ms, pack_work['bytes']),
          flush=True)
    del calls
    _engines_agree('dam_break_3d', 0.04, 10,
                   ('x', 'y', 'z', 'u', 'v', 'w', 'rho', 'p'))

    # the chunks: captured against per-step in float64 on each path
    for case in time_chunks.GATES:
        print('chunk gate: %s' % json.dumps(time_chunks.gate(case)),
              flush=True)

    lap('wcsph_pair checks and chunk gates')
    # the later kinds in every pair kernel that takes kinds
    _kinds_phase()
    lap('kinds')

    # the main path, under both binning configurations: 3 launches in the
    # initial eval, 6 a step; the reuse test once a step (reuse) or at
    # both evals (every eval)
    runs, bins = {}, {}
    label = MAIN = 'dam_break_3d dx=0.02'
    for config, (every, _) in time_chunks.CONFIGS.items():
        runs[label, config] = _drive(
            label, time_chunks.PATHS[label], ((wp.wcsph_pair, 3, 6),),
            2 if every else 1, config=config,
            checks=() if every else (functools.partial(
                _bin_phase, label, out=bins),))
    main_run = runs[MAIN, 'reuse']
    if main_run['particles'] != 143051:
        raise AssertionError('dam_break_3d at dx=0.02 has %d particles, '
                             'not 143,051' % main_run['particles'])
    wcsph_launches = pack_launches = main_run['launches']['wcsph_pair']
    kernels['wcsph_pair'] = _entry(
        'wcsph_pair', 'pysph_tpu/ops/resident.py:645', wcsph_launches,
        wcsph_err, wcsph_ms, wcsph_plain_ms, wcsph_work, None,
        eager_ms=wcsph_eager, path='dam_break_3d dx=0.02, one eval')
    kernels['cell_pack'] = dict(_entry(
        'cell_pack', 'pysph_tpu/ops/resident.py:331', pack_launches, 0.0,
        pack_ms, pack_plain_ms, pack_work, None, eager_ms=pack_eager,
        path='dam_break_3d dx=0.02, the 3 calls of one eval'),
        source='pysph_tpu_torch/csrc/cell_pack.cuh',
        note='the source pack, launched by the walks\' launch functions; '
        'its JAX counterpart, build_pack, is an XLA gather, not a '
        'pallas_call')
    main_bin = bins[MAIN][0]
    kernels['bin_cells'] = dict(_entry(
        'bin_cells', 'pysph_tpu/sph/acceleration_eval.py:857',
        main_run['bin_launches'], 0.0, main_bin['rebuilt_ms'],
        main_bin['plain_ms'], main_bin['rebuilt_work'], None,
        kept_ms=main_bin['kept_ms'],
        kept_bound_ms=roofline.bound(main_bin['kept_work'])[0],
        sort_library_ms=main_bin['sort_ms'],
        path='dam_break_3d dx=0.02 after %d steps, one eval rebuilt (ms) '
        'and kept (kept_ms); sort_library_ms: torch.sort(cid, stable=True) '
        'on its cell ids, the nearest PyTorch call to its sort' % STEPS),
        note='the binning and its reuse test, one call of six gated '
        'kernels; its JAX counterpart, prepare_reuse and prepare, is XLA '
        'ops under a lax.cond, not a pallas_call')
    lap('dam_break_3d')
    _c4_phase(runs, kernels)
    _delta_phase(runs, kernels)
    dense_delta = _dense_delta_phase()
    lap('C4 and delta-SPH')

    # gtvf_pair against its plain version
    for dx, dtype in ((0.02, torch.float64), (0.02, torch.float32)):
        calls, n = gtvf_calls(dx, dtype)
        _compare(calls, dtype, 'gtvf_pair dx=%g %s (%d particles)'
                 % (dx, str(dtype)[6:], n))
    calls, n = gtvf_calls(0.004, torch.float32)
    gtvf_err = _compare(calls, torch.float32, 'gtvf_pair dx=0.004 float32 '
                        '(%d particles)' % n)
    for k, dest, _, args in calls:
        _check_pack('GTVF dx=0.004 eval %d %s' % (k, dest),
                    gp.pack_sources(args[4]),
                    gp.pack_sources_reference(args[4]))
    print('cell_pack, the GTVF planes of the 5 calls: exact', flush=True)
    gtvf_eager = gtvf_plain_ms = 0.0
    for k in (0, 1):
        mine = [c for c in calls if c[0] == k]
        kms = events_ms(lambda: [c[2].op(*c[3]) for c in mine], 20)
        pms = events_ms(lambda: [c[2].reference(*c[3]) for c in mine], 3)
        print('gtvf_pair, pair phases of eval %d (%d launches) at dx=0.004 '
              'float32: kernel %.3f ms, plain torch %.3f ms'
              % (k, len(mine), kms, pms), flush=True)
        gtvf_eager += kms
        gtvf_plain_ms += pms
    gtvf_ms = graph_ms(lambda: [c[2].op(*c[3]) for c in calls], 20)
    gtvf_work = _calls_work(calls, roofline.gtvf_work)
    print('gtvf_pair, both evals (5 launches) at dx=0.004 float32: %.3f ms '
          'in a graph' % gtvf_ms, flush=True)
    del calls, mine
    _engines_agree('GTVF dam_break_2d', 0.02, 10,
                   ('x', 'y', 'u', 'v', 'rho', 'p', 'sigma', 'rhodiv',
                    'au', 'auhat', 'V'), cls=DamBreak2D,
                   extra=('--scheme', 'gtvf'))

    # the GTVF path: 2 launches in the initial eval (eval 0), 5 a step; a
    # reuse test for each evaluator a step either way (eval 0 keeps the
    # step's neighbours)
    label = 'GTVF dx=0.004'
    for config, (every, _) in time_chunks.CONFIGS.items():
        runs[label, config] = _drive(
            label, time_chunks.PATHS[label], ((gp.gtvf_pair, 2, 5),), 2,
            skip_finite=('rhodiv',), config=config,
            checks=(_rhodiv,) + (() if every else (functools.partial(
                _bin_phase, label, out=bins),)))
    gtvf_launches = runs[label, 'reuse']['launches']['gtvf_pair']
    kernels['gtvf_pair'] = _entry(
        'gtvf_pair', 'pysph_tpu/ops/pallas_engine.py:1160', gtvf_launches,
        gtvf_err, gtvf_ms, gtvf_plain_ms, gtvf_work, None,
        eager_ms=gtvf_eager, path='GTVF dx=0.004, both evals of a step')

    # the 2D WCSPH dam break (PEC) and the other integrators
    lap('GTVF')
    _wcsph2d_phase(runs, kernels, bins)
    _integrators_phase()
    lap('2D WCSPH and the integrators')

    # the Taylor-Green vortex on its periodic box
    _tvf_phase(runs, kernels, bins)
    for run in TG_RUNS:
        _tg_scheme_phase(runs, kernels, run)

    # the Adami walls on tvf_pair and the TVF wall examples
    lap('Taylor-Green')
    _tvf_wall_phase(runs, kernels, bins)
    lap('TVF walls')

    # EDAC: taylor_green, cavity and dam_break_2d --scheme edac, and
    # gtvf_pair's later kind at the Taylor-Green vortex's full width
    _edac_phase(runs, kernels)
    _kinds_row()
    lap('EDAC')

    # IISPH: taylor_green, elliptical_drop and dam_break_2d --scheme iisph
    iisph_runs = _iisph_phase(kernels)
    lap('IISPH')

    # gas dynamics: the shock tube and the Sedov blast under GasDScheme
    gasd_run, gasd_step, gasd_bins = _gasd_phase(kernels)
    lap('GasDScheme')
    # GSPHScheme and ADKEScheme: the accuracy test, the hydrostatic box and
    # the shock tube
    gsph_run, gsph_step, adke_chunks, adke_step = _gas_schemes_phase(
        kernels)
    lap('GSPHScheme and ADKEScheme')
    # CRKSPHScheme: the accuracy test, the hydrostatic box and Taylor-Green
    crk_run, crk_step = _crksph_phase(kernels)
    lap('CRKSPHScheme')
    # TSPHScheme: the accuracy test, the hydrostatic box, Sedov and
    # Cheng-Shu
    tsph_run, tsph_step = _tsph_phase(kernels)
    lap('TSPHScheme')

    # wcsph_pair (Gaussian) and dense_pair against their plain version on
    # the perturbed drop; dense_pair also on dam_break_3d's calls
    timed = {}     # the float32 calls at the paths' shapes
    for nx, dtype in ((40, torch.float64), (200, torch.float32)):
        calls, n, _ = drop_calls(nx, dtype)
        label = 'nx=%d %s (%d particles)' % (nx, str(dtype)[6:], n)
        _compare(calls, dtype, 'wcsph_pair Gaussian drop ' + label)
        dense_err = _compare(calls, dtype, 'dense_pair drop ' + label,
                             dp.dense_pair)
    timed['drop nx=200'] = calls
    for dx, dtype in ((0.04, torch.float64), (0.02, torch.float32)):
        calls, n = pair_calls(dx, dtype)
        _compare(calls, dtype, 'dense_pair dam_break_3d dx=%g %s (%d '
                 'particles)' % (dx, str(dtype)[6:], n), dp.dense_pair)
    timed['dam_break_3d dx=0.02'] = calls
    # the same calls on cells 1.001 times the support (bin_every_eval's)
    timed['drop nx=200, cells 1.001'] = drop_calls(
        200, torch.float32, cell_slack=1.001)[0]
    timed['dam_break_3d dx=0.02, cells 1.001'] = pair_calls(
        0.02, torch.float32, cell_slack=1.001)[0]
    _walk_cases(libs['dense_pair'])
    times = {}
    for label, calls in timed.items():
        times[label] = t = {}
        for name, op in (('dense_pair', dp.dense_pair),
                         ('wcsph_pair', wp.wcsph_pair),
                         ('plain', wp.wcsph_pair_reference)):
            reps = 3 if name == 'plain' else 20
            t[name] = events_ms(lambda: [op(*c[3]) for c in calls], reps)
            if name != 'plain':
                t[name + ' graph'] = graph_ms(
                    lambda: [op(*c[3]) for c in calls], 20)
        t['work'] = _calls_work(calls, roofline.wcsph_work)
        print('pair phases of one eval, %s float32 (%d launches, the pack '
              'included): dense_pair %.3f ms eager, %.3f in a graph; '
              'wcsph_pair %.3f ms eager, %.3f in a graph; plain torch %.3f '
              'ms; bound %.4f ms (%s); %d candidates, %d visited (both '
              'walks)' % (
                  (label, len(calls), t['dense_pair'], t['dense_pair graph'],
                   t['wcsph_pair'], t['wcsph_pair graph'], t['plain']) +
                  roofline.bound(t['work']) +
                  (t['work']['candidates'], t['work']['visited'])),
              flush=True)
        tiles = passes = 0
        for c in calls:
            a, b = cell_walk.dense_passes(c[3][5], c[3][1])
            tiles, passes = tiles + a, passes + b
        print('  %s: cells %g times the support, %s; dense_pair %d tiles '
              'holding dests, %d passes (%.3f a tile)' % (
                  label, calls[0][3][5].cell_slack, calls[0][3][5].dims,
                  tiles, passes, passes / max(tiles, 1)), flush=True)
    del timed, calls

    # fused_continuity_momentum on the drop's state
    fused_launches = 0
    for dtype in (torch.float64, torch.float32):
        k, fused_err, fused = _fused_check(200, dtype)
        fused_launches += k
    kernels['fused_pair'] = _entry(
        'fused_pair', 'pysph_tpu/ops/pallas_pair.py:47', fused_launches,
        fused_err, fused['ms'], fused['plain_ms'], fused['work'], None,
        eager_ms=fused['eager_ms'], path='drop nx=200 state, one call')

    # the elliptical drop on both engines: 1 launch in the initial eval,
    # 2 a step; the binning checked on the kernel engine's run
    for engine, op in (('kernel', wp.wcsph_pair), ('dense', dp.dense_pair)):
        label = 'drop nx=200 ' + engine
        for config, (every, _) in time_chunks.CONFIGS.items():
            runs[label, config] = run = _drive(
                label, time_chunks.PATHS[label], ((op, 1, 2),),
                2 if every else 1, engine=engine, config=config,
                checks=(functools.partial(_bin_phase, label, out=bins),)
                if engine == 'kernel' and not every else ())
            if run['particles'] != 125623:
                raise AssertionError('the drop at nx=200 has %d particles, '
                                     'not 125,623' % run['particles'])
    dense_launches = runs['drop nx=200 dense', 'reuse']['launches'][
        'dense_pair']
    drop = times['drop nx=200']
    kernels['dense_pair'] = _entry(
        'dense_pair', 'pysph_tpu/ops/pallas_engine.py:574', dense_launches,
        dense_err, drop['dense_pair graph'], drop['plain'],
        drop['work'], None, eager_ms=drop['dense_pair'],
        path='drop nx=200, one eval')

    lap('the drop, dense_pair and fused_pair')
    _physics_gate()

    # the probes and the stub: the tools' paths
    kernels['micro_launch'] = _micro_launch_phase()
    kernels['micro_engine'] = _micro_engine_phase()
    kernels['pair_stub'] = _pair_stub_phase(libs['pair_stub'])
    lap('the physics gate, the probes and the stub')

    print('ms/step in this run, float32, per step / in chunks of 10, and '
          'binnings a 100 steps per step / in chunks, by binning '
          'configuration (captures, replays, reads of the chunked %d-step '
          'run):' % STEPS)
    for (label, config), r in runs.items():
        print('  %-22s %-10s %8.3f / %8.3f ms/step  %6.1f / %6.1f  (%s)' % (
            label, config, r['ms'][1], r['ms'][10],
            100.0 * r['rebuilds'][1] / STEPS,
            100.0 * r['rebuilds'][10] / STEPS, r['counters']))
    r = dense_delta
    print('  %-22s %-10s %8.3f / %8.3f ms/step  %6.1f / %6.1f  (%s; %d '
          'steps: 50 damped, 3 chunks)' % (
              'dam_break_3d dx=0.02 dense delta', 'reuse', r['ms'][1],
              r['ms'][10], 100.0 * r['rebuilds'][1] / r['steps'],
              100.0 * r['rebuilds'][10] / r['steps'], r['counters'],
              r['steps']))
    print('IISPH, float32, per step / in chunks of 10 (the pressure group '
          'one iisph_solve launch an evaluation): ms/step, pressure sweeps '
          'a step (min, mean, max; the same in both runs), host reads a '
          'step, launches on the card in chunks (iisph_pair, iisph_solve), '
          'a replayed step\'s device busy ms and idle share:')
    for label, r in iisph_runs.items():
        sw = r['sweeps']
        print('  %-28s %8.3f / %8.3f ms/step  sweeps %d / %.3f / %d  reads '
              '%.3f / %.3f  launches %d, %d  busy %.4f ms, idle %.1f%%  %d '
              'steps' % (
                  label, r['per_step']['ms'], r['ms'], min(sw),
                  float(np.mean(sw)), max(sw),
                  r['per_step']['reads_per_step'], r['reads_per_step'],
                  r['launches']['iisph_pair'], r['launches']['iisph_solve'],
                  r['idle']['busy_ms'], 100 * r['idle']['idle_share'],
                  r['steps']))
    print('Sedov nx=401 float32 (a step, the initial evaluation apart), in '
          'chunks of 10 (the density sweeps gated on the card) / per step '
          '(the sweeps\' loop on the host):')
    for how, r in (('chunks', gasd_run), ('per step', gasd_step)):
        print('  %-9s %.4f ms/step; sweeps %d / %.3f / %d; host reads '
              '%.3f; launches %.3f; binnings %.3f; slots %s, redos %d; busy '
              '%.4f ms, idle share %.1f%%; largest hmax/hmin %.4f; %.1f '
              'candidates a dest; energy drift %.3g' % (
                  how, r['ms'], *r['sweeps_steps'], r['reads_per_step'],
                  r['launches_per_step'], r['binnings_per_step'], r['slots'],
                  r['redos'], r['step_busy_ms'], 100 * r['idle_share'],
                  r['hmax_hmin'], r['candidates_per_dest'],
                  r['energy_drift']))
    print('accuracy_test_2d --scheme gsph %d^2 float32 (a step), in chunks '
          'of 10 / per step:' % ACCURACY_FULL)
    for how, r in (('chunks', gsph_run), ('per step', gsph_step)):
        print('  %-9s %.4f ms/step; launches %s; host reads %.3f; busy '
              '%.4f ms, idle share %.1f%%' % (
                  how, r['ms'], r['launches_per_step'], r['reads_per_step'],
                  r['step_busy_ms'], 100 * r['idle_share']))
    print('accuracy_test_2d --scheme adke %d^2 float32 (a step), in chunks '
          'of 10 (%d steps) / per step (%d steps):' % (
              ACCURACY_FULL, STEPS, ADKE_STEPS))
    for how, r in (('chunks', adke_chunks), ('per step', adke_step)):
        print('  %-9s %.4f ms/step; launches %s; host reads %.3f; busy '
              '%.4f ms, idle share %.1f%%; device ms by layer %s' % (
                  how, r['ms'], r['launches_per_step'], r['reads_per_step'],
                  r['step_busy_ms'], 100 * r['idle_share'],
                  {k: round(v, 4) for k, v in r['layers'].items()}))
    print('accuracy_test_2d --scheme crksph %d^2 float32 (a step, two '
          'evaluators), in chunks of 10 / per step:' % ACCURACY_FULL)
    for how, r in (('chunks', crk_run), ('per step', crk_step)):
        print('  %-9s %.4f ms/step; launches %s; host reads %.3f; busy '
              '%.4f ms, idle share %.1f%%; device ms by layer %s' % (
                  how, r['ms'], r['launches_per_step'], r['reads_per_step'],
                  r['step_busy_ms'], 100 * r['idle_share'],
                  {k: round(v, 4) for k, v in r['layers'].items()}))
    print('accuracy_test_2d --scheme tsph %d^2 float32 (a step), in chunks '
          'of 10 (%d steps) / per step (%d steps):' % (
              ACCURACY_FULL, STEPS, ADKE_STEPS))
    for how, r in (('chunks', tsph_run), ('per step', tsph_step)):
        print('  %-9s %.4f ms/step; launches %s; host reads %.3f; sweeps %s; '
              'redos %d; busy %.4f ms, idle share %.1f%%; device ms by layer '
              '%s' % (
                  how, r['ms'], r['launches_per_step'], r['reads_per_step'],
                  r['sweeps'], r['redos'], r['step_busy_ms'],
                  100 * r['idle_share'],
                  {k: round(v, 4) for k, v in r['layers'].items()}))
    print('bin_cells an eval in a CUDA graph, kept / rebuilt:')
    for label, rows in bins.items():
        for i, t in enumerate(rows):
            print('  %-22s eval %d %8.4f / %8.4f ms; bound %.4f / %.4f ms; '
                  'plain %.3f ms' % (
                      label, i, t['kept_ms'], t['rebuilt_ms'],
                      roofline.bound(t['kept_work'])[0],
                      roofline.bound(t['rebuilt_work'])[0], t['plain_ms']))
    print('%-12s %8s %12s %12s %12s %12s %12s %10s %10s %8s' % (
        'kernel', 'launches', 'candidates', 'visited', 'pairs', 'flops',
        'bytes', 'bound ms', 'ms', 'share'))
    for e in kernels.values():
        w = e['work']
        print('%-12s %8d %12d %12s %12d %12d %12d %10.4f %10.4f %7.1f%% (%s)'
              % (e['name'], e['launches'], w['candidates'],
                 w.get('visited', '-'), w['pairs'], w['flops'], w['bytes'],
                 e['bound_ms'], e['ms'], 100 * e['bound_ms'] / e['ms'],
                 e['bound_by']))
    print(json.dumps({'kernels': list(kernels.values())}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.exit(main())
