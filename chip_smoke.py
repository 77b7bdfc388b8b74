#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root, one GPU

Path 1 is the node-major FEM Helmholtz room sweep at the bench shape: a P1
box mesh at n=20 (9261 nodes) in a 3-level hierarchy, 4096 wavenumbers in
[0.55, 2.2] streamed as two chunks of 2048, shifted-Laplacian V(1,1)
Jacobi multigrid (omega 1) preconditioning restarted GMRES (CGS1, restart
6, tol 1e-5), 16 Newton-Schulz-chained coarse inverses per band solve,
anchor warm starts (stride 64, cubic, restart 3).

Path 2 is the dense BEM frequency sweep at the bench shape: an icosphere
with 4 subdivisions (N=5120 triangles), order-3 quadrature (nq=4), a plane
wave along +z, 8 wavenumbers in [0.5, 3.0] in one batch, one-shot
assembly, Jacobi-preconditioned GMRES (restart 16, tol 1e-5, at most 64
iterations), complex64: rigid (double-layer kernel), then Burton–Miller
(beta = 4i/(k + 1/h); Burton–Miller kernel).

Path 3 is the single-frequency dense BEM at full width, on the same
icosphere (N=5120), complex64, through BemSolver, BemSolution and
solve_room_bem: (a) the mixed pulsating sphere at ka = 1 (velocity 1 on the
upper hemisphere, the analytic pressure on the lower), Burton–Miller,
Jacobi-GMRES at tolerance 1e-5 (the config's default 1e-8 is below what
complex64 resolves), then the field at 8192 points on r = 2; (b) the
radiating sphere at ka = 1 without Burton–Miller; (c) the rigid sphere at
ka = 2 under a plane wave with Burton–Miller, then the field at the same
points; (d) the interior cavity at ka = 1 with a central monopole, LU, then
the field at 512 interior points.

Path 4 is slice 3's biquad cascade at bench.py ``run_iir``'s shape, and
path 5 the auto-EQ path (differential evolution fitting a parametric EQ,
then the autoeq CLI and its exporters), both on the card (phases 11-12).

Path 6 is the BEM room simulator CLI (apps/roomsim_bem.py) on the card:
(a) configs/small_room.json as users run it (auto tier: 896 elements, LU,
6 frequencies, 2 listening positions); (b) configs/nearfield_stereo.json
at its own mesh resolution (10440 elements, 2 sources, rigid walls) with
the reference's ``--solver gmres``, at 8 log-spaced frequencies over its
own 40-500 Hz in place of its 100 (the one reduction). Path 7 is the BEM
QA suite (apps/qa_suite_bem.py): ``--fast``, then the 19 cases of its full
list that use no FMM (phases 13-14).

Path 8 is the single-level FMM (phase 15): bench.py's slfmm tier at its
full shape (the N=5120 icosphere, k = 8, Burton–Miller beta = i/k, a
float64 build on the card with the float32 stability screen tau = 1e4 and
float32 aggregation phases, cast to complex64 in gather form,
ClusterBlockPreconditioner, GMRES restart 48 tol 1e-5 at most 200
iterations, a plane wave along +z), the QA suite's three slfmm cases, the
roomsim CLI on configs/nearfield_stereo.json under ``auto`` (its FMM tier at
N = 10440 with the near-field ILU(0)) at 40 and 500 Hz (of its 100
frequencies: the one cut), and the FMM field evaluation at path 3's 8192
points.

Path 9 is the multilevel FMM (phase 16): bench.py's mlfmm tier at its full
shape (the N=20480 icosphere, k = 16, CBIE, the MLFMM tree with
max_per_leaf 32, a float64 build on the card with tau = 1e4 and float32
aggregation phases, cast to complex64 in gather form,
ClusterBlockPreconditioner, the cluster-major GMRES restart 36 tol 1e-5 at
most 200 iterations, a plane wave along +z), its Burton–Miller solve (beta
= i/k, unpreconditioned), the tree and the two-level MLFMM against the dense
matrices at N=5120, k = 2, the QA suite's three mlfmm cases, and the
mixed-BC tree on a pulsating sphere at N=20480.

Path 10 is the general FEM problem with its solvers (phase 17): the FEM QA
suite (apps/qa_suite_fem.py) with its 21 cases, every solver name of
fem/problem.py::solve_helmholtz on a 2400- and a 4224-node annulus and a
1458-node spherical shell, on the card in float64 and in float32 (the app's
default), and ``--fast``; and path 3 (c)'s rigid sphere (N=5120, ka = 2,
Burton–Miller, complex64) through BemSolver with BiCGStab, CGS and
QMR-CGSTAB, plus one rigid CBIE solve with BiCGStab.

Path 11 is the FEM room simulator (apps/roomsim_fem.py, phase 18): (a)
configs/small_room.json uncut (1053 nodes, 6 frequencies), flat and
``--hierarchical``, complex64; (b) configs/nearfield_stereo.json at its own
mesh resolution (37 x 33 x 25 = 30,525 nodes, 3 levels, restart 300, rigid
walls, 2 sources) with four cuts: 8 log-spaced of its 100 frequencies over
40-500 Hz, GMRES tolerance 1e-6 for its 1e-12 (below what complex64
resolves), max_iter 100 for its 10000 (1000 iterations), one batch of 8
(the automatic batch would pad the 8 frequencies to 64 lanes).

Path 12 is slice 4c, the BEM leftovers (phase 19), complex64: (a) the
all-quad cube sphere (cube_sphere(1.0, 29): 5046 bilinear quads, the 2 x 2
tensor rule, nq = 4 with weights that vary with position), a rigid sphere
under a +z plane wave through BemSolver with CBIE at ka = 1 and with
Burton–Miller at ka = 2 (Jacobi-GMRES, tol 1e-5), then the field at path
3's 8192 points; (b) the near-pair upgrade on path 3 (c)'s N=5120 icosphere
(ka = 2, Burton–Miller); (c) BemConfig JSON files through build_problem and
BemSolver: a uv_sphere of 36 x 72 and a closed cylinder of 72 x 34 (5040
triangles each); (d) an NC.inp with node and element files written from the
icosphere and parsed back. Path 13 is the rest of slice 6c, every FEM
element type: (a) P1, P2 and P3 (to_p2, to_p3) of the FEM QA suite's ka = 1
annulus (2400 / 9408 / 21,024 nodes) and spherical shell (1458 / 10,914 /
36,050 nodes) in float64 under direct, gmres_jacobi and gmres_amg (left
out where they do not fit: P_SKIP), and the Dirichlet plane-wave problems
of tests/test_fem_extras.py on a unit square (n = 16) and cube (n = 6); (b)
trilinear hexes of nearfield_stereo.json's room at its own resolution (36 x
32 x 24 cells, 30,525 nodes), walls of admittance 0.1, a Gaussian source at
its left speaker, 40 Hz, complex64, under gmres_jacobi and
gmres_shifted_laplacian; (c) PML values on the tet room mesh (165,888
tets, layers of 0.5 m on all six faces) and the absorbing strip of
tests/test_fem_extras.py; (d) uniform_refine and adaptive_refine of the
tet room mesh on the host.

Path 14 is slice 7b (phase 20), float64 on the card: the optimizer
test-function registry (105 functions and their constraints, each at its
registered width or at 10 where any width is admitted, 4096 seeded points
through ``torch.func.vmap``); run_de at the CLI's defaults (popsize 15,
maxiter 1000, tol 1e-2, best1bin) on rastrigin and rosenbrock at 10
dimensions and keanes_bump_objective (inequality constraints), and sphere
at 10 dimensions for 400 generations; benchmark_convergence -f _10d
--quick (the 46 ten-dimensional configurations, 1000 individuals each);
plot_functions all --resolution 80 --metadata, then plot_de over the
benchmark's traces; and the convex hull on the host, as in the reference.

Path 15 is slice 8 (phase 21), the sharded routes of parallel/ on
torch.distributed: one NCCL rank per card (torch.cuda.device_count()
ranks, spawned by parallel/launch.py; a world of one on one card), each
rank on its own card: (a) NodeMajorRoomSweep.sharded_sweep_fn at path 1's
shape (4096 wavenumbers split by frequency lanes, each rank's band in
chunks of at most 2048 with path 1's per-chunk knobs); (b)
BemSolver(device_mesh) on path 3 (c)'s sphere (N=5120, nq=4, complex64):
Burton–Miller at ka 2 and CBIE at ka 1, each rank assembling its own row
block; (c) build_sharded_system + sharded_gmres_fn (halo ELL, device
Schwarz overlap 1, GMRES and the Ghysels variant) on a FEM Helmholtz
system, P1 box n=15 (4096 nodes), complex128; (d) the cluster-sharded
SLFMM at phase 15 (a)'s shape (N=5120, k = 8); (e) the sharded MLFMM tree
at phase 16 (a)'s shape (N=20480, k = 16), both complex64 with the cluster
block preconditioner; (f) shard_frequency_sweep with shard_room_params on
the dry run's room (unit cube n=5, 8 wavenumbers for each rank),
shard_population_eval on 1000 individuals of 10-d rastrigin (float64), then
the port's dry run (parallel/dryrun.py) at n = the world size.
``--only parallel`` runs the builds and phase 21 alone (a run over four
cards).

Phases, each fatal on failure:
1. build the hand-written kernels (kernels/dia_stencil.cu and
   kernels/bem_pairwise.cu, one nvcc each, started together);
2. hold each DIA kernel mode (and the x = 0 Jacobi step) against its plain
   PyTorch twin on the card at every shape the sweep launches (both
   smoothing levels at 2048 and 32 lanes; complex64, rel. error <= 1e-5),
   at 1 and 37 lanes, and in complex128 at a small shape (<= 1e-12); time
   at each launch shape the kernel (launched from Python, and replayed from
   a CUDA graph: the card's time alone), each tile height, the twin, and
   the library form torch.sparse.mm of the stacked CSR [K; M; B];
3. run the FEM sweep with every launch count set to 0 just before and read
   just after: every DIA kernel must have launched, and only at shapes
   phase 2 timed (counted per shape), 4096/4096 lanes must converge; then
   time repeats;
4. check the FEM answers: a 256-lane sub-band with the kernels vs with the
   twins on the card, and a small float64 sweep on the card vs on the CPU;
   then (4c, "FEM sweep options", slice 6a) every FEM option of bench.py on
   the card, each run counted (launch counts set to 0 just before, read
   just after; peak memory; steady state the median of 3 synchronised
   repeats after it; DoF-solves/s; iteration mean and max): the tp, stream
   and stream16 transfers and the W and F cycles at path 1's shape and
   knobs, each with every lane converged and within 1e-3 of max|p| of
   phase 3's gather V sweep, every DIA mode launched; sweep_fn_jacobi at
   the bench's GMRES knobs over the whole band (recorded: no lane converges
   within 500 iterations there), then on every 8th wavenumber with the
   restart raised from 6 to 60 (every lane converged, within 1e-3 of
   max|p| of the gather V sweep); the vmapped ELL sweep as bench.py --sweep
   vmapped runs it (2048 wavenumbers, cold, 16 anchors: the nested route)
   against the node-major sweep at the same cold knobs (CGS2): every lane
   converged, iteration means within 2%, pressures within 1e-3 of max|p|,
   no DIA launch; one W cycle with fuse_diag=False (stored inverse
   diagonals, the residual kernel) against the fused one (<= 1e-5); the DIA
   shapes these runs launched that phase 2 did not time, held against the
   twin and timed; and in float64 at n=8 (3 levels, 32 wavenumbers) each
   option on the card against the CPU: iterations lane for lane, pressures
   within 1e-9. Each counted option run's DIA launches stand beside the
   main sweep's own in the kernels line (``launches_by_option``); the lone
   fuse_diag cycle calls are no path and stay out of it;
5. hold both BEM sweep kernels against their twins off the diagonal
   (relative Frobenius error per plane: float32 <= 1e-5 at the bench shape,
   at a ragged 300 x 300 shape and at large arguments, 9 wavenumbers up to
   k = 50, k r up to 100 rad; float64 <= 1e-12 at N=320, also up to
   k = 50; with one quadrature point per element, float32 <= 2e-6 over
   the entries with k r >= 50, which sees the phase of e^{ikr} there),
   and time them (from Python, and replayed from a CUDA graph):
   at the bench shape, and ``burton_miller`` at one wavenumber at path 3
   (c)'s shape;
6. run the rigid and the Burton–Miller BEM sweeps, each with the counts set
   to 0 just before and read just after (the path's kernel must have
   launched), all pressures finite, each frequency's residual
   ||A p - b|| / ||b|| <= 1e-4 on the assembled matrices; time repeats;
7. check the BEM answers: at N=1280 with 4 wavenumbers the sweep with the
   kernels vs with the twins on the card and GMRES vs LU (<= 1e-4), and at
   N=320 in float64 the card vs the CPU, LU and GMRES (<= 1e-9).
8. hold the mixed (off the diagonal) and Kirchhoff-Helmholtz (whole)
   kernel variants against their twins: float32 <= 1e-5 per plane at the
   shapes path 3 launches them at (5120 x 5120; the field of 8192 points
   as one launch of 8192 x 5120; the cavity's 512 x 5120; one wavenumber),
   at a ragged 300 x 333 shape with 3 wavenumbers and with 3 up to k = 50,
   float64 <= 1e-12 at N=320 (also up to k = 50), the far-field check of
   phase 5 (k r >= 50, <= 2e-6); time them at each of the
   path's shapes, from Python and replayed from a CUDA graph; then hold
   each of the kernel's bodies against the twins: every variant with a row
   walk and the band body, as the launcher picks them: every variant at
   nq 1, 3 and 4, at ragged 300 x 333, 200 x 5000 and 300 x 5000 (8, 16
   and 32 rows per block of the row walk) with k up to 50 in float32 and
   float64, the sweep's variants also at one wavenumber, the far-field
   check at one wavenumber, and the row walk's r against sqrtf at every
   float32;
9. run path 3 (a)-(d), each with the counts set to 0 just before and read
   just after (its kernels must have launched, each field evaluation and
   (c)'s Burton–Miller assembly as the one launch phases 8 and 5 held),
   gated against the closed
   forms written out below (relative L2: (a) surface pressure, dp/dn and
   field <= 2e-2; (b) surface pressure <= 5e-2; (c) finite, residual
   ||A p - b||/||b|| <= 1e-4; (d) wall pressure and interior field <= 2e-2),
   GMRES converged; print assembly, solve and field milliseconds (medians of
   3 synchronised repeats), GMRES iterations and peak device memory;
10. check path 3's answers: at N=1280 (a) and (d) with the kernels vs with
   the twins on the card (<= 1e-4 of max|p|), and at N=320 in float64 the
   card vs the CPU (<= 1e-9);
11. path 4, slice 3's biquad cascade at bench.py ``run_iir``'s shape (8192
   channels x 10 PEAK stages x 48000 samples, float32, input from numpy's
   default_rng(0)): a first run, then the median and minimum of 3
   synchronised repeats, iir_biquad_cascade_msamples_per_s, peak device
   memory and the bound (x read and y written once over the HBM rate);
   gated on 64 channels against scipy's lfilter stage by stage in float64
   on the host (float32 <= 1e-3 of max|y|, float64 on the card <= 1e-9)
   and two half-blocks with carried state vs the whole block (float64,
   <= 1e-12);
12. path 5, the auto-EQ path on the card: (a) fit_peq on the reference
   test's 3-filter target, 96 points, maxiter 500, seed 4 (rms <= 0.35 dB,
   fitted response within 1 dB); (b) the autoeq CLI through main(argv) on a
   CSV made from a known 7-filter PEQ with its defaults (-n 7 --maxiter
   600): exit 0, the APO file parses back to 7 filters; (c) a second (a)
   from the same seed gives the same population; generations, nfev, ms per
   generation and seconds printed. Paths 4 and 5 launch no hand-written
   kernel (slice 3 has no TPU kernel), so they add nothing to the kernels
   line;
13. path 6, each run with the counts set to 0 just before and read just
   after (``mixed`` and ``kh`` must have launched): (a) main(argv) with the
   auto tier writes a JSON that parses back to 6 results, finite SPL, every
   frequency converged, within 0.01 dB of the same run on the CPU in
   float64; (b) run_bem_simulation(solver="gmres"): each frequency's true
   residual ||A p - b||/||b|| <= 1e-4 where GMRES called it converged
   (printed with its iterations either way), SPL at 40 and 500 Hz within
   0.05 dB of solver="direct" (LU on the card); the solve at those two
   split into mesh tensors, assembly, linear solve and field; ``mixed`` and
   ``kh`` held against their twins at both paths' shapes (10440 x 10440 on
   its first 256 rows) and timed;
14. path 7: main(["--fast", "-o", tmp]) exits 0; the 19 non-FMM cases
   through the case functions at the reference's ka and subdivisions, each
   rel_l2 within 2% (relative) + 1e-4 of qa_bem_results/summary.json; the
   closed forms written out below agree with the port's pulsating-sphere
   oracle and the cavity case's to 1e-12 in float64; the variants the
   cases launch held against their twins at 320 and 1280 elements.
   Phases 13-14 add their shapes to the kernels line's ``other_shapes``;
15. path 8, the FMM (no hand-written kernel of its own; its field at the
   listening points launches ``kh``, counted): TF32 off and the float32
   matmul precision "highest" asserted; (a) the complex64 matvec within 1e-3
   of the float64 one on the card (seeded x), GMRES converged, the surface
   pressure's rel L2 against the Mie series (float64) within 1e-3 of the
   float64 solve's, iterations within 2 of it; build seconds split into
   octree and lists, translations, aggregation, near blocks, and the
   preconditioner; matvec ms from Python and from a CUDA graph beside the
   byte bound of the tensors it reads, device launches per matvec, solve
   ms (median of 3 after a warm run), solves/s, peak memory; (d)
   evaluate_field_fmm against evaluate_field at 8192 points on r = 2 from
   (a)'s float64 solution (<= 1e-4 rel L2; complex64 printed); (b) the QA
   slfmm cases (ka 0.5 at subdivision 2, ka 2 and 5 at 3), each rel_l2
   within 2% + 1e-4 of the recorded run's; (c) main(argv) on the cut config
   under auto: the JSON parses back with finite SPL, 40 Hz converged and
   within 0.1 dB of the dense LU on the card, the FMM matvec at 40 Hz
   within 1e-3 of the dense complex64 matrix's (seeded x), per frequency
   converged and iterations printed, build / ILU / GMRES seconds printed;
   the phase prints its own seconds;
16. path 9, the MLFMM (no hand-written kernel of its own; its dense checks
   launch ``double_layer`` and ``burton_miller``, counted): TF32 off
   asserted; (a) the complex64 matvec in gather and in selection form
   within 1e-3 of the float64 one (seeded x), the cluster-major GMRES
   converged, Mie error within 1e-3 of the float64 solve's, iterations
   within 2 of it; build seconds by stage, both matvecs' ms from Python
   and from a CUDA graph beside their byte bounds and device launches,
   solve ms (median of 3 after a warm run), solves/s, peak memory, and a
   profiled solve's device time and idle share; (b) Burton–Miller
   converged with its rel L2 against Mie <= 1e-2; (c) at N=5120, k = 2 the
   tree's, the two-level MLFMM's and the Burton–Miller tree's matvecs
   within 0.5 of the dense matrices' (float32, one kernel launch each;
   ``double_layer`` there held against its twin and timed), the tree's
   cluster-block GMRES iterations under 2x the SLFMM's; (d) the QA mlfmm
   cases in float64 (the recorded run's precision) within 2% + 1e-4 of the
   recorded rel_l2, and in float32 (the app's default here) printed beside
   and held to the QA threshold 0.5; (e) the mixed-BC tree (float64, tol
   1e-7) converged with its surface rel L2 against the closed form
   <= 0.05; the phase prints its own seconds;
17. path 10 (no hand-written kernel of its own but the BEM routes'): (a) the
   21 QA FEM cases through the case functions in float64, each rel_l2
   within 2% + 1e-4 of qa_fem_results/summary.json and converged, then in
   float32 printed beside and held to the QA threshold 0.1 (converged or
   not printed: float32 BiCGStab stops short of 1e-5); per case the solve's
   ms, iterations, residual, the preconditioner's set-up seconds and device
   launches per apply (colors of the colored ILU); main --fast exits 0; (b)
   each BemSolver route converged with ||A p - b||/||b|| <= 1e-4 on the
   assembled matrix, with exactly one ``burton_miller`` launch (Burton–Miller)
   or one ``double_layer`` launch (CBIE) in its counted run, both variants
   held against their twins at 5120 x 5120, F=1, and timed; the phase prints
   its own seconds;
18. path 11: (a) main(argv) flat and --hierarchical, every frequency
   converged, SPL within 0.05 dB of run_fem_simulation in float64 on the
   card; (b) the cut run: 40 Hz converged, SPL at 40 Hz and at the highest
   converged frequency within 0.1 dB of a float64 scipy sparse direct solve
   of the same assembled system on the host; iterations, converged flags, ms
   per frequency, the batch size, peak memory, and the idle share of the
   batch's first 30 Arnoldi steps under the profiler;
19. paths 12-13, each BEM run counted (launch counts set to 0 just before,
   read just after): (a) exactly one ``double_layer`` (CBIE) or
   ``burton_miller`` launch and one ``kh_double`` (the field) per run, GMRES
   converged, ||A p - b||/||b|| <= 1e-4 on the assembled matrix, surface and
   field rel L2 to the Mie series < 0.1 (tests/test_bem.py's quad gate);
   solve and field ms (medians of 3); each new shape (5046 x 5046, 8192 x
   5046, and (c)'s 5040 x 5040) held against its twin (float32 <= 1e-5 per
   plane, off the diagonal) and timed into the kernels line's
   ``other_shapes``; (b) the number of near pairs, the upgrade's ms, GMRES
   iterations and Mie rel L2 before and after, the upgrade itself launching
   no kernel, and the float64 deltas on the card within 1e-9 of the CPU's;
   (c) one ``double_layer`` launch each, converged, residual <= 1e-4, the uv
   sphere's Mie < 0.1; (d) the parsed mesh equal to the written one. FEM:
   (a) every solve converged, one solve per mesh and order (P_CPU; P3 at
   one restart cycle of 60 steps on both sides, the CPU's whole P3 solves
   taking 30-90 s) within 1e-9 of the CPU with equal iterations, the
   solvers of one mesh and order within 1e-4 of each other's closed-form
   rel_l2, P2 and P3 no worse than P1 (the shell strictly P3 < P2 < P1),
   and on the plane-wave problems P2
   < P1/5 and P3 < P2/3; (b) each converged with the SPL at the listening
   position within 0.1 dB of a float64 scipy sparse direct solve; (c) float64
   PML values on the card within 1e-9 of the CPU's, the strip's ripple <
   0.12 and mean |u| within 0.1 of 1; (d) uniform refinement 8x the
   elements, both refinements keeping the room's volume (1e-9);
20. path 14, no hand-written kernel (every launch count stays 0): (a) every
   function and constraint on the card within 1e-10 of max(1, |f|) of the
   CPU at each point, the worst and the five slowest 4096-point evaluations
   printed; (b) each run_de report parses with the reference's keys,
   finite; fun, nit, nfev and ms per generation printed; sphere's fun <
   1e-4; (c) no configuration crashes ("optimization failed"), the passes
   at least the reference's own on the same list (its recorded CPU run,
   de_benchmark_results/quick_10d_summary.json) less 2, the outcomes that
   differ printed both ways, wall and ms per generation printed, and the
   recorder's cost: one configuration with and without its per-generation
   callback; (d) every z grid within 1e-10 of max(1, |z|) of a --device
   cpu run, the metadata of all 105 functions written, plot_de's HTML with
   one trace per CSV; (e) the hulls of sphere_points(500),
   random_points(500) and fibonacci_sphere_points(180): volume and area
   within 1e-9 (relative) of scipy.spatial.ConvexHull, the same vertices,
   the OBJ export read back to the same faces; the phase prints its seconds;
21. path 15, every rank gating its own part: (a) the sharded sweep's DIA
   launches counted (every mode), 4096/4096 lanes converged, each rank's
   lanes within 1e-6 of max|p| of the unsharded sweep of its chunk on its
   card with equal iterations; (b) each solve converged with exactly its
   kernel launched on every rank, ||A p - b|| / ||b|| <= 1e-4 on the
   assembled matrix, within 1e-4 (relative) of the unsharded GMRES solve,
   iterations within 2, ``sharded_over`` the world size; (c) within 1e-8 of
   max|x| of scipy's sparse direct solve; (d), (e) the sharded matvec within
   1e-5 (relative) of the unsharded gather-form one, converged, iterations
   within 2 of the unsharded GMRES, Mie within phase 15's 1e-3 of the
   float64 solve's; (f) the room sweep within 1e-4 of max|p| of the
   unsharded one with equal iterations, the energies within 1e-12 of
   max(1, |f|); the dry run's gates. Per path the sharded wall over the
   world and the unsharded wall on one card (medians of 3 after a warm run,
   the two sides in turns, before any profile) and the NCCL kernels' share
   of a profiled sharded run's device time; the sweep's DoF-solves/s both
   ways. The DIA and BEM shapes the ranks launched
   that no phase timed are held against their twins and timed here; their
   launches join the kernels line (the DIA ones as the "parallel" run under
   ``launches_by_option``, the BEM row blocks under ``other_shapes``).
With ``--profile``, once every phase has passed, one more run of each
path and of each FEM option (for path 5 a fit at maxiter 100) runs under
torch.profiler and its
device time is printed by kernel group and kernel, with the device's idle
share of the wall time (for path 14 one benchmark configuration, recorded,
cut to 50 generations).

Output: progress lines, then one ``{"kernels": [...]}`` JSON line, the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``. Exits non-zero with no result line when
no CUDA device is present or any phase fails.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the
# non-tensor-core rates of the kernel's arithmetic type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"complex64": 67e12, "complex128": 34e12, "float32": 67e12, "float64": 34e12}

WALLS = (1, 2, 3, 4, 5, 6)
ROOM = dict(wall_tags=WALLS, absorption=0.15,
            listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)))
BENCH_N, BENCH_LEVELS, BENCH_FREQS, BENCH_CHUNK = 20, 3, 4096, 2048
SWEEP_KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=16, mg_cycle_type="v",
                   gmres_orth="cgs1", mg_transfers="gather", freq_chunk=BENCH_CHUNK,
                   warm_stride=64, warm_restart=3, warm_interp="cubic")
# The float64 card-vs-CPU sweeps at n=8 (phases 4b and 4c): GMRES, knobs
# and the band (32 wavenumbers).
SMALL_KRYLOV = dict(max_iterations=500, tolerance=1e-5, restart=6)
SMALL_KNOBS = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=4, gmres_orth="cgs1",
                   freq_chunk=16, warm_stride=4, warm_restart=3, warm_interp="cubic")
SMALL_BAND = (0.55, 2.2, 32)
KERNEL_SOURCE = "mathaudio_tpu_torch/kernels/dia_stencil.cu"
TPU_KERNEL = "mathaudio_tpu/fem/dia.py:212"
MODES = ("matvec", "residual", "jacobi")
FLOPS_PER_PAIR = 15  # per in-band (node, diagonal) and lane: coefficient 7, complex FMA 8
EPILOGUE_FLOPS = {"matvec": 0, "residual": 2, "jacobi": 31}  # per output

BEM_SUBDIV, BEM_FREQS, BEM_BAND = 4, 8, (0.5, 3.0)
BEM_GMRES = dict(solver="gmres", gmres_tol=1e-5, gmres_restart=16)
BEM_SOURCE = "mathaudio_tpu_torch/kernels/bem_pairwise.cu"
BEM_KERNELS = {  # variant: (name in the kernels line, TPU kernel replaced)
    "double_layer": ("bem_double_layer", "mathaudio_tpu/ops/bem_assembly.py:43"),
    "burton_miller": ("bem_burton_miller", "mathaudio_tpu/ops/bem_assembly.py:182"),
    "mixed": ("bem_mixed", "mathaudio_tpu/ops/bem_assembly.py:321"),
    "mixed_bm": ("bem_mixed_bm", "mathaudio_tpu/ops/bem_assembly.py:321"),
    "kh": ("bem_kh", "mathaudio_tpu/ops/bem_assembly.py:504"),
    "kh_double": ("bem_kh_double", "mathaudio_tpu/ops/bem_assembly.py:504"),
}
SWEEP_VARIANTS = ("double_layer", "burton_miller")
MIXED_VARIANTS = ("mixed", "mixed_bm")
FIELD_VARIANTS = ("kh", "kh_double")
# Operations the quadrature needs (each add, multiply, compare, sin, cos,
# sqrt and rsqrt counted as one, an FMA as two): per (i, j) pair, per
# (i, j, q) and per (i, j, q, k). The float kernel's reduction of k r to
# [-pi, pi] before the SFU is its own cost, not counted.
BEM_OPS = {"double_layer": (0, 22, 12), "burton_miller": (5, 41, 24), "mixed": (0, 23, 16),
           "mixed_bm": (5, 44, 37), "kh": (0, 22, 16), "kh_double": (0, 21, 12)}
# What a variant reads and writes: (reads nx, complex (F, Ni, Nj) planes,
# real (Ni, Nj) planes), and the names of the planes its wrapper returns.
BEM_IO = {"double_layer": (False, 1, 1), "burton_miller": (True, 2, 2), "mixed": (False, 2, 1),
          "mixed_bm": (True, 4, 2), "kh": (False, 2, 0), "kh_double": (False, 1, 0)}
BEM_PLANES = {"double_layer": ("D_k", "D_0"), "burton_miller": ("D_k", "D_0", "T_k", "T_0"),
              "mixed": ("D_k", "D_0", "S_k", None, None, None),
              "mixed_bm": ("D_k", "D_0", "S_k", "T_k", "T_0", "K'_k"),
              "kh": ("S_k", "D_k"), "kh_double": (None, "D_k")}

PATH3_KA = 1.0
PATH3_RIGID_KA = 2.0  # (c), the rigid sphere under a plane wave
LARGE_K = 50.0  # k r up to 100 rad on the unit sphere, 150 from the field points
# The far-field check (phases 5 and 8): entries with k r >= FAR_KR, float32,
# one quadrature point per element, relative error per plane <= FAR_TOL.
FAR_KR, FAR_TOL = 50.0, 2e-6
# The kernel's bodies (phase 8), as the launcher picks them: every variant
# at each nq the row walk holds in registers (1, 4) and one it reads per row
# (3), at ragged (rows, elements) of the bench sphere that give the row walk
# 8, 16 and 32 rows per block at BODY_KS (on an H100's 114-132 SMs; mixed_bm
# keeps 8), the rows no multiple of theirs and the elements none of a warp;
# the sweep's variants also at one wavenumber (the row walk; the band body
# at BODY_KS).
BODY_NQ = (1, 3, 4)
BODY_SHAPES = ((300, 333), (200, 5000), (300, 5000))
BODY_KS = (1.5, LARGE_K / 2, LARGE_K)
PATH3_GMRES_TOL = 1e-5
FIELD_SHAPE = (64, 128)  # 8192 points on r = 2
CAVITY_SHAPE = (16, 32)  # 512 points on r = 0.5, inside the cavity
RHO, C_SOUND = 1.204, 343.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def stencil_work(mode, n, nf, offsets, cdtype, from_zero=False):
    """(bytes, flops) one call must move and do: each input read once, the
    output written once; flops over the in-band (node, diagonal) pairs."""
    import torch

    cb = torch.empty((), dtype=cdtype).element_size()
    rb = cb // 2
    vec = n * nf * cb
    n_vec = {"matvec": 2, "residual": 3, "jacobi": 2 if from_zero else 3}[mode]
    tables = 0 if from_zero else 3 * len(offsets) * n * rb
    diag_tables = 3 * n * rb if mode == "jacobi" else 0
    pairs = 0 if from_zero else sum(max(n - abs(o), 0) for o in offsets)
    nbytes = n_vec * vec + tables + diag_tables + 2 * nf * cb
    flops = FLOPS_PER_PAIR * pairs * nf + EPILOGUE_FLOPS[mode] * n * nf
    return nbytes, flops


def bound(mode, n, nf, offsets, cdtype, from_zero=False):
    """(least time in ms, "bytes" | "operations") for one call."""
    nbytes, flops = stencil_work(mode, n, nf, offsets, cdtype, from_zero)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(cdtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, batches=7, per_batch=10):
    """Median over batches of the mean time per call, CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / per_batch)
    return statistics.median(samples)


def sparse_yardstick(dia, offsets, tables):
    """The library form of the stencil, for timing beside the kernel (the
    port never calls it): ``torch.sparse.mm`` of the stacked real CSR
    [K; M; B] (3N x N) by x viewed as real (N x 2F), then the per-lane
    combine K x - cm M x + cb B x and the mode's epilogue."""
    import torch

    n = tables.k.shape[1]
    dev = tables.k.device
    rows = torch.arange(n, device=dev)
    idx, vals = [], []
    for part, tab in enumerate((tables.k, tables.m, tables.b)):
        for d, off in enumerate(offsets):
            cols = rows + off
            keep = (cols >= 0) & (cols < n) & (tab[d] != 0)
            idx.append(torch.stack([part * n + rows[keep], cols[keep]]))
            vals.append(tab[d][keep])
    kmb = torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals), (3 * n, n),
                                  check_invariants=True).coalesce()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        kmb = kmb.to_sparse_csr()

    def stencil(mode, cm, cb, x, r, omega=1.0):
        nf = x.shape[1]
        out = torch.sparse.mm(kmb, torch.view_as_real(x).reshape(n, 2 * nf))
        ak, am, ab = torch.view_as_complex(out.reshape(3, n, nf, 2)).unbind(0)
        y = ak - cm * am + cb * ab
        if mode == "matvec":
            return y
        if mode == "residual":
            return r - y
        return x + omega * dia._inv_diag(tables, cm, cb) * (r - y)

    return stencil


def graph_ms(fn, per_batch=10, batches=7):
    """The card's time per call of ``fn`` without the host: ``per_batch``
    calls captured once in a CUDA graph, the graph replayed; median over
    batches of the mean per call."""
    import torch

    fn()  # build and configure outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    return time_ms(graph.replay, batches=batches, per_batch=1) / per_batch


def _rand_complex(shape, cdtype, gen, dev):
    import torch

    rdt = torch.float32 if cdtype == torch.complex64 else torch.float64
    re = torch.randn(shape, generator=gen, device=dev, dtype=rdt)
    im = torch.randn(shape, generator=gen, device=dev, dtype=rdt)
    return torch.complex(re, im)


def _lanes(ks, shifted, cdtype, dev):
    """The sweep's lane scalars (cm, cb) for wavenumbers ``ks``."""
    import torch

    k = ks.to(cdtype)
    cm = (torch.tensor(1.0 + 0.5j, dtype=cdtype, device=dev) if shifted else 1.0) * (k * k)
    cb = torch.tensor(-0.15j, dtype=cdtype, device=dev) * k
    return cm.contiguous(), cb.contiguous()


def stencil_check(dia, label, mode, offs, tabs, cm, cb, x, r, tol):
    """One kernel call vs its twin on the same card inputs: returns the
    max abs error; raises above ``tol`` (relative Frobenius)."""
    import torch

    twin = twin_stencil(dia)
    got = dia.dia_stencil(mode, offs, tabs, cm, cb, x, r, 1.0)
    ref = twin(mode, offs, tabs, cm, cb, x, r, 1.0)
    torch.cuda.synchronize()
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    max_abs = float(torch.max(torch.abs(got - ref)))
    ok = rel <= tol and bool(torch.isfinite(got).all())
    log(f"kernel {label} {mode}{'(x=0)' if x is None else ''}: "
        f"rel err {rel:.3e} (tol {tol:g}), max abs err {max_abs:.3e}")
    if not ok:
        raise AssertionError(f"{label} {mode}: kernel disagrees with its twin ({rel:.3e})")
    return max_abs


def stencil_record(dia, label, mode, offs, tabs, cm, cb, x_in, r_in, dev, library=None):
    """Check one launch shape against the twin and time it: the kernel
    from Python and in a CUDA graph, each tile height, the twin, the
    sparse yardstick (when given), and the bound."""
    import torch

    n, nf = tabs.k.shape[1], cm.shape[0]
    tag = f"{mode}{'(x=0)' if x_in is None else ''}"
    max_abs = stencil_check(dia, f"c64 {label} N={n} F={nf}", mode, offs, tabs, cm, cb, x_in,
                            r_in, 1e-5)
    twin = twin_stencil(dia)
    ms = time_ms(lambda: dia.dia_stencil(mode, offs, tabs, cm, cb, x_in, r_in, 1.0))
    plain_ms = time_ms(lambda: twin(mode, offs, tabs, cm, cb, x_in, r_in, 1.0),
                       batches=3, per_batch=3)
    sparse_ms = None
    if library is not None and x_in is not None:
        sparse_ms = time_ms(lambda: library(mode, cm, cb, x_in, r_in), batches=3, per_batch=3)
    b_ms, b_by = bound(mode, n, nf, offs, torch.complex64, from_zero=x_in is None)
    on_card = graph_ms(lambda: dia.dia_stencil(mode, offs, tabs, cm, cb, x_in, r_in, 1.0))
    # every tile height the kernel has, for comparison with the plan's pick
    by_rows = {p: graph_ms(lambda: dia.dia_stencil(mode, offs, tabs, cm, cb, x_in, r_in,
                                                   rows_per_thread=p))
               for p in dia.ROWS_PER_THREAD}
    picked = dia.stencil_plan(offs, n, nf, 8, torch.cuda.get_device_properties(
        dev).multi_processor_count).rows_per_thread
    log(f"  {label} N={n} F={nf} {tag}: kernel {ms:.4f} ms, in a graph {on_card:.4f} ms "
        f"(rows per thread {picked}), twin {plain_ms:.4f} ms, sparse "
        f"{'-' if sparse_ms is None else f'{sparse_ms:.4f}'} ms, bound {b_ms:.4f} ms "
        f"({b_by}), {100 * b_ms / on_card:.1f}% of bound; in a graph by rows per "
        f"thread {({p: round(t, 4) for p, t in by_rows.items()})}")
    return dict(shape=f"{n}x{nf}", x0=x_in is None, max_abs_err=max_abs, ms=ms,
                graph_ms=on_card, plain_ms=plain_ms, sparse_ms=sparse_ms, bound_ms=b_ms,
                bound_by=b_by, rows_per_thread=picked, graph_ms_by_rows_per_thread=by_rows)


def kernel_phase(dia, nm, dev, dtype_small_nm, ks_all):
    """Each mode (and the x = 0 Jacobi step) vs its twin, timed, at every
    shape the sweep launches: both smoothing levels at the chunk's 2048
    lanes and at its 32 anchor lanes; then ragged lane counts and
    complex128. Returns {(mode, N, F, x is None): record}."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(1234)

    def rand(shape, cdtype):
        return _rand_complex(shape, cdtype, gen, dev)

    params = nm.params()
    levels = [("fine", params.offsets[0], params.fine_tables, False),
              ("level1", params.offsets[1], params.levels[1].tables, True)]
    records = {}
    for label, offs, tabs, shifted in levels:
        library = sparse_yardstick(dia, offs, tabs)
        n = tabs.k.shape[1]
        for nf in (BENCH_CHUNK, BENCH_CHUNK // SWEEP_KNOBS["warm_stride"]):
            cm, cb = _lanes(ks_all[:nf], shifted, torch.complex64, dev)
            x, r = rand((n, nf), torch.complex64), rand((n, nf), torch.complex64)
            for mode, x_in in [(m, x) for m in MODES] + [("jacobi", None)]:
                r_in = None if mode == "matvec" else r
                records[(mode, n, nf, x_in is None)] = stencil_record(
                    dia, label, mode, offs, tabs, cm, cb, x_in, r_in, dev, library)
        # ragged lane counts: one lane, and partial warps and blocks
        for nf in (1, 37):
            cm, cb = _lanes(ks_all[:nf], shifted, torch.complex64, dev)
            x, r = rand((n, nf), torch.complex64), rand((n, nf), torch.complex64)
            for mode, x_in in [(m, x) for m in MODES] + [("jacobi", None)]:
                stencil_check(dia, f"c64 {label} N={n} F={nf}", mode, offs, tabs, cm, cb, x_in,
                              r, 1e-5)

    # complex128 at a small shape
    p64 = dtype_small_nm.params()
    for label, offs, tabs, shifted in [("fine", p64.offsets[0], p64.fine_tables, False),
                                       ("level1", p64.offsets[1], p64.levels[1].tables, True)]:
        n = tabs.k.shape[1]
        for nf in (1, 37, 64):
            cm, cb = _lanes(torch.linspace(0.55, 2.2, nf, dtype=torch.float64, device=dev),
                            shifted, torch.complex128, dev)
            x, r = rand((n, nf), torch.complex128), rand((n, nf), torch.complex128)
            for mode in MODES:
                stencil_check(dia, f"c128 {label} N={n} F={nf}", mode, offs, tabs, cm, cb, x, r,
                              1e-12)
            stencil_check(dia, f"c128 {label} N={n} F={nf}", "jacobi", offs, tabs, cm, cb, None,
                          r, 1e-12)
    return records


def dia_entries(records, by_shape, option_shapes=None, cycle_shapes=None):
    """The DIA entries of the kernels line: each mode at the fine level's
    full chunk, its other launch shapes beside it. ``launches`` is the
    counted main sweep's own count; each FEM sweep option's counted run
    stands beside it under ``launches_by_option`` (``option_shapes``:
    {option: {shape: count}}). ``cycle_shapes`` are launches of lone
    cycle calls, not paths: they only join the check that every launched
    shape was timed. Fails if a run launched a shape that phase 2 or the
    options phase did not time."""
    option_shapes = option_shapes or {}
    launched = set(by_shape).union(*(set(v) for v in option_shapes.values()),
                                   *(set(v) for v in (cycle_shapes or {}).values()))
    untimed = sorted(launched - set(records))
    if untimed:
        raise AssertionError(f"a counted run launched DIA shapes no phase timed: {untimed}")
    main_n = max(key[1] for key in records)
    entries = []
    for mode in MODES:
        main = (mode, main_n, BENCH_CHUNK, False)

        def by_option(key):
            return {opt: shapes[key] for opt, shapes in option_shapes.items() if key in shapes}

        others = [dict(records[key], launches=by_shape.get(key, 0),
                       launches_by_option=by_option(key))
                  for key in sorted(records) if key[0] == mode and key != main]
        rec = {k: v for k, v in records[main].items() if k != "x0"}
        entries.append(dict(name=f"dia_stencil_{mode}", route="cuda", source=KERNEL_SOURCE,
                            replaces=TPU_KERNEL,
                            launches=sum(v for k, v in by_shape.items() if k[0] == mode),
                            library_ms=None, **rec, other_shapes=others,
                            launches_at_shape=by_shape.get(main, 0),
                            launches_by_option={
                                opt: sum(v for k, v in shapes.items() if k[0] == mode)
                                for opt, shapes in option_shapes.items()}))
    return entries


# The FEM sweep options (slice 6a): each run against the gather V sweep of
# phase 3 (same knobs otherwise), gated to this share of max|p|.
OPTION_RUNS = (("tp", dict(mg_transfers="tp")), ("stream", dict(mg_transfers="stream")),
               ("stream16", dict(mg_transfers="stream16")), ("w", dict(mg_cycle_type="w")),
               ("f", dict(mg_cycle_type="f")))
OPTION_TOL = 1e-3
# sweep_fn_jacobi: at the bench's GMRES knobs over the whole band (recorded,
# not gated: Jacobi-GMRES(6) converges no lane of the n=20 room within 500
# iterations), then gated (every lane converged, OPTION_TOL against the
# gather V sweep) on every JACOBI_STRIDE-th wavenumber at restart 60.
JACOBI_STRIDE, JACOBI_RESTART = 8, 60
# The vmapped ELL sweep as bench.py --sweep vmapped runs it: 2048
# wavenumbers, one chunk, cold, 16 anchors (128 lanes each: the nested route).
VMAPPED_FREQS, VMAPPED_ANCHORS, VMAPPED_ITER_TOL = 2048, 16, 0.02


def counted_sweep(dia, label, run, dev, n_nodes, n_lanes, repeats=3):
    """One counted run (launch counts set to 0 just before, read just
    after; peak memory), then the median of ``repeats`` synchronised
    repeats. Returns ((p, its, conv), summary, DIA launches by shape)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dia.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = {m: c for m, c in dia.LAUNCHES.items() if c}
    by_shape = dict(dia.LAUNCHES_BY_SHAPE)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    ms = median_ms(run, repeats)
    p, its, conv = out
    its_f = its.float()
    summary = dict(ms=ms, dof_per_s=n_nodes * n_lanes / (ms / 1e3),
                   iterations_mean=float(its_f.mean()), iterations_max=int(its.max()),
                   converged=int(conv.sum()), lanes=n_lanes, peak_gib=peak, launches=launches)
    log(f"options {label}: {n_lanes} x {n_nodes}: first run {first:.3f} s, steady state "
        f"{ms:.1f} ms (median of {repeats}), {summary['dof_per_s']:.4e} DoF-solves/s, iterations mean "
        f"{summary['iterations_mean']:.3f} max {summary['iterations_max']}, converged "
        f"{summary['converged']}/{n_lanes}, peak memory {peak:.2f} GiB, DIA launches {launches}")
    for (mode, n, nf, x0), count in sorted(by_shape.items()):
        log(f"  options {label} DIA launches {mode}{'(x=0)' if x0 else ''} at {n} x {nf}: {count}")
    return out, summary, by_shape


def max_rel_diff(p, ref):
    import torch

    return float(torch.max(torch.abs(p - ref)) / torch.max(torch.abs(ref)))


def options_phase(dia, nm, dev, ks, config, p_gather, small, records):
    """The FEM sweep options of the main path on the card (slice 6a): the
    tp, stream and stream16 transfers and the W and F cycles at the bench
    shape against phase 3's gather V sweep; sweep_fn_jacobi; the vmapped
    ELL sweep as bench.py --sweep vmapped runs it against the node-major
    sweep at the same cold knobs; one cycle with stored inverse diagonals
    (fuse_diag=False) against the fused one; and each option in float64 at
    n=8 on the card against the CPU. DIA shapes a run launched that phase 2
    did not time are checked and timed here (added to ``records``).
    Returns ({option: DIA launches by shape}, {cycle call: DIA launches by
    shape}, {label: run} for --profile, {option: summary})."""
    import torch

    from mathaudio_tpu_torch.fem.multigrid import build_coarse_inv_chain
    from mathaudio_tpu_torch.fem.multigrid_batched import make_dia_mg, mg_cycle_batched
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    t_phase = time.perf_counter()
    params = nm.params()
    n_nodes = params.rhs.shape[0]
    option_shapes, cycle_shapes, runs, summaries = {}, {}, {}, {}

    # (a) transfers and cycles at the bench shape, every lane converged,
    # each within OPTION_TOL of the gather V sweep
    for label, extra in OPTION_RUNS:
        sweep = nm.sweep_fn(config, **{**SWEEP_KNOBS, **extra})
        run = lambda sweep=sweep: sweep(params, ks)  # noqa: E731
        (p, its, conv), summary, by_shape = counted_sweep(dia, label, run, dev, n_nodes,
                                                          ks.shape[0])
        err = max_rel_diff(p, p_gather)
        summary["max_dp_vs_gather"] = err
        log(f"options {label}: max|dp| {err:.3e} of max|p| against the gather V sweep "
            f"(limit {OPTION_TOL:g})")
        if summary["converged"] != ks.shape[0] or not err <= OPTION_TOL:
            raise AssertionError(f"options {label}: {summary['converged']}/{ks.shape[0]} "
                                 f"converged, max|dp| {err:.3e}")
        if any(summary["launches"].get(m, 0) == 0 for m in MODES):
            raise AssertionError(f"options {label}: a DIA kernel mode was not launched: "
                                 f"{summary['launches']}")
        option_shapes[label], runs[f"options {label}"], summaries[label] = by_shape, run, summary

    # (b) sweep_fn_jacobi: the bench's knobs over the whole band (recorded),
    # then the gated reduced band
    jac = nm.sweep_fn_jacobi(config)
    run = lambda: jac(params, ks)  # noqa: E731
    # every lane runs to the iteration cap: one repeat times it
    _, summary, by_shape = counted_sweep(dia, "jacobi (bench knobs)", run, dev, n_nodes,
                                         ks.shape[0], repeats=1)
    log(f"options jacobi: at restart {config.restart}, {config.max_iterations} iterations, "
        f"{summary['converged']}/{ks.shape[0]} lanes converge (recorded, not gated)")
    option_shapes["jacobi_bench"], summaries["jacobi_bench"] = by_shape, summary
    ks_j = ks[::JACOBI_STRIDE].contiguous()
    jac_cfg = config._replace(restart=JACOBI_RESTART)
    jac = nm.sweep_fn_jacobi(jac_cfg)
    run = lambda: jac(params, ks_j)  # noqa: E731
    (p, _, conv), summary, by_shape = counted_sweep(
        dia, f"jacobi (every {JACOBI_STRIDE}th wavenumber, restart {JACOBI_RESTART})", run, dev,
        n_nodes, ks_j.shape[0])
    err = max_rel_diff(p, p_gather[::JACOBI_STRIDE])
    summary["max_dp_vs_gather"] = err
    log(f"options jacobi reduced band: max|dp| {err:.3e} of max|p| against the gather V sweep "
        f"(limit {OPTION_TOL:g})")
    if (summary["converged"] != ks_j.shape[0] or not err <= OPTION_TOL
            or summary["launches"].get("matvec", 0) == 0):
        raise AssertionError(f"options jacobi: {summary['converged']}/{ks_j.shape[0]} converged, "
                             f"max|dp| {err:.3e}, launches {summary['launches']}")
    option_shapes["jacobi"], runs["options jacobi"], summaries["jacobi"] = by_shape, run, summary

    # (c) the vmapped ELL sweep against the node-major sweep, same cold knobs
    ks_v = torch.linspace(0.55, 2.2, VMAPPED_FREQS, dtype=ks.dtype, device=dev)
    cold = dict(mg_nu=1, mg_omega=1.0, mg_coarse_anchors=VMAPPED_ANCHORS, mg_cycle_type="v")
    vm = nm.model.sweep_fn(config, mg_builder=nm.mg.builder, **cold)
    run = lambda: vm(nm.model.params(), ks_v)  # noqa: E731
    (p_v, its_v, conv_v), summary, by_shape = counted_sweep(dia, "vmapped", run, dev, n_nodes,
                                                            VMAPPED_FREQS)
    runs["options vmapped"], summaries["vmapped"] = run, summary
    nm_cold = nm.sweep_fn(config, gmres_orth="cgs2", **cold)
    run = lambda: nm_cold(params, ks_v)  # noqa: E731
    (p_n, its_n, _), summary_n, by_shape_n = counted_sweep(dia, "node-major cold cgs2", run, dev,
                                                           n_nodes, VMAPPED_FREQS)
    option_shapes["nm_cold"], summaries["nm_cold"] = by_shape_n, summary_n
    err = max_rel_diff(p_v, p_n)
    it_gap = abs(summary["iterations_mean"] - summary_n["iterations_mean"]) / summary_n[
        "iterations_mean"]
    lanes_equal = int((its_v == its_n).sum())
    summaries["vmapped"].update(max_dp_vs_nm=err, iterations_mean_gap=it_gap,
                                lanes_equal_iterations=lanes_equal)
    log(f"options vmapped vs node-major: max|dp| {err:.3e} of max|p| (limit {OPTION_TOL:g}), "
        f"iteration means {summary['iterations_mean']:.4f} / {summary_n['iterations_mean']:.4f} "
        f"({100 * it_gap:.2f}% apart, limit {100 * VMAPPED_ITER_TOL:g}%), equal iterations on "
        f"{lanes_equal}/{VMAPPED_FREQS} lanes, DIA launches {summary['launches']} (none expected)")
    if (summary["converged"] != VMAPPED_FREQS or not err <= OPTION_TOL
            or not it_gap <= VMAPPED_ITER_TOL or summary["launches"]):
        raise AssertionError("options vmapped: disagrees with the node-major sweep")

    # (d) fuse_diag=False: stored inverse diagonals, the residual kernel and
    # one elementwise update, against the fused Jacobi kernel, one W cycle
    chunk = ks[:BENCH_CHUNK].contiguous()
    na = SWEEP_KNOBS["mg_coarse_anchors"]
    cd = params.rhs.dtype
    anchor_ks = chunk.reshape(na, -1).mean(dim=1)
    anchor_inv = build_coarse_inv_chain(params.mg_builder, anchor_ks,
                                        torch.tensor(-1j * nm.absorption, dtype=cd, device=dev)
                                        * anchor_ks.to(cd))
    gen = torch.Generator(device=dev).manual_seed(77)
    r = _rand_complex((n_nodes, BENCH_CHUNK), cd, gen, dev)
    out = {}
    for fuse in (True, False):
        mgp = make_dia_mg(params.offsets, params.levels, chunk, nm.absorption, anchor_inv,
                          fuse_diag=fuse)
        cyc = lambda mgp=mgp: mg_cycle_batched(mgp, params.offsets, r, omega=1.0, nu=1,  # noqa
                                               cycle="w")
        dia.reset_launches()
        out[fuse] = cyc()
        torch.cuda.synchronize()
        launches = {m: c for m, c in dia.LAUNCHES.items() if c}
        cycle_shapes[f"w_cycle_fuse_diag_{fuse}"] = dict(dia.LAUNCHES_BY_SHAPE)
        ms = median_ms(cyc)
        log(f"options fuse_diag={fuse}: one W cycle at {n_nodes} x {BENCH_CHUNK}: {ms:.2f} ms, "
            f"DIA launches {launches}")
    err = max_rel_diff(out[False], out[True])
    log(f"options fuse_diag=False vs True: max|dx| {err:.3e} of max|x| (limit 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"options fuse_diag=False disagrees with the fused cycle ({err:.3e})")

    # DIA shapes the option runs launched that phase 2 did not time
    fine = (params.offsets[0], params.fine_tables, False)
    level1 = (params.offsets[1], params.levels[1].tables, True)
    by_n = {params.fine_tables.k.shape[1]: ("fine", *fine),
            params.levels[1].tables.k.shape[1]: ("level1", *level1)}
    gen = torch.Generator(device=dev).manual_seed(4321)
    for key in sorted(set().union(*option_shapes.values(), *cycle_shapes.values())
                      - set(records)):
        mode, n, nf, x0 = key
        label, offs, tabs, shifted = by_n[n]
        cm, cb = _lanes(ks[:nf], shifted, torch.complex64, dev)
        x = None if x0 else _rand_complex((n, nf), torch.complex64, gen, dev)
        r = None if mode == "matvec" else _rand_complex((n, nf), torch.complex64, gen, dev)
        records[key] = stencil_record(dia, f"options {label}", mode, offs, tabs, cm, cb, x, r,
                                      dev)

    # (e) float64 at n=8: each option on the card against the port on the CPU
    small_cfg = KrylovConfig(**SMALL_KRYLOV)
    ks_small = torch.linspace(*SMALL_BAND, dtype=torch.float64)
    cases = [(label, lambda snm, extra=extra: snm.sweep_fn(small_cfg, **{**SMALL_KNOBS, **extra})(
        snm.params(), ks_small)) for label, extra in OPTION_RUNS]
    cases.append(("jacobi", lambda snm: snm.sweep_fn_jacobi(small_cfg._replace(restart=30))(
        snm.params(), ks_small)))
    cases.append(("vmapped", lambda snm: snm.model.sweep_fn(
        small_cfg, mg_builder=snm.mg.builder, mg_nu=1, mg_omega=1.0,
        mg_coarse_anchors=SMALL_KNOBS["mg_coarse_anchors"])(snm.model.params(), ks_small)))
    for label, case in cases:
        (pg, ig, cg), (pc, ic, cc) = ((t.cpu() for t in case(small[w])) for w in ("cuda", "cpu"))
        s_err = max_rel_diff(pg, pc)
        it_diff = int(torch.max(torch.abs(ig - ic)))
        log(f"options f64 n=8 {label} card vs CPU: pressure max err {s_err:.3e} (limit 1e-09), "
            f"iteration diff max {it_diff} (limit 0), converged {int(cg.sum())}/{int(cc.sum())}")
        if s_err > 1e-9 or it_diff or not bool(cg.all()) or not bool(cc.all()):
            raise AssertionError(f"options f64 {label}: the card disagrees with the CPU")
    log(f"options: phase took {time.perf_counter() - t_phase:.1f} s")
    return option_shapes, cycle_shapes, runs, summaries


def twin_stencil(dia):
    """A stand-in for dia.dia_stencil that runs the plain twins (on the
    card), to compare whole sweeps with and without the kernel."""

    def stencil(mode, offsets, tables, cm, cb, x, r=None, omega=1.0):
        if mode == "matvec":
            return dia.dia_matvec_ref(offsets, tables, cm, cb, x)
        if mode == "residual":
            return dia.dia_residual_ref(offsets, tables, cm, cb, x, r)
        return dia.dia_jacobi_ref(offsets, tables, cm, cb, x, r, omega)

    return stencil


def _kernel_group(name: str) -> str:
    low = name.lower()
    for key, group in (("dia_stencil", "dia_stencil (hand-written)"),
                       ("bem_pairwise", "bem_pairwise (hand-written)"), ("gemm", "gemm"),
                       ("gemv", "gemm"), ("xmma", "gemm"), ("getrf", "lu/inverse"),
                       ("getri", "lu/inverse"), ("trsm", "lu/inverse"), ("index", "gather/index"),
                       ("gather", "gather/index"), ("reduce", "reduction"), ("cat", "copy/cat"),
                       ("copy", "copy/cat"), ("fill", "fill")):
        if key in low:
            return group
    return "elementwise/other"


def profile_run(label, run, kernel):
    """One ``run()`` under torch.profiler: device time by kernel group and
    by kernel, the device's idle share of the run's wall time, and how
    many launches of the path's hand-written ``kernel`` the trace holds
    (when the path has one).

    A first ``run()`` is the profiler's warm-up step and is discarded:
    without it the trace may miss the first kernel it should hold."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=schedule) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
             if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    by_group, by_name = {}, {}
    for start, end, name in spans:
        us = end - start
        g = _kernel_group(name)
        by_group[g] = by_group.get(g, 0.0) + us
        count, total = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, total + us)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for start, end, _ in spans:
        if cur_e is None or start > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    window_ms = (spans[-1][1] - spans[0][0]) / 1e3
    log(f"profile {label}: wall {wall_ms:.1f} ms (profiled), device window {window_ms:.1f} ms, "
        f"device busy {busy / 1e3:.1f} ms, idle share of wall {100 * (1 - busy / 1e3 / wall_ms):.1f}%, "
        f"{len(spans)} device activities")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        log(f"profile {label} group: {g}: {us / 1e3:.2f} ms ({100 * us / busy:.1f}% of busy)")
    for name, (count, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        log(f"profile {label} kernel: {us / 1e3:.2f} ms in {count} calls: {name[:110]}")
    if kernel:
        seen = sum(count for name, (count, _) in by_name.items() if kernel in name)
        log(f"profile {label}: {seen} launches of {kernel} in the trace")


def bem_bound(variant, ni, nj, nq, nf, rdtype):
    """(least time in ms, "bytes" | "operations") for one BEM kernel call:
    each input read once, each output written once; operations as
    BEM_OPS counts them for these shapes."""
    import torch

    rb = torch.empty((), dtype=rdtype).element_size()
    reads_nx, complex_planes, real_planes = BEM_IO[variant]
    inputs = (3 * ni * (2 if reads_nx else 1) + nj * (3 * nq + 3 + nq) + nf) * rb
    outputs = (2 * nf * complex_planes + real_planes) * ni * nj * rb
    per_pair, per_point, per_point_k = BEM_OPS[variant]
    ops = ni * nj * (per_pair + nq * (per_point + per_point_k * nf))
    t_bytes = (inputs + outputs) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(rdtype).replace("torch.", "")] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def twin_pairwise(ops):
    """A stand-in for ops.bem_pairwise that runs the plain twins (on the
    card), to compare whole sweeps with and without the kernels."""

    def pairwise(variant, x, nx, yq, ny, w, ks):
        if variant == "burton_miller":
            return ops.pairwise_bm_ref(x, nx, yq, ny, w, ks)
        if variant in MIXED_VARIANTS:
            # the twin's pair kernels read nx in every variant
            return ops.pairwise_mixed_ref(x, x if nx is None else nx, yq, ny, w, ks,
                                          variant == "mixed_bm")
        if variant in FIELD_VARIANTS:
            return ops.pairwise_kh_ref(x, yq, ny, w, ks, variant == "kh")
        return ops.pairwise_double_layer_ref(x, yq, ny, w, ks)

    return pairwise


def compare_planes(label, variant, got, ref, tol, off_diagonal):
    """Relative Frobenius error of each plane of ``variant`` against its
    twin's (off the diagonal where the surface's own points make the
    i == j sums singular); returns the largest absolute error."""
    import torch

    worst_abs = 0.0
    for plane, g, r in zip(BEM_PLANES[variant], got, ref):
        if plane is None:
            if g is not None or r is not None:
                raise AssertionError(f"{label} {variant}: a plane it does not have came back")
            continue
        if off_diagonal:
            g, r = _zero_diagonal(g), _zero_diagonal(r)
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label} {variant} {plane}: non-finite entries")
        diff = g - r
        rel = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(r))
        max_abs = float(torch.max(torch.abs(diff)))
        log(f"kernel {label} {variant} {plane}: {'off-diagonal ' if off_diagonal else ''}"
            f"rel err {rel:.3e} (tol {tol:g}), max abs err {max_abs:.3e}")
        if rel > tol:
            raise AssertionError(f"{label} {variant} {plane}: kernel disagrees with its twin ({rel:.3e})")
        worst_abs = max(worst_abs, max_abs)
        del diff
    return worst_abs


def _zero_diagonal(t):
    import torch

    torch.diagonal(t, dim1=-2, dim2=-1).zero_()
    return t


def far_field_errors(variant, got, ref, x, yq, ks):
    """Relative Frobenius error of each complex plane of ``variant`` over
    the entries with k r >= FAR_KR: ``got`` from the kernel and ``ref`` from
    its twin, float32, at the points ``x`` against elements of one
    quadrature point each (``yq`` (Nj, 1, 3)). Each entry is then one term
    of the sum, and its error that of e^{ikr} there, beside the amplitude's
    rounding. SFU sin and cos of an unreduced k r are off by ~1e-5 rad at
    k r = 100; the error over whole planes barely sees that, as the near
    pairs, where k r is small, carry most of each plane's norm. The twin
    sums r^2 in torch's reduction order, the kernel as (dx^2 + dy^2) + dz^2,
    and where the two float32 products k r differ (one ulp is 7.6e-6 rad at
    k r ~ 100) the twin's entry is first turned by e^{i(k r_kernel - k r_twin)},
    so that only the kernel's e^{ikr} is measured. Returns ({plane: error},
    the number of far entries, the share of them whose k r differs)."""
    import torch

    rv = yq[None, :, 0, :] - x[:, None, :]
    sq = rv * rv
    r_twin = torch.sqrt(torch.sum(sq, dim=-1))
    r_kernel = torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    k = ks[:, None, None]
    kr_twin, kr_kernel = (k * r_twin).double(), (k * r_kernel).double()
    far = kr_twin >= FAR_KR
    turn = torch.polar(torch.ones_like(kr_twin), kr_kernel - kr_twin)[far]
    moved = float((kr_kernel != kr_twin)[far].double().mean())
    errors = {}
    for plane, g, r in zip(BEM_PLANES[variant], got, ref):
        if g is None or not g.is_complex():
            continue
        want = r[far].to(torch.complex128) * turn
        diff = g[far].to(torch.complex128) - want
        errors[plane] = float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want))
    return errors, int(far.sum()), moved


def far_field_check(label, ops, twin, variant, x, nx, st, ks):
    """``variant`` (float32) at the points ``x`` against the elements of
    ``st`` with one quadrature point each, held against its twin over the
    entries with k r >= FAR_KR (``far_field_errors``) to FAR_TOL."""
    import torch

    yq, w = st.qp[:, :1].contiguous(), st.qw[:, :1].contiguous()
    a = (x, nx, yq, st.normals, w, ks)
    got, ref = ops.bem_pairwise(variant, *a), twin(variant, *a)
    errors, n_far, moved = far_field_errors(variant, got, ref, x, yq, ks)
    if n_far == 0:
        raise AssertionError(f"{label} {variant}: no entry with k r >= {FAR_KR:g}")
    for plane, rel in errors.items():
        log(f"kernel {label} {variant} {plane}: far-field (k r >= {FAR_KR:g}, {n_far} entries, "
            f"{100 * moved:.1f}% with the twin's k r an ulp off) rel err {rel:.3e} (tol {FAR_TOL:g})")
        if rel > FAR_TOL:
            raise AssertionError(f"{label} {variant} {plane}: far-field phase off ({rel:.3e})")
    del got, ref
    torch.cuda.empty_cache()


def bem_kernel_record(label, ops, twin, variant, a, off_diagonal, twin_rows=None,
                      graph_calls=10):
    """``variant`` on inputs ``a`` (float32) held against its twin, timed
    from Python and replayed from a CUDA graph (``graph_calls`` calls per
    replay), the twin timed, and the bound: one record of the kernels line.
    With ``twin_rows`` the kernel runs at the whole shape and its first
    ``twin_rows`` rows are held against the twin run on those rows alone,
    where the twin's (rows, N, nq) temporaries at the whole shape would
    not fit; the twin is timed on those rows (``plain_rows``)."""
    import torch

    x, nx, yq, ny, w, ks = a
    block = a if twin_rows is None else (x[:twin_rows], None if nx is None else nx[:twin_rows],
                                         yq, ny, w, ks)
    got = ops.bem_pairwise(variant, *a)
    if twin_rows is not None:
        got = tuple(None if g is None else g[..., :twin_rows, :] for g in got)
    ref = twin(variant, *block)
    torch.cuda.synchronize()
    max_abs = compare_planes(label, variant, got, ref, 1e-5, off_diagonal)
    del got, ref
    torch.cuda.empty_cache()
    ms = time_ms(lambda: ops.bem_pairwise(variant, *a))
    on_card = graph_ms(lambda: ops.bem_pairwise(variant, *a), per_batch=graph_calls)
    plain_ms = time_ms(lambda: twin(variant, *block), batches=3, per_batch=1)
    ni, (nj, nq, _), nf = x.shape[0], yq.shape, ks.shape[0]
    b_ms, b_by = bem_bound(variant, ni, nj, nq, nf, torch.float32)
    rows = "" if twin_rows is None else f" (on its first {twin_rows} rows)"
    log(f"  {variant} {ni} x {nj} F={nf}: kernel {ms:.4f} ms, in a graph {on_card:.4f} ms, twin"
        f"{rows} {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / on_card:.1f}% of "
        f"bound")
    torch.cuda.empty_cache()
    record = dict(shape=f"{ni}x{nj}", nf=nf, max_abs_err=max_abs, ms=ms, graph_ms=on_card,
                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, launches=0)
    if twin_rows is not None:
        record["plain_rows"] = twin_rows
    return record


def bem_kernel_phase(ops, statics, statics64, dev):
    """Both BEM sweep kernels vs their twins off the diagonal: at the bench
    shape (float32, timed, with bounds), at ragged shapes, at large
    arguments and in float64; ``burton_miller`` also at path 3 (c)'s one
    wavenumber. Returns per-variant records at the bench shape, with the
    F = 1 record of ``burton_miller`` under ``other_shapes``."""
    import torch

    twin = twin_pairwise(ops)

    def args(variant, st, n, ks):
        ks = torch.as_tensor(ks, dtype=st.centers.dtype).to(dev)
        nx = st.normals[:n] if variant == "burton_miller" else None
        return st.centers[:n], nx, st.qp[:n], st.normals[:n], st.qw[:n], ks

    def check(label, variant, a, tol):
        got = ops.bem_pairwise(variant, *a)
        ref = twin(variant, *a)
        torch.cuda.synchronize()
        return compare_planes(label, variant, got, ref, tol, off_diagonal=True)

    records = {}
    n = statics.centers.shape[0]
    n64 = statics64.centers.shape[0]
    large = torch.linspace(LARGE_K / 9, LARGE_K, 9, dtype=torch.float64)
    for variant in SWEEP_VARIANTS:
        band = torch.linspace(*BEM_BAND, BEM_FREQS, dtype=torch.float64)
        records[variant] = bem_kernel_record(f"f32 N={n} F={BEM_FREQS}", ops, twin, variant,
                                             args(variant, statics, n, band), off_diagonal=True)
        for nf in (3, 11):  # ragged rows, columns and frequency groups
            check(f"f32 N=300 F={nf}", variant,
                  args(variant, statics, 300, torch.linspace(*BEM_BAND, nf)), 1e-5)
        check(f"f32 N=300 F=9 k<={LARGE_K:g}", variant, args(variant, statics, 300, large), 1e-5)
        x, nx, *_, ks = args(variant, statics, 1280, large)
        far_field_check(f"f32 1280 x {n} nq=1 F=9 k<={LARGE_K:g}", ops, twin, variant, x, nx,
                        statics, ks)
        check(f"f64 N={n64} F=4", variant,
              args(variant, statics64, n64, torch.linspace(*BEM_BAND, 4)), 1e-12)
        check(f"f64 N={n64} F=9 k<={LARGE_K:g}", variant, args(variant, statics64, n64, large),
              1e-12)
    # path 3 (c): the rigid sphere's Burton-Miller assembly, one wavenumber
    records["burton_miller"]["other_shapes"] = [bem_kernel_record(
        f"f32 N={n} F=1", ops, twin, "burton_miller",
        args("burton_miller", statics, n, [PATH3_RIGID_KA]), off_diagonal=True)]
    return records


def rel_rows(got, want):
    """Largest per-frequency relative 2-norm difference of (F, N) fields."""
    import torch

    return float(torch.max(torch.linalg.vector_norm(got - want, dim=1)
                           / torch.linalg.vector_norm(want, dim=1)))


def bem_sweep_phase(label, bm, mesh, statics, ks, inc, counters):
    """One bench-shape sweep with the launch counts set to 0 just before
    and read just after, checked (finite, residuals), then timed.
    Returns (launches, the sweep as a callable)."""
    import torch

    from mathaudio_tpu_torch.bem import assembly, sweep
    from mathaudio_tpu_torch.xtypes import full_f32_matmul

    betas, rhs = sweep.sweep_inputs(mesh, statics, ks, inc, burton_miller=bm)

    def run():
        return sweep.sweep_apply(statics, ks, betas, rhs, burton_miller=bm, **BEM_GMRES)

    dev = statics.centers.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    p = run()
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items()}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    n = statics.centers.shape[0]
    nf = ks.shape[0]
    log(f"bem sweep {label} {nf} x {n}: first run {t_first:.3f} s, peak memory {peak_gib:.2f} GiB, "
        f"launches {launches}")
    if tuple(p.shape) != (nf, n) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"bem sweep {label}: bad pressure output, shape {tuple(p.shape)}")

    a = assembly._assemble(*statics, ks, betas, bm)
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"bem sweep {label}: the assembled matrices are not finite")
    with full_f32_matmul():
        res = torch.matmul(a, p.unsqueeze(-1)).squeeze(-1) - rhs
    rel = torch.linalg.vector_norm(res, dim=1) / torch.linalg.vector_norm(rhs, dim=1)
    del a, res
    torch.cuda.empty_cache()
    log(f"bem sweep {label}: residual ||A p - b||/||b|| per frequency "
        f"{[float(f'{float(r):.3e}') for r in rel]}")
    if float(rel.max()) > 1e-4:
        raise AssertionError(f"bem sweep {label}: residual {float(rel.max()):.3e} > 1e-4")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_sweep = statistics.median(times)
    log(f"bem sweep {label} steady state: median {t_sweep * 1e3:.2f} ms of "
        f"{[round(t * 1e3, 2) for t in times]} ms, bem_dense_solves_per_s {nf / t_sweep:.2f}")
    return launches, run


def bem_answers_phase(ops, dev):
    """N=1280: kernels vs twins and GMRES vs LU on the card; N=320 float64:
    the card vs the CPU."""
    import torch

    from mathaudio_tpu_torch.bem import sweep
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere

    inc = plane_wave((0.0, 0.0, 1.0))
    mesh = icosphere(1.0, 3)
    st = sweep.sweep_statics(mesh, dtype=torch.float32, device=dev)
    ks = torch.linspace(*BEM_BAND, 4, dtype=torch.float32, device=dev)
    for bm in (False, True):
        betas, rhs = sweep.sweep_inputs(mesh, st, ks, inc, burton_miller=bm)
        p_k = sweep.sweep_apply(st, ks, betas, rhs, burton_miller=bm, **BEM_GMRES)
        p_lu = sweep.sweep_apply(st, ks, betas, rhs, burton_miller=bm, solver="lu")
        kernel = ops.bem_pairwise
        ops.bem_pairwise = twin_pairwise(ops)
        try:
            p_t = sweep.sweep_apply(st, ks, betas, rhs, burton_miller=bm, **BEM_GMRES)
        finally:
            ops.bem_pairwise = kernel
        e_twin, e_lu = rel_rows(p_k, p_t), rel_rows(p_k, p_lu)
        log(f"bem N={mesh.num_elements} F=4 burton_miller={bm}: kernels vs twins {e_twin:.3e}, "
            f"GMRES vs LU {e_lu:.3e} (tol 1e-4)")
        if e_twin > 1e-4 or e_lu > 1e-4:
            raise AssertionError("bem sweep with kernels disagrees with the twins or with LU")

    mesh = icosphere(1.0, 2)
    ks64 = torch.linspace(*BEM_BAND, 4, dtype=torch.float64)
    sts = {w: sweep.sweep_statics(mesh, dtype=torch.float64, device=w) for w in (dev, "cpu")}
    for bm in (False, True):
        for solver in ("lu", "gmres"):
            out = []
            for where, st in sts.items():
                k = ks64.to(st.centers.device)
                betas, rhs = sweep.sweep_inputs(mesh, st, k, inc, burton_miller=bm)
                out.append(sweep.sweep_apply(st, k, betas, rhs, burton_miller=bm,
                                             solver=solver).cpu())
            err = rel_rows(out[0], out[1])
            log(f"bem f64 N={mesh.num_elements} F=4 burton_miller={bm} {solver}: card vs CPU {err:.3e} "
                f"(tol 1e-9)")
            if err > 1e-9:
                raise AssertionError("float64 BEM sweep on the card disagrees with the CPU")


def bem_path(dev, counters):
    """Paths 2 and 3: the dense BEM sweep and the single-frequency BEM
    engines. Returns the kernel-line records and the paths' runs as
    callables for the profiler."""
    import torch

    from mathaudio_tpu_torch.bem import sweep
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.ops import bem_assembly as ops

    t0 = time.perf_counter()
    mesh = icosphere(1.0, BEM_SUBDIV)
    statics = sweep.sweep_statics(mesh, dtype=torch.float32, device=dev)
    statics64 = sweep.sweep_statics(icosphere(1.0, 2), dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    log(f"bem host build subdiv={BEM_SUBDIV}: {mesh.num_elements} elements, "
        f"nq={statics.qp.shape[1]}, {time.perf_counter() - t0:.2f} s")

    records = bem_kernel_phase(ops, statics, statics64, dev)

    ks = torch.linspace(*BEM_BAND, BEM_FREQS, dtype=torch.float32, device=dev)
    inc = plane_wave((0.0, 0.0, 1.0))
    rigid, run_rigid = bem_sweep_phase("rigid", False, mesh, statics, ks, inc, counters)
    if rigid["double_layer"] == 0 or rigid["burton_miller"] != 0:
        raise AssertionError(f"the rigid sweep did not run through the double-layer kernel alone: {rigid}")
    bm, run_bm = bem_sweep_phase("burton_miller", True, mesh, statics, ks, inc, counters)
    if bm["burton_miller"] == 0:
        raise AssertionError(f"the Burton-Miller sweep did not launch its kernel: {bm}")
    records["double_layer"]["launches"] = rigid["double_layer"]
    records["burton_miller"]["launches_at_shape"] = bm["burton_miller"]

    bem_answers_phase(ops, dev)
    runs = {"bem_rigid": run_rigid, "bem_burton_miller": run_bm}

    # 8-10. path 3, the single-frequency BEM engines
    records.update(single_k_kernel_phase(ops, statics, statics64, dev))
    log(f"kernel bodies: {body_phase(ops, statics, dev)} checks passed")
    del statics, statics64
    torch.cuda.empty_cache()
    launches, by_case, runs3 = path3(dev, counters)
    for variant in MIXED_VARIANTS + FIELD_VARIANTS:
        records[variant]["launches"] = launches.get(variant, 0)
    # path 3 (c) launches ``burton_miller`` at one wavenumber, phase 5's F = 1 record
    records["burton_miller"]["other_shapes"][0]["launches"] = by_case["c"]["burton_miller"]
    records["burton_miller"]["launches"] = bm["burton_miller"] + launches.get("burton_miller", 0)
    # of the launches of ``kh``, the cavity's are at its own shape
    records["kh"]["other_shapes"][0]["launches"] = by_case["d"]["kh"]
    records["kh"]["launches_at_shape"] = records["kh"]["launches"] - by_case["d"]["kh"]
    for case, variant in (("a", "kh"), ("c", "kh_double"), ("c", "burton_miller"), ("d", "kh")):
        if by_case[case][variant] != 1:
            raise AssertionError(f"path 3 ({case}): {variant} was not one launch at the shape "
                                 f"phases 5 and 8 held it at: {by_case[case]}")
    path3_answers(ops, dev)
    runs.update(runs3)
    return records, runs


def field_points():
    from mathaudio_tpu_torch.bem.postprocess import generate_sphere_eval_points

    return generate_sphere_eval_points(2.0, *FIELD_SHAPE)


def single_k_kernel_phase(ops, statics, statics64, dev):
    """Phase 8: the mixed and Kirchhoff-Helmholtz variants vs their twins
    at path 3's shapes (float32, one wavenumber, timed, with bounds), at a
    ragged shape with three wavenumbers, at large arguments, and in
    float64. Returns per-variant records at the path's shapes."""
    import torch

    twin = twin_pairwise(ops)
    points = torch.tensor(field_points(), dtype=torch.float32, device=dev)
    inside = torch.tensor(cavity_inputs(0)[3], dtype=torch.float32, device=dev)

    def args(variant, st, pts, ni, nj, ks):
        """Mixed variants: the surface's first ni collocation points against
        its first nj elements; field variants: the first ni of ``pts``."""
        ks = torch.tensor(ks, dtype=st.centers.dtype, device=dev)
        if variant in FIELD_VARIANTS:
            x, nx = pts[:ni].to(st.centers.dtype).contiguous(), None
        else:
            x, nx = st.centers[:ni], st.normals[:ni]
        return x, nx, st.qp[:nj], st.normals[:nj], st.qw[:nj], ks

    def check(label, variant, a, tol):
        got = ops.bem_pairwise(variant, *a)
        ref = twin(variant, *a)
        torch.cuda.synchronize()
        return compare_planes(label, variant, got, ref, tol,
                              off_diagonal=variant in MIXED_VARIANTS)

    def held(variant, pts):
        """One record: ``variant`` at its path's pairs (the surface's own
        points, or the field points ``pts``, against its N elements), one
        wavenumber, float32, held against its twin, timed and bounded."""
        ni = pts.shape[0] if variant in FIELD_VARIANTS else n
        return bem_kernel_record(f"f32 {ni} x {n} F=1", ops, twin, variant,
                                 args(variant, statics, pts, ni, n, [PATH3_KA]),
                                 off_diagonal=variant in MIXED_VARIANTS)

    records = {}
    n = statics.centers.shape[0]
    n64 = statics64.centers.shape[0]
    large = [LARGE_K / 3, 2 * LARGE_K / 3, LARGE_K]
    for variant in MIXED_VARIANTS + FIELD_VARIANTS:
        # the field of (a) and (c) is one launch at every point; (d) gives
        # ``kh`` its interior points
        records[variant] = held(variant, points)
        if variant == "kh":
            records[variant]["other_shapes"] = [held(variant, inside)]
        # ragged rows, columns and frequency groups
        check("f32 300 x 333 F=3", variant,
              args(variant, statics, points, 300, 333, [0.5, 1.75, 3.0]), 1e-5)
        check(f"f32 300 x 333 F=3 k<={LARGE_K:g}", variant,
              args(variant, statics, points, 300, 333, large), 1e-5)
        x, nx, *_, ks = args(variant, statics, points, 1280, n, large)
        far_field_check(f"f32 1280 x {n} nq=1 F=3 k<={LARGE_K:g}", ops, twin, variant, x, nx,
                        statics, ks)
        check(f"f64 {n64} x {n64} F=3", variant,
              args(variant, statics64, points, n64, n64, [0.5, 1.75, 3.0]), 1e-12)
        check(f"f64 {n64} x {n64} F=3 k<={LARGE_K:g}", variant,
              args(variant, statics64, points, n64, n64, large), 1e-12)
    return records


def body_phase(ops, statics, dev):
    """Phase 8, the kernel's bodies as the launcher picks them: every
    variant at each nq of BODY_NQ and each (rows, elements) of BODY_SHAPES
    (the bench sphere's, cast to float32 and float64), with k of BODY_KS in
    one launch and, for the sweep's variants, k = 50 alone (the row walk at
    F = 1; the band body at F = 3), held against its twin (float32 <= 1e-5,
    float64 <= 1e-12 per plane, the surface's own points off the diagonal);
    the far-field check at one wavenumber (k = 50, the row walk at nq 1);
    and the row walk's radius (one MUFU.RSQ for r and 1/r) against sqrtf at
    every float32. Returns the number of body checks."""
    import torch

    twin = twin_pairwise(ops)
    points = torch.tensor(field_points(), dtype=torch.float32, device=dev)
    bad = ops.radius_mismatches(dev)
    log(f"kernel radius: {bad} of 2^32 floats r^2 where the row walk's r or 1/r differs in a "
        f"bit from sqrtf / rsqrtf (must be 0)")
    if bad:
        raise AssertionError(f"the row walk's r is not sqrtf at {bad} floats")
    checks = 0
    for variant in BEM_PLANES:
        field = variant in FIELD_VARIANTS
        bands = (BODY_KS, (LARGE_K,)) if variant in ("double_layer", "burton_miller") else (BODY_KS,)
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            worst = 0.0
            for (ni, nj), nq, band in itertools.product(BODY_SHAPES, BODY_NQ, bands):
                x = points[:ni] if field else statics.centers[:ni]
                nx = None if field else statics.normals[:ni].to(dtype)
                a = (x.to(dtype).contiguous(), nx, statics.qp[:nj, :nq].to(dtype).contiguous(),
                     statics.normals[:nj].to(dtype), statics.qw[:nj, :nq].to(dtype).contiguous(),
                     torch.tensor(band, dtype=dtype, device=dev))
                ref = twin(variant, *a)
                got = ops.bem_pairwise(variant, *a)
                torch.cuda.synchronize()
                for plane, g, r in zip(BEM_PLANES[variant], got, ref):
                    if plane is None:
                        continue
                    if not field:
                        g, r = _zero_diagonal(g.clone()), _zero_diagonal(r.clone())
                    rel = float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r))
                    if not rel <= tol:
                        raise AssertionError(f"{variant} {dtype} {ni} x {nj} nq={nq} F={len(band)} "
                                             f"{plane}: kernel disagrees with its twin ({rel:.3e})")
                    worst = max(worst, rel)
                checks += 1
                del got, ref
            log(f"kernel bodies {variant} {str(dtype).replace('torch.', '')} {BODY_SHAPES} nq "
                f"{BODY_NQ} F {sorted({len(b) for b in bands})} k<={LARGE_K:g}: worst plane rel "
                f"err {worst:.3e} (tol {tol:g})")
        x = points[:1280] if field else statics.centers[:1280]
        far_field_check(f"f32 1280 x {statics.centers.shape[0]} nq=1 F=1 k={LARGE_K:g}", ops, twin,
                        variant, x, None if field else statics.normals[:1280], statics,
                        torch.tensor([LARGE_K], device=dev))
    torch.cuda.empty_cache()
    return checks


def pulsating_exact(points, k):
    """Closed form of the pulsating sphere of radius 1 and unit surface
    velocity (e^{-i omega t}, outgoing waves):
    p(r) = i rho c ka/(i ka - 1) (1/r) e^{ik(r - 1)}, at |points|."""
    import numpy as np

    r = np.linalg.norm(points, axis=-1)
    return 1j * RHO * C_SOUND * k / (1j * k - 1.0) / r * np.exp(1j * k * (r - 1.0))


def cavity_exact(r, k):
    """Closed form of the rigid spherical cavity of radius 1 with a unit
    monopole at its centre: G(r) + A j0(kr), with A chosen so that dp/dr
    vanishes on the wall."""
    import numpy as np

    gp = (1j * k - 1.0) * np.exp(1j * k) / (4 * np.pi)
    j0p = (k * np.cos(k) - np.sin(k)) / k**2
    amp = -gp / (k * j0p)
    return np.exp(1j * k * r) / (4 * np.pi * r) + amp * np.sin(k * r) / (k * r)


def rel_l2(got, want):
    import numpy as np

    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def median_ms(fn, repeats=3):
    """Median wall milliseconds of ``fn`` over synchronised repeats."""
    import torch

    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mixed_pulsating_problem(subdiv):
    """Path 3 (a): velocity 1 on the upper hemisphere, the analytic
    pressure on the lower. Returns (problem, upper mask, exact pressure)."""
    import numpy as np

    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.solver import BemProblem
    from mathaudio_tpu_torch.bem.types import BoundaryCondition, PhysicsParams

    mesh = icosphere(1.0, subdiv)
    exact = pulsating_exact(mesh.centers, PATH3_KA)
    upper = mesh.centers[:, 2] >= 0.0
    bc = BoundaryCondition(types=np.where(upper, 0, 1).astype(np.int32),
                           values=np.where(upper, 1.0 + 0.0j, exact))
    problem = BemProblem(mesh=mesh, physics=PhysicsParams.from_wave_number(PATH3_KA),
                         incident=None, bc=bc)
    return problem, upper, exact


def cavity_inputs(subdiv):
    """Path 3 (d): (mesh, frequency, sources, interior points)."""
    import math

    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.postprocess import generate_sphere_eval_points
    from mathaudio_tpu_torch.common.source import Source
    from mathaudio_tpu_torch.common.types import Point3D

    f = PATH3_KA * C_SOUND / (2 * math.pi)
    src = Source.omnidirectional(Point3D(0.0, 0.0, 0.0), 1.0)
    return icosphere(1.0, subdiv), f, [src], generate_sphere_eval_points(0.5, *CAVITY_SHAPE)


def gmres_config(burton_miller):
    from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod

    return BemSolverConfig(method=SolverMethod.GMRES, burton_miller=burton_miller,
                           tolerance=PATH3_GMRES_TOL)


def counted(label, counters, run, dev, path="path 3"):
    """``run()`` once with every launch count set to 0 just before and read
    just after; returns (result, launches)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: v for c in counters for k, v in c.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    log(f"{path} {label}: counted run {seconds:.3f} s, peak memory {peak:.2f} GiB, launches {launches}")
    return out, launches


def need_launches(label, launches, wanted):
    for variant in wanted:
        if launches.get(variant, 0) == 0:
            raise AssertionError(f"path 3 {label} did not launch the {variant} kernel: {launches}")


def gate(label, what, err, limit):
    log(f"path 3 {label}: {what} rel L2 {err:.3e} (limit {limit:g})")
    if not err <= limit:
        raise AssertionError(f"path 3 {label}: {what} error {err:.3e} above {limit:g}")


def path3(dev, counters, subdiv=BEM_SUBDIV, dtype=None):
    """Phase 9: the single-frequency BEM paths (a)-(d) through their entry
    points. Returns (launches summed over the four, launches of each,
    callables for the profiler)."""
    import numpy as np
    import torch

    from mathaudio_tpu_torch.bem import assembly, room_acoustics
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.solvers.direct import lu_solve
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
    from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner

    dtype = dtype or torch.float32
    where = dict(dtype=dtype, device=dev)
    pts = field_points()
    total, by_case = {}, {}

    def add(case, launches):
        by_case[case] = launches
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def krylov(a, b):
        cfg = KrylovConfig(max_iterations=1000, tolerance=PATH3_GMRES_TOL, restart=50)
        return gmres(a, b, config=cfg, preconditioner=jacobi_preconditioner(torch.diagonal(a)))

    def report(label, solve, assemble, linear, field, info):
        """The whole solve and the field evaluation through the entry
        points; beside them the solve's two stages, each timed apart
        through the functions the entry point calls: ``assemble`` returns
        the system (A, b), ``linear`` solves it."""
        t_solve, t_asm = median_ms(solve), median_ms(assemble)
        a, b = assemble()[:2]
        t_lin = median_ms(lambda: linear(a, b))
        del a, b
        t_field = "none" if field is None else f"{median_ms(field):.2f} ms"
        log(f"path 3 {label} steady state (medians of 3): solve {t_solve:.2f} ms (assembly alone "
            f"{t_asm:.2f} ms, linear solve alone {t_lin:.2f} ms: {info.get('method')}, "
            f"iterations {info.get('iterations', '-')}), field evaluation {t_field}")

    # (a) mixed pulsating sphere, Burton-Miller -> mixed_bm, then the field -> kh
    problem, upper, exact = mixed_pulsating_problem(subdiv)
    solver = BemSolver(gmres_config(True), **where)
    k = problem.physics.wave_number

    def run_a():
        sol = solver.solve(problem)
        return sol, sol.evaluate_pressure_field(pts)

    (sol, field), launches = counted("(a) mixed pulsating sphere", counters, run_a, dev)
    need_launches("(a)", launches, ("mixed_bm", "kh"))
    add("a", launches)
    n = problem.mesh.num_elements
    if not sol.info["converged"]:
        raise AssertionError(f"path 3 (a): GMRES did not converge: {sol.info}")
    if tuple(sol.surface_pressure.shape) != (n,) or tuple(field.p_total.shape) != (len(pts),):
        raise AssertionError("path 3 (a): bad output shapes")
    p, q = sol.surface_pressure.cpu().numpy(), sol.surface_q.cpu().numpy()
    gate("(a)", f"surface pressure on {int(upper.sum())} velocity elements",
         rel_l2(p[upper], exact[upper]), 2e-2)
    q_exact = np.full(n, 1j * k * C_SOUND * RHO)
    gate("(a)", f"dp/dn on {int((~upper).sum())} pressure elements",
         rel_l2(q[~upper], q_exact[~upper]), 2e-2)
    gate("(a)", f"field at {len(pts)} points on r = 2", rel_l2(field.p_total, pulsating_exact(pts, k)),
         2e-2)
    beta = solver.burton_miller_beta(problem)
    report("(a)", lambda: solver.solve(problem),
           lambda: assembly.assemble_mixed_system(
               problem.mesh, k, problem.bc, beta=beta, quad_order=solver.config.quad_order, **where),
           krylov, lambda: sol.evaluate_pressure_field(pts), sol.info)
    t_host = median_ms(lambda: assembly._mesh_tensors(problem.mesh, solver.config.quad_order,
                                                      dtype, dev))
    log(f"path 3 (a): of the assembly, the mesh tensors (numpy quadrature points and self-element "
        f"rule, copied to the card) take {t_host:.2f} ms")
    runs = {"bem_mixed_pulsating": run_a}

    # (b) radiating sphere without Burton-Miller -> mixed
    prob_b = BemProblem.radiating_sphere(PATH3_KA, subdivisions=subdiv)
    solver_b = BemSolver(gmres_config(False), **where)
    sol_b, launches = counted("(b) radiating sphere", counters, lambda: solver_b.solve(prob_b), dev)
    need_launches("(b)", launches, ("mixed",))
    add("b", launches)
    if not sol_b.info["converged"]:
        raise AssertionError(f"path 3 (b): GMRES did not converge: {sol_b.info}")
    gate("(b)", "surface pressure", rel_l2(sol_b.surface_pressure,
                                           pulsating_exact(prob_b.mesh.centers, PATH3_KA)), 5e-2)
    report("(b)", lambda: solver_b.solve(prob_b),
           lambda: assembly.assemble_mixed_system(
               prob_b.mesh, PATH3_KA, prob_b.bc, quad_order=solver_b.config.quad_order, **where),
           krylov, None, sol_b.info)

    # (c) rigid sphere, Burton-Miller -> burton_miller, then the field -> kh_double
    prob_c = BemProblem.rigid_sphere(PATH3_RIGID_KA, subdivisions=subdiv)
    solver_c = BemSolver(gmres_config(True), **where)

    def run_c():
        s = solver_c.solve(prob_c)
        return s, s.evaluate_pressure_field(pts)

    (sol_c, field_c), launches = counted("(c) rigid sphere", counters, run_c, dev)
    need_launches("(c)", launches, ("burton_miller", "kh_double"))
    add("c", launches)
    if not sol_c.info["converged"]:
        raise AssertionError(f"path 3 (c): GMRES did not converge: {sol_c.info}")
    if not (bool(torch.isfinite(sol_c.surface_pressure).all())
            and bool(torch.isfinite(field_c.p_total).all())):
        raise AssertionError("path 3 (c): non-finite pressures")
    kc, beta_c = prob_c.physics.wave_number, solver_c.burton_miller_beta(prob_c)
    a = assembly.assemble_burton_miller(prob_c.mesh, kc, beta_c, **where)
    if not bool(torch.isfinite(a).all()):
        raise AssertionError("path 3 (c): the assembled matrix is not finite")
    centers = torch.tensor(prob_c.mesh.centers, **where)
    normals = torch.tensor(prob_c.mesh.normals, **where)
    b = prob_c.incident.pressure(centers, kc) - beta_c * prob_c.incident.normal_derivative(
        centers, normals, kc)
    res = float(torch.linalg.vector_norm(a @ sol_c.surface_pressure - b)
                / torch.linalg.vector_norm(b))
    del a
    torch.cuda.empty_cache()
    gate("(c)", "residual ||A p - b||/||b||", res, 1e-4)
    report("(c)", lambda: solver_c.solve(prob_c),
           lambda: (assembly.assemble_burton_miller(prob_c.mesh, kc, beta_c, **where), b),
           krylov, lambda: sol_c.evaluate_pressure_field(pts), sol_c.info)

    # (d) interior cavity, LU -> mixed, then the interior field -> kh
    mesh_d, f_d, sources, inside = cavity_inputs(subdiv)

    def run_d():
        s = room_acoustics.solve_room_bem(mesh_d, f_d, sources, admittance=0.0, method="lu",
                                          **where)
        return s, s.evaluate_pressure(inside)

    (sol_d, p_in), launches = counted("(d) interior cavity", counters, run_d, dev)
    need_launches("(d)", launches, ("mixed", "kh"))
    add("d", launches)
    gate("(d)", "wall pressure",
         rel_l2(sol_d.surface_pressure, np.full(mesh_d.num_elements, cavity_exact(1.0, PATH3_KA))),
         2e-2)
    gate("(d)", f"field at {len(inside)} interior points",
         rel_l2(p_in, cavity_exact(np.linalg.norm(inside, axis=1), PATH3_KA)), 2e-2)
    def assemble_d():
        # with the mesh tensors built on the host, as in (a)-(c)
        t = assembly._mesh_tensors(mesh_d, 3, dtype, dev)
        return (room_acoustics._room_matrix(*t, sol_d.k, sol_d.admittance),
                room_acoustics._source_pressure(t[0], sources, sol_d.k, f_d))

    report("(d)", lambda: room_acoustics.solve_room_bem(mesh_d, f_d, sources, method="lu", **where),
           assemble_d, lu_solve, lambda: sol_d.evaluate_pressure(inside), sol_d.info)
    runs["bem_room_cavity"] = run_d
    return total, by_case, runs


def path3_answers(ops, dev):
    """Phase 10: (a) and (d) at N=1280 with the kernels vs with the twins on
    the card, and at N=320 in float64 on the card vs on the CPU."""
    import torch

    from mathaudio_tpu_torch.bem import room_acoustics
    from mathaudio_tpu_torch.bem.solver import BemSolver

    pts = field_points()[::16]

    def answers(subdiv, dtype, where):
        problem, _, _ = mixed_pulsating_problem(subdiv)
        sol = BemSolver(gmres_config(True), dtype=dtype, device=where).solve(problem)
        mesh, f, sources, inside = cavity_inputs(subdiv)
        room = room_acoustics.solve_room_bem(mesh, f, sources, method="lu", dtype=dtype,
                                             device=where)
        return {"(a) surface p": sol.surface_pressure, "(a) surface q": sol.surface_q,
                "(a) field": sol.evaluate_pressure(pts), "(d) wall p": room.surface_pressure,
                "(d) interior field": room.evaluate_pressure(inside)}

    def compare(label, got, want, tol):
        for name in got:
            g, w = got[name].cpu(), want[name].cpu()
            err = float(torch.max(torch.abs(g - w)) / torch.max(torch.abs(w)))
            log(f"path 3 {label} {name}: max err {err:.3e} of max|.| (tol {tol:g})")
            if not err <= tol:
                raise AssertionError(f"path 3 {label} {name}: {err:.3e} above {tol:g}")

    with_kernels = answers(3, torch.float32, dev)
    kernel = ops.bem_pairwise
    ops.bem_pairwise = twin_pairwise(ops)
    try:
        with_twins = answers(3, torch.float32, dev)
    finally:
        ops.bem_pairwise = kernel
    compare("N=1280 kernels vs twins", with_kernels, with_twins, 1e-4)
    compare("f64 N=320 card vs CPU", answers(2, torch.float64, dev),
            answers(2, torch.float64, "cpu"), 1e-9)


# Slice 3 (phase 11): bench.py ``run_iir``'s cascade on the card: 8192
# channels x 10 PEAK stages (100 (i + 1) Hz, Q 1, (-1)^i 3 dB) x 48000
# samples, float32; ~10 operations per sample and stage (feedforward 5,
# recursion 4, the cast), under the bytes bound at this shape.
IIR_CHANNELS, IIR_STAGES, IIR_T, IIR_GATE_CHANNELS = 8192, 10, 48000, 64
IIR_OPS_PER_SAMPLE_STAGE = 10
# Phase 12: the auto-EQ path. (a) is the reference's own test
# (tests/test_dsp.py TestAutoEq): LS 120 Hz, PK 1800 Hz, HS 9000 Hz.
AUTOEQ_TRUTH = (("LOWSHELF", 120.0, 0.9, 4.0), ("PEAK", 1800.0, 1.5, -5.0),
                ("HIGHSHELF", 9000.0, 0.8, 2.5))
AUTOEQ_CLI_TRUTH = (("LOWSHELF", 90.0, 0.8, -4.0), ("PEAK", 210.0, 2.0, 5.0),
                    ("PEAK", 640.0, 1.2, -3.0), ("PEAK", 1500.0, 3.0, 2.5),
                    ("PEAK", 3300.0, 1.8, -4.5), ("PEAK", 6800.0, 2.5, 3.0),
                    ("HIGHSHELF", 11000.0, 0.7, -2.0))


def iir_phase(dev):
    """Phase 11: the biquad cascade at bench.py's shape, timed (a first run,
    then the median and minimum of 3 synchronised repeats) against its
    bound, then gated: 64 channels against scipy's sequential lfilter in
    float64 on the host (float32 <= 1e-3 of max|y|; float64 on the card
    <= 1e-9), and two half-blocks with carried state against the whole
    block on the card in float64 (<= 1e-12). Returns a callable for the
    profiler."""
    import numpy as np
    import scipy.signal as sps
    import torch

    from mathaudio_tpu_torch.dsp import (
        Biquad,
        BiquadFilterType,
        biquad_cascade_block,
        biquad_process_block,
        peq_coeff_matrix,
    )

    peq = [(1.0, Biquad(BiquadFilterType.PEAK, 100.0 * (i + 1), 48000.0, 1.0, (-1.0) ** i * 3.0))
           for i in range(IIR_STAGES)]
    t0 = time.perf_counter()
    x_host = np.random.default_rng(0).standard_normal((IIR_CHANNELS, IIR_T), dtype=np.float32)
    torch.cuda.empty_cache()
    x = torch.from_numpy(x_host).to(dev)
    cm = peq_coeff_matrix(peq, torch.float32, device=dev)
    torch.cuda.synchronize()
    log(f"iir: input {IIR_CHANNELS} x {IIR_T} float32 made and copied in "
        f"{time.perf_counter() - t0:.2f} s")

    def run():
        return biquad_cascade_block(x, cm)

    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = run()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if tuple(y.shape) != (IIR_CHANNELS, IIR_T) or y.dtype != torch.float32 or not bool(
            torch.isfinite(y).all()):
        raise AssertionError(f"iir: bad output {tuple(y.shape)} {y.dtype}")
    y_gate = y[:IIR_GATE_CHANNELS].double().cpu().numpy()
    del y
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med, best = statistics.median(times), min(times)
    samples = IIR_CHANNELS * IIR_STAGES * IIR_T
    nbytes = 2 * IIR_CHANNELS * IIR_T * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = samples * IIR_OPS_PER_SAMPLE_STAGE / PEAK_FLOPS["float32"] * 1e3
    log(f"iir cascade {IIR_CHANNELS} ch x {IIR_STAGES} stages x {IIR_T} samples float32: first run "
        f"{first_ms:.1f} ms, median {med:.1f} ms of {[round(t, 1) for t in times]} ms, min {best:.1f} ms")
    log(f"iir_biquad_cascade_msamples_per_s: {samples / (med / 1e3) / 1e6:.1f} (median), "
        f"{samples / (best / 1e3) / 1e6:.1f} (min, as bench.py counts); peak memory {peak:.2f} GiB")
    log(f"iir bound: bytes {nbytes / 1e9:.3f} GB -> {t_bytes:.3f} ms, operations "
        f"{samples * IIR_OPS_PER_SAMPLE_STAGE / 1e9:.2f} G -> {t_ops:.3f} ms; bound "
        f"{max(t_bytes, t_ops):.3f} ms by {'bytes' if t_bytes >= t_ops else 'operations'}; "
        f"median at {med / max(t_bytes, t_ops):.0f}x the bound; card {gpu_line()}")

    x_gate = x_host[:IIR_GATE_CHANNELS].astype(np.float64)
    want = x_gate
    for _, bq in peq:
        want = sps.lfilter([bq.b0, bq.b1, bq.b2], [1.0, bq.a1, bq.a2], want, axis=-1)
    scale = np.abs(want).max()
    x64 = torch.from_numpy(x_gate).to(dev)
    y64 = biquad_cascade_block(x64, peq_coeff_matrix(peq, torch.float64, device=dev))
    half = IIR_T // 2
    first, second = x64[:, :half], x64[:, half:]
    for _, bq in peq:
        coeffs = (bq.b0, bq.b1, bq.b2, bq.a1, bq.a2)
        first, state = biquad_process_block(first, coeffs)
        second, _ = biquad_process_block(second, coeffs, state)
    checks = (("float32 on the card vs scipy lfilter (float64, host)", y_gate, want, 1e-3),
              ("float64 on the card vs scipy lfilter", y64.cpu().numpy(), want, 1e-9),
              ("float64 two half-blocks with carried state vs the whole block",
               torch.cat([first, second], 1).cpu().numpy(), y64.cpu().numpy(), 1e-12))
    for what, got, ref, tol in checks:
        err = float(np.abs(got - ref).max() / scale)
        log(f"iir {IIR_GATE_CHANNELS} channels, {what}: max err {err:.3e} of max|y| (limit {tol:g})")
        if not err <= tol:
            raise AssertionError(f"iir: {what} off by {err:.3e} of max|y|")
    return run


def _peq_rows(rows):
    from mathaudio_tpu_torch.convert import peq_from_numpy

    return peq_from_numpy([(1.0, name, f, 48000.0, q, g) for name, f, q, g in rows])


def autoeq_phase(dev):
    """Phase 12: the auto-EQ path on the card. (a) fit_peq on the reference
    test's target (rms <= 0.35 dB, fitted response within 1 dB); (b) the
    autoeq CLI through main(argv) on a CSV made from a known 7-filter PEQ,
    with its defaults (-n 7 --maxiter 600): exit 0, the APO file parses
    back to 7 filters; (c) a second (a) from the same seed gives the same
    population. Returns a callable for the profiler."""
    import contextlib
    import io
    import os
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import autoeq
    from mathaudio_tpu_torch.dsp import peq_spl
    from mathaudio_tpu_torch.optim import fit_peq

    freqs = np.logspace(np.log10(20.0), np.log10(20000.0), 96)
    target = peq_spl(freqs, _peq_rows(AUTOEQ_TRUTH), device=dev).cpu().numpy()

    def fit(maxiter=500):
        return fit_peq(freqs, target, n_filters=3, maxiter=maxiter, seed=4, device=dev)

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    res, secs = timed(fit)
    rep = res.report
    fitted = res.response_db(freqs, device=dev).cpu().numpy()
    dev_db = float(np.abs(fitted - target).max())
    log(f"autoeq (a) fit_peq 3 filters, 96 points, npop {len(rep.population)}: {rep.nit} generations, "
        f"nfev {rep.nfev}, {secs:.2f} s, {secs * 1e3 / rep.nit:.2f} ms per generation; rms "
        f"{res.rms_error_db:.4f} dB (limit 0.35), max |fitted - target| {dev_db:.4f} dB (limit 1)")
    if not (res.rms_error_db <= 0.35 and dev_db <= 1.0):
        raise AssertionError("autoeq (a): the fit missed the reference test's limits")

    again, secs2 = timed(fit)
    same = np.array_equal(again.report.population, rep.population)
    log(f"autoeq (c) second fit from seed 4: {secs2:.2f} s, same population {same}")
    if not same:
        raise AssertionError("autoeq (c): the same seed gave another population on the card")

    cli_freqs = np.logspace(np.log10(20.0), np.log10(20000.0), 200)
    spl = 85.0 + peq_spl(cli_freqs, _peq_rows(AUTOEQ_CLI_TRUTH), device=dev).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        meas, apo = os.path.join(tmp, "speaker.csv"), os.path.join(tmp, "eq.txt")
        np.savetxt(meas, np.column_stack([cli_freqs, spl]), delimiter=",")
        argv = [meas, "--apo", apo, "--rme", os.path.join(tmp, "eq.xml"),
                "--aupreset", os.path.join(tmp, "eq.aupreset"), "--device", str(dev)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc, cli_secs = timed(lambda: autoeq.main(argv))
        with open(apo) as fh:
            apo_lines = fh.read().splitlines()
    result = json.loads(out.getvalue())
    filters = [ln for ln in apo_lines
               if re.match(r"Filter +\d+: ON (PK|LS|HS) Fc +\d+ Hz Gain [+-]\d+\.\d\d dB Q "
                           r"\d+\.\d\d$", ln)]
    log(f"autoeq (b) CLI -n 7 --maxiter 600 on {len(cli_freqs)} points: exit {rc}, {cli_secs:.2f} s, "
        f"rms {result['rms_error_db']:.4f} dB, APO {len(filters)} filters, {apo_lines[1]}")
    if rc != 0 or len(filters) != 7 or len(result["filters"]) != 7:
        raise AssertionError(f"autoeq (b): exit {rc}, {len(filters)} APO filters")
    return lambda: fit(maxiter=100)


# Phases 13-14: the BEM applications (slice 4b) on the card, with the
# oracles (slice 7a). Roomsim (a) is configs/small_room.json as users run
# it (auto tier: N = 896 elements, LU, 6 frequencies, 2 listening
# positions, absorbing walls); (b) is configs/nearfield_stereo.json at its
# own mesh_resolution 10 (N = 10440, 2 sources, 1 listening position,
# rigid walls) through the reference's ``--solver gmres``, at 8 of its 100
# log-spaced frequencies over its own 40-500 Hz: the one reduction.
REPO = Path(__file__).resolve().parent
ROOMSIM_SMALL = REPO / "configs" / "small_room.json"
ROOMSIM_WIDE = REPO / "configs" / "nearfield_stereo.json"
ROOMSIM_WIDE_FREQS = 8
ROOMSIM_CPU_DB, ROOMSIM_LU_DB = 0.01, 0.05  # SPL: the card vs the CPU in float64, GMRES vs LU
ROOMSIM_RESIDUAL = 1e-4  # ||A p - b|| / ||b|| of a frequency GMRES calls converged
TWIN_ROWS = 256  # the twin's rows where the whole shape's twin would not fit
# Phase 14: the QA suite's non-FMM cases at the reference's own ka and
# subdivisions (apps/qa_suite_bem.py main), by subdivision; each rel_l2
# within QA_REL of the recorded run's (qa_bem_results/, x64 on the CPU)
# plus QA_ABS.
QA_SUMMARY = REPO / "qa_bem_results" / "summary.json"
QA_REL, QA_ABS = 0.02, 1e-4
QA_THRESHOLD = 0.5  # apps/qa_suite_bem.py main's --threshold default
QA_CASES = {
    2: [("sphere_case", ka, {}) for ka in (0.1, 0.5, 1.0)]
       + [("sphere_case", 0.5, {"solver": s}) for s in ("lu", "gmres")]
       + [("pulsating_case", ka, {}) for ka in (0.5, 1.0, 2.0, math.pi)],
    3: [("sphere_case", ka, {}) for ka in (2.0, math.pi, 5.0)]
       + [("sphere_case", ka, {"solver": s}) for s in ("lu", "gmres") for ka in (2.0, 5.0)]
       + [("cavity_case", ka, {}) for ka in (1.0, 2.0)]
       + [("mixed_pulsating_case", 1.0, {})],
}
# The variants the QA cases launch, and the largest ka each launches at.
QA_VARIANTS = {"burton_miller": 5.0, "mixed": 2.0, "mixed_bm": 2.0}


def _quiet(fn, *args, **kw):
    """``fn`` with its standard output and error swallowed."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        return fn(*args, **kw)


def room_kernel_records(ops, dev, mesh, k, points, launches, twin_rows=None, graph_calls=10):
    """``mixed`` at a room mesh's own pairs and ``kh`` at its listening
    ``points`` (float32, one wavenumber ``k``), held against their twins
    (``mixed`` off the diagonal, on its first ``twin_rows`` rows when given),
    timed and bounded: {variant: record}."""
    import torch

    from mathaudio_tpu_torch.bem.assembly import _mesh_tensors

    twin = twin_pairwise(ops)
    centers, normals, qp, qw, _, _ = _mesh_tensors(mesh, 3, torch.float32, dev)
    ks = torch.tensor([k], dtype=torch.float32, device=dev)
    x = torch.tensor(points, dtype=torch.float32, device=dev)
    n = mesh.num_elements
    out = {
        "mixed": bem_kernel_record(f"f32 {n} x {n} F=1", ops, twin, "mixed",
                                   (centers, normals, qp, normals, qw, ks), True,
                                   twin_rows=twin_rows, graph_calls=graph_calls),
        "kh": bem_kernel_record(f"f32 {len(points)} x {n} F=1", ops, twin, "kh",
                                (x, None, qp, normals, qw, ks), False),
    }
    for variant, record in out.items():
        record["launches"] = launches.get(variant, 0)
    return out


def roomsim_phase(ops, dev, counters):
    """Phase 13: the roomsim CLI on the card. (a) small_room.json through
    main(argv) with the auto tier: the JSON parses back to 6 results, finite
    SPL, every frequency converged, SPL within ROOMSIM_CPU_DB of the same
    run on the CPU in float64. (b) nearfield_stereo.json (N = 10440) through
    run_bem_simulation with solver="gmres" at 8 frequencies: each
    frequency's true residual ||A p - b||/||b|| <= ROOMSIM_RESIDUAL where
    GMRES called it converged (printed with its iterations either way), SPL
    at 40 and 500 Hz within ROOMSIM_LU_DB of solver="direct" (LU); the solve
    at 40 and 500 Hz split into mesh tensors, assembly, linear solve and
    field. Each run's launches are counted; ``mixed`` and ``kh`` are held
    against their twins at both shapes. Returns ({variant: [records]},
    callables for the profiler)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import roomsim_bem
    from mathaudio_tpu_torch.bem import assembly, room_acoustics
    from mathaudio_tpu_torch.common.config import FrequencySpec, RoomConfig
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
    from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner
    from mathaudio_tpu_torch.xtypes import full_f32_matmul

    # (a) small_room.json as users run it
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "room.json")

        def run_a():
            return _quiet(roomsim_bem.main, [str(ROOMSIM_SMALL), "-o", out])

        rc, launches_a = counted("(a) small_room.json main", counters, run_a, dev, path="roomsim")
        need_launches("roomsim (a)", launches_a, ("mixed", "kh"))
        with open(out) as fh:
            got = json.load(fh)
        wall_a = median_ms(run_a)
    cfg_a = RoomConfig.from_file(str(ROOMSIM_SMALL))
    spl = np.array([r["spl_db"] for r in got["results"]])
    conv = [r["converged"] for r in got["results"]]
    n_a = got["metadata"]["num_elements"]
    log(f"roomsim (a) {ROOMSIM_SMALL.name}: exit {rc}, N = {n_a}, {len(got['results'])} frequencies, "
        f"converged {conv}, app wall {wall_a:.1f} ms (median of 3), per-frequency solve "
        f"{[round(r['solve_time_s'] * 1e3, 2) for r in got['results']]} ms")
    if rc != 0 or spl.shape != (6, 2) or not np.isfinite(spl).all() or not all(conv):
        raise AssertionError(f"roomsim (a): exit {rc}, SPL {spl.shape}, converged {conv}")
    cpu = roomsim_bem.run_bem_simulation(cfg_a, verbose=0, dtype=torch.float64, device="cpu")
    err = float(np.abs(spl - np.array([r.spl_db for r in cpu.results])).max())
    log(f"roomsim (a): SPL on the card (float32) vs the CPU (float64) max diff {err:.3e} dB "
        f"(limit {ROOMSIM_CPU_DB:g})")
    if not err <= ROOMSIM_CPU_DB:
        raise AssertionError(f"roomsim (a): SPL off the CPU's by {err:.3e} dB")
    sim_a = cfg_a.to_simulation()
    mesh_a = sim_a.geometry.generate_mesh(cfg_a.solver.mesh_resolution).to_surface_mesh()
    lp_a = np.asarray([p.to_array() for p in sim_a.listening_positions])
    k_a = 2 * math.pi * float(sim_a.frequencies[-1]) / C_SOUND
    records = {v: [r] for v, r in room_kernel_records(ops, dev, mesh_a, k_a, lp_a, launches_a).items()}

    # (b) nearfield_stereo.json at full width, GMRES
    spec = RoomConfig.from_file(str(ROOMSIM_WIDE)).frequencies

    def wide(lo, hi, num):
        """The wide room with ``num`` of its log-spaced frequencies over [lo, hi]."""
        c = RoomConfig.from_file(str(ROOMSIM_WIDE))
        c.frequencies = FrequencySpec(lo, hi, num, spec.spacing)
        return c

    cfg = wide(spec.min_freq, spec.max_freq, ROOMSIM_WIDE_FREQS)
    solutions, solve = [], roomsim_bem.solve_room_bem

    def keep(*args, **kw):
        solutions.append(solve(*args, **kw))
        return solutions[-1]

    roomsim_bem.solve_room_bem = keep  # the app's own solutions, for the residuals
    try:
        res, launches_b = counted(f"(b) {ROOMSIM_WIDE.name} gmres", counters,
                                  lambda: roomsim_bem.run_bem_simulation(cfg, verbose=0, solver="gmres",
                                                                         device=dev),
                                  dev, path="roomsim")
    finally:
        roomsim_bem.solve_room_bem = solve
    need_launches("roomsim (b)", launches_b, ("mixed", "kh"))
    mesh, n = solutions[0].mesh, solutions[0].mesh.num_elements
    sim = cfg.to_simulation()
    lp = np.asarray([p.to_array() for p in sim.listening_positions])
    log(f"roomsim (b) {ROOMSIM_WIDE.name}: N = {n}, {len(res.results)} of its {spec.num_points} "
        f"frequencies ({spec.min_freq:g}-{spec.max_freq:g} Hz, log), {len(sim.sources)} sources, "
        f"{len(lp)} listening position(s), wall admittance {res.metadata['wall_admittance']:g}; app "
        f"wall {sum(r.solve_time_s for r in res.results):.3f} s in the frequency loop")
    spl_b = np.array([r.spl_db for r in res.results])
    if spl_b.shape != (ROOMSIM_WIDE_FREQS, len(lp)) or not np.isfinite(spl_b).all():
        raise AssertionError(f"roomsim (b): SPL {spl_b.shape} not finite")
    t = assembly._mesh_tensors(mesh, 3, torch.float32, dev)
    rb = assembly._resolve_row_block(None, n, t[2].shape[1], t[0], "mixed")

    def system(sol):
        a = room_acoustics._room_matrix(*t, sol.k, sol.admittance, rb)
        return a, room_acoustics._source_pressure(t[0], sim.sources, sol.k, sol.frequency)

    for sol, r in zip(solutions, res.results):
        a, b = system(sol)
        with full_f32_matmul():
            rel = float(torch.linalg.vector_norm(a @ sol.surface_pressure - b)
                        / torch.linalg.vector_norm(b))
        del a
        log(f"roomsim (b) f = {sol.frequency:.2f} Hz: converged {r.converged}, GMRES iterations "
            f"{r.iterations}, residual ||A p - b||/||b|| {rel:.3e}, solve {r.solve_time_s * 1e3:.1f} ms, "
            f"SPL {[round(v, 3) for v in r.spl_db]} dB")
        if r.converged and not rel <= ROOMSIM_RESIDUAL:
            raise AssertionError(f"roomsim (b) {sol.frequency:.2f} Hz: converged with residual {rel:.3e}")
    torch.cuda.empty_cache()

    lu = roomsim_bem.run_bem_simulation(wide(spec.min_freq, spec.max_freq, 2), verbose=0,
                                        solver="direct", device=dev)
    for got_r, want_r in ((res.results[0], lu.results[0]), (res.results[-1], lu.results[-1])):
        err = float(np.abs(np.array(got_r.spl_db) - np.array(want_r.spl_db)).max())
        log(f"roomsim (b) {got_r.frequency:.2f} Hz: SPL GMRES vs LU (cuSOLVER) {err:.3e} dB "
            f"(limit {ROOMSIM_LU_DB:g}), LU solve {want_r.solve_time_s * 1e3:.1f} ms")
        if not err <= ROOMSIM_LU_DB:
            raise AssertionError(f"roomsim (b) {got_r.frequency:.2f} Hz: GMRES off LU by {err:.3e} dB")
    torch.cuda.empty_cache()

    krylov = KrylovConfig(max_iterations=1000, tolerance=1e-8, restart=50)  # solve_room_bem's
    for sol in (solutions[0], solutions[-1]):
        a, b = system(sol)
        info = gmres(a, b, config=krylov, preconditioner=jacobi_preconditioner(torch.diagonal(a)))
        t_mesh = median_ms(lambda: assembly._mesh_tensors(mesh, 3, torch.float32, dev))
        t_asm = median_ms(lambda: room_acoustics._room_matrix(*t, sol.k, sol.admittance, rb))
        t_lin = median_ms(lambda: gmres(a, b, config=krylov,
                                        preconditioner=jacobi_preconditioner(torch.diagonal(a))))
        del a
        torch.cuda.empty_cache()
        t_field = median_ms(lambda: sol.evaluate_pressure(lp))
        t_solve = median_ms(lambda: solve(mesh, sol.frequency, sim.sources,
                                          admittance=sol.admittance[0].item(), method="gmres",
                                          device=dev))
        log(f"roomsim (b) {sol.frequency:.2f} Hz steady state (medians of 3): solve {t_solve:.2f} ms = "
            f"mesh tensors {t_mesh:.2f} ms + assembly {t_asm:.2f} ms + linear solve {t_lin:.2f} ms "
            f"(GMRES {int(info.iterations)} iterations, converged {bool(info.converged)}) + rest; "
            f"field {t_field:.3f} ms")
    k_b = 2 * math.pi * spec.max_freq / C_SOUND
    for v, r in room_kernel_records(ops, dev, mesh, k_b, lp, launches_b, twin_rows=TWIN_ROWS,
                                    graph_calls=4).items():
        records[v].append(r)
    del solutions
    torch.cuda.empty_cache()

    one = wide(spec.max_freq, spec.max_freq, 1)
    runs = {"roomsim (a) small_room": lambda: roomsim_bem.run_bem_simulation(cfg_a, verbose=0,
                                                                            device=dev),
            f"roomsim (b) nearfield gmres {spec.max_freq:g} Hz":
                lambda: roomsim_bem.run_bem_simulation(one, verbose=0, solver="gmres", device=dev)}
    return records, runs


def qa_phase(ops, dev, counters):
    """Phase 14: the QA suite on the card. main(["--fast", "-o", tmp])
    exits 0; then the 19 non-FMM cases of its full list through the case
    functions at the reference's own ka and subdivisions, counted per
    subdivision (320 and 1280 elements), each rel_l2 within QA_REL of the
    recorded run's plus QA_ABS; the closed forms written out in this script
    against the port's oracles in float64 (<= 1e-12). The variants the cases
    launch are held against their twins at both shapes. Returns ({variant:
    [records]}, callables for the profiler)."""
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import qa_suite_bem as qa
    from mathaudio_tpu_torch.bem import sweep
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.wave.analytical.solutions_3d import pulsating_sphere_3d

    with open(QA_SUMMARY) as fh:
        recorded = {c["name"]: c["rel_l2"] for c in json.load(fh)["cases"]}
    by_subdiv = {}
    with tempfile.TemporaryDirectory() as tmp:
        rc, launches_fast = counted("main --fast", counters, lambda: _quiet(qa.main, ["--fast", "-o", tmp]),
                                    dev, path="qa")
        with open(f"{tmp}/summary.json") as fh:
            fast = json.load(fh)
        log(f"qa main --fast: exit {rc}, {fast['passed']}/{fast['total']} passed (threshold "
            f"{fast['threshold']:g}): " + ", ".join(f"{c['name']} {c['rel_l2']:.3e}" for c in fast["cases"]))
        if rc != 0:
            raise AssertionError(f"qa main --fast exited {rc}")
        need_launches("qa --fast", launches_fast, tuple(QA_VARIANTS))

        for subdiv, cases in QA_CASES.items():
            def run_cases():
                return [getattr(qa, fn)(ka, subdiv, tmp, 0, device=dev, **kw) for fn, ka, kw in cases]

            results, by_subdiv[subdiv] = counted(f"{len(cases)} cases at subdivision {subdiv}", counters,
                                                 run_cases, dev, path="qa")
            for r in results:
                got, want = r.metrics.l2_relative, recorded[r.name]
                limit = QA_REL * want + QA_ABS
                log(f"qa {r.name} (N = {r.metadata.num_dofs}, {r.metadata.solver}): rel_l2 {got:.6e}, "
                    f"recorded {want:.6e}, diff {abs(got - want):.3e} (limit {limit:.3e}), solve "
                    f"{r.metadata.wall_time_s * 1e3:.1f} ms")
                if not abs(got - want) <= limit:
                    raise AssertionError(f"qa {r.name}: rel_l2 {got:.6e} vs the recorded {want:.6e}")
                if r.name.startswith("cavity"):
                    ka = r.parameters["ka"]
                    want_p = complex(r.analytical.pressure_real[0], r.analytical.pressure_imag[0])
                    err = abs(cavity_exact(1.0, ka) - want_p) / abs(want_p)
                    log(f"qa closed form: cavity_exact(1, {ka:g}) vs cavity_case's {err:.3e} (limit 1e-12)")
                    if not err <= 1e-12:
                        raise AssertionError("the cavity's closed forms disagree")
    n_cases = sum(len(c) for c in QA_CASES.values())
    if n_cases != 19:
        raise AssertionError(f"{n_cases} QA cases, not the 19 without FMM")
    for pts, k in ((field_points(), PATH3_KA), (icosphere(1.0, 3).centers, math.pi)):
        want = pulsating_exact(pts, k)
        got = pulsating_sphere_3d(k, 1.0, pts, dtype=torch.float64, device=dev).pressure.cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        log(f"qa closed form: pulsating_exact vs pulsating_sphere_3d at {len(pts)} points, ka "
            f"{k:g}: {err:.3e} (limit 1e-12)")
        if not err <= 1e-12:
            raise AssertionError("the pulsating sphere's closed forms disagree")

    records = {v: [] for v in QA_VARIANTS}
    twin = twin_pairwise(ops)
    for subdiv in QA_CASES:
        st = sweep.sweep_statics(icosphere(1.0, subdiv), dtype=torch.float32, device=dev)
        n = st.centers.shape[0]
        for v, ka in QA_VARIANTS.items():
            ks = torch.tensor([ka], dtype=torch.float32, device=dev)
            r = bem_kernel_record(f"f32 {n} x {n} F=1", ops, twin, v,
                                  (st.centers, st.normals, st.qp, st.normals, st.qw, ks), True)
            r["launches"] = by_subdiv[subdiv].get(v, 0) + (launches_fast.get(v, 0) if subdiv == 2 else 0)
            records[v].append(r)

    def run_fast():
        with tempfile.TemporaryDirectory() as tmp:
            return _quiet(qa.main, ["--fast", "-o", tmp])

    return records, {"qa main --fast": run_fast}


# Phase 15: the single-level FMM (slice 5a) on the card. (a) is bench.py's
# slfmm tier at its full shape (bench.py:523-567, 637-661): the N = 5120
# icosphere, k = 8, Burton–Miller beta = i/k, stability_tau 1e4, float32
# aggregation phases, a float64 build cast to complex64 in gather form,
# ClusterBlockPreconditioner, GMRES restart 48 tol 1e-5 at most 200
# iterations, a plane wave along +z. (b) the QA suite's three slfmm cases at
# the reference's ka and subdivisions; (c) configs/nearfield_stereo.json
# under ``auto`` (the FMM tier at N = 10440), cut to 40 and 500 Hz; (d) the
# FMM field evaluation against the dense one at path 3's 8192 points.
FMM_SUBDIV, FMM_K = 4, 8.0
FMM_GMRES = dict(max_iterations=200, tolerance=1e-5, restart=48)
FMM_MATVEC_TOL = 1e-3  # complex64 vs float64 on the card (bench.py:637-638's gate)
FMM_MIE_TOL, FMM_ITER_TOL = 1e-3, 2  # complex64 vs float64 solve: Mie error, iterations
FMM_QA_CASES = ((0.5, 2), (2.0, 3), (5.0, 3))  # apps/qa_suite_bem.py main's slfmm cases
FMM_ROOM_FREQS = (40.0, 500.0)  # 2 of phase 13 (b)'s 8 frequencies: the cut
FMM_ROOM_DB, FMM_ROOM_MATVEC = 0.1, 1e-3  # 40 Hz: SPL vs dense LU, matvec vs the dense matrix
FMM_FIELD_TOL = 1e-4  # float64 FMM field vs dense (tests/test_fmm.py:229)
# Build stages: functions of bem/fmm.py whose synchronised wall time each
# stage sums ("leaf level" includes the screen, which is reported with the
# translations).
FMM_STAGES = {"leaf level": ("_leaf_level",), "screen": ("_stable_far_orders",),
              "translations": ("_far_translations",),
              "aggregation": ("_agg_disagg_tensors", "_apply_bm_row_factor"),
              "near blocks": ("_near_blocks", "_near_blocks_mixed", "_room_near_blocks",
                              "_static_dlp_row_sums")}


def _timed_functions(module, groups):
    """Wrap ``module``'s functions so each call appends its synchronised
    wall seconds to its group's list: ({group: [seconds]}, restore)."""
    import torch

    calls = {g: [] for g in groups}
    saved = {}
    for group, names in groups.items():
        for name in names:
            saved[name] = getattr(module, name)

            def timed(*args, _fn=saved[name], _group=group, **kw):
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                torch.cuda.synchronize()
                calls[_group].append(time.perf_counter() - t0)
                return out

            setattr(module, name, timed)

    def restore():
        for name, fn in saved.items():
            setattr(module, name, fn)

    return calls, restore


def _build_split(calls, total):
    """The build seconds split: octree and lists, translations, aggregation,
    near blocks, the rest."""
    sums = {g: sum(v) for g, v in calls.items()}
    octree = sums["leaf level"] - sums["screen"]
    trans = sums["screen"] + sums["translations"]
    rest = total - octree - trans - sums["aggregation"] - sums["near blocks"]
    return (f"octree and lists {octree:.3f} s, translations {trans:.3f} s, aggregation "
            f"{sums['aggregation']:.3f} s, near blocks and row sums {sums['near blocks']:.3f} s, "
            f"rest {rest:.3f} s")


def device_launches(fn):
    """Device activities (kernels, copies, memsets) of one ``fn()`` call, in
    a profiler trace after a discarded warm-up step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=schedule) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def fmm_matvec_record(label, op, x):
    """Time ``op.matvec(x)`` from Python and from a CUDA graph beside the
    byte bound of the tensors it reads (each once) and the vector it
    writes: a dict for the log and PERF.md."""
    nbytes = fmm_data_bytes(op.data) + 2 * x.numel() * x.element_size()
    rec = dict(ms=time_ms(lambda: op.matvec(x)), graph_ms=graph_ms(lambda: op.matvec(x)),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, gbytes=nbytes / 1e9,
               launches=device_launches(lambda: op.matvec(x)))
    d = op.data
    log(f"fmm {label} matvec: C = {d.clusters.shape[0]}, m = {d.clusters.shape[1]}, "
        f"Q = {d.quad_w.shape[0]}, near pairs {d.near_b.shape[0]}, {rec['gbytes']:.3f} GB read and "
        f"written; {rec['ms']:.4f} ms from Python, {rec['graph_ms']:.4f} ms in a CUDA graph, byte "
        f"bound {rec['bound_ms']:.4f} ms, {rec['launches']} device launches per matvec")
    return rec


def _mie_surface(mesh, k, dev, terms=30, radius=1.0):
    """Mie total pressure of the rigid unit sphere under a +z plane wave, at
    ``radius`` and the element centers' polar angles, with ``terms`` terms."""
    import numpy as np
    import torch

    from mathaudio_tpu_torch.wave.analytical import sphere_scattering_3d

    c = mesh.centers
    theta = np.arccos(np.clip(c[:, 2] / np.linalg.norm(c, axis=1), -1, 1))
    return sphere_scattering_3d(k, 1.0, terms, [radius], theta, dtype=torch.float64,
                                device=dev).pressure.reshape(-1).cpu().numpy()


def _rigid_rhs(mesh, incident, k, beta, where):
    """The rigid right-hand side p_inc (- beta dp_inc/dn) at the centers."""
    import torch

    centers = torch.tensor(mesh.centers, **where)
    b = incident.pressure(centers, k)
    if beta != 0.0:
        normals = torch.tensor(mesh.normals, **where)
        b = b - beta * incident.normal_derivative(centers, normals, k)
    return b


def fmm_phase(ops, dev, counters, subdiv=FMM_SUBDIV, room=ROOMSIM_WIDE, room_solver="auto",
              qa_cases=FMM_QA_CASES, field_shape=FIELD_SHAPE):
    """Phase 15: the FMM on the card, (a)-(d) above. Returns ({variant:
    launches} of its counted run, callables for the profiler)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import qa_suite_bem as qa
    from mathaudio_tpu_torch.apps import roomsim_bem
    from mathaudio_tpu_torch.bem import assembly, fmm, room_acoustics
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.postprocess import (
        evaluate_field,
        evaluate_field_fmm,
        generate_sphere_eval_points,
    )
    from mathaudio_tpu_torch.common.config import RoomConfig
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
    from mathaudio_tpu_torch.solvers.preconditioners import ilu
    from mathaudio_tpu_torch.xtypes import full_f32_matmul

    t_phase = time.perf_counter()
    c64, f64 = torch.complex64, torch.float64
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    log(f"fmm: TF32 matmul allowed {tf32[0]}, float32 matmul precision {tf32[1]!r}")
    if tf32 != (False, "highest"):
        raise AssertionError(f"the FMM needs true float32 products, not TF32: {tf32}")

    # (a) bench.py's slfmm tier
    mesh = icosphere(1.0, subdiv)
    n, k, beta = mesh.num_elements, FMM_K, 1j / FMM_K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stages, restore = _timed_functions(fmm, FMM_STAGES)  # {stage: [seconds]}
    try:
        t0 = time.perf_counter()
        op64 = fmm.build_slfmm_system(mesh, k, beta=beta, stability_tau=1e4, agg_phase_f32=True,
                                      dtype=f64, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        restore()
    t0 = time.perf_counter()
    pre64 = fmm.ClusterBlockPreconditioner.from_operator(op64)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    log(f"fmm (a) N = {n}, k = {k:g}, beta = i/k: float64 build {t_build:.3f} s on the card "
        f"({_build_split(stages, t_build)}), ClusterBlockPreconditioner {t_pre:.3f} s")
    op64g = fmm.gather_form(op64)
    op32, pre32 = fmm.gather_form(op64.to(c64)), pre64.to(c64)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n), device=dev)
    y64 = op64g.matvec(x)
    err = rel_l2(op32.matvec(x.to(c64)).to(y64.dtype), y64.cpu().numpy())
    log(f"fmm (a) complex64 matvec vs the float64 one on the card: rel {err:.3e} "
        f"(limit {FMM_MATVEC_TOL:g})")
    if not err <= FMM_MATVEC_TOL:
        raise AssertionError(f"fmm (a): complex64 matvec off by {err:.3e}")
    mv_a = fmm_matvec_record(f"(a) N = {n} complex64 gather", op32, x.to(c64))

    inc = plane_wave((0.0, 0.0, 1.0))
    rhs = _rigid_rhs(mesh, inc, k, beta, {"dtype": f64, "device": dev})
    mie = _mie_surface(mesh, k, dev, max(60, int(2 * k) + 20),
                       float(np.linalg.norm(mesh.centers, axis=1).mean()))
    config = KrylovConfig(**FMM_GMRES)
    sol64 = gmres(op64g, rhs, config=config, preconditioner=pre64)

    def solve32():
        return gmres(op32, rhs.to(c64), config=config, preconditioner=pre32)

    sol32 = solve32()
    t_solve = median_ms(solve32)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    it64, it32 = int(sol64.iterations), int(sol32.iterations)
    mie64, mie32 = rel_l2(sol64.x, mie), rel_l2(sol32.x, mie)
    log(f"fmm (a) GMRES: float64 {it64} iterations (converged {bool(sol64.converged)}), complex64 "
        f"{it32} (converged {bool(sol32.converged)}); surface pressure vs Mie rel L2 float64 "
        f"{mie64:.4e}, complex64 {mie32:.4e} (diff limit {FMM_MIE_TOL:g}); complex64 solve "
        f"{t_solve:.2f} ms (median of 3 after a warm run), {1e3 / t_solve:.2f} solves/s; peak "
        f"memory {peak:.2f} GiB")
    if not (bool(sol32.converged) and abs(mie32 - mie64) <= FMM_MIE_TOL
            and abs(it32 - it64) <= FMM_ITER_TOL):
        raise AssertionError(f"fmm (a): complex64 solve converged {bool(sol32.converged)}, Mie "
                             f"{mie32:.4e} vs {mie64:.4e}, iterations {it32} vs {it64}")

    # (d) the FMM field evaluation against the dense one, on (a)'s sphere
    pts = generate_sphere_eval_points(2.0, *field_shape)
    fields = {}
    for name, p, dt in (("float64", sol64.x, f64), ("complex64", sol32.x, torch.float32)):
        dense = evaluate_field(mesh, p, pts, k, inc, dtype=dt, device=dev)
        fast = evaluate_field_fmm(mesh, p, pts, k, inc, dtype=dt, device=dev)
        fields[name] = rel_l2(fast.p_total, dense.p_total.cpu().numpy())
        t_dense = median_ms(lambda: evaluate_field(mesh, p, pts, k, inc, dtype=dt, device=dev))
        t_fast = median_ms(lambda: evaluate_field_fmm(mesh, p, pts, k, inc, dtype=dt, device=dev))
        log(f"fmm (d) {name}: evaluate_field_fmm vs evaluate_field at {len(pts)} points on r = 2, "
            f"rel L2 {fields[name]:.3e}; FMM {t_fast:.2f} ms, dense {t_dense:.2f} ms (medians of 3)")
    if not fields["float64"] <= FMM_FIELD_TOL:
        raise AssertionError(f"fmm (d): float64 FMM field off by {fields['float64']:.3e}")
    del op64, op64g, pre64, y64
    torch.cuda.empty_cache()

    # (b) the QA suite's slfmm cases
    with open(QA_SUMMARY) as fh:
        recorded = {cs["name"]: cs["rel_l2"] for cs in json.load(fh)["cases"]}
    with tempfile.TemporaryDirectory() as tmp:
        for ka, sub in qa_cases:
            r = qa.sphere_case(ka, sub, tmp, 0, "slfmm", device=dev)
            got, want = r.metrics.l2_relative, recorded[r.name]
            limit = QA_REL * want + QA_ABS
            log(f"fmm (b) qa {r.name} (N = {r.metadata.num_dofs}, {r.metadata.solver}): rel_l2 "
                f"{got:.6e}, recorded {want:.6e}, diff {abs(got - want):.3e} (limit {limit:.3e}), "
                f"solve {r.metadata.wall_time_s * 1e3:.1f} ms")
            if not abs(got - want) <= limit:
                raise AssertionError(f"fmm (b) qa {r.name}: rel_l2 {got:.6e} vs the recorded {want:.6e}")

    # (c) roomsim under auto on the wide room, at two of its frequencies
    spec = json.loads(Path(room).read_text())
    spec["frequencies"] = dict(spec["frequencies"], min_freq=FMM_ROOM_FREQS[0],
                               max_freq=FMM_ROOM_FREQS[1], num_points=len(FMM_ROOM_FREQS))
    solutions, solve_fmm = [], roomsim_bem._solve_room_fmm

    def keep(*args, **kw):
        solutions.append(solve_fmm(*args, **kw))
        return solutions[-1]

    split, restore = _timed_functions(roomsim_bem, {
        "build": ("build_room_fmm_system",), "preconditioner": ("near_ilu_preconditioner",),
        "gmres": ("gmres",)})
    split_csr, restore_csr = _timed_functions(fmm, {"near csr": ("near_field_csr",)})
    split_ilu, restore_ilu = _timed_functions(ilu, {"factor": ("ilu0_factor",)})
    roomsim_bem._solve_room_fmm = keep
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, out = os.path.join(tmp, "room.json"), os.path.join(tmp, "out.json")
        Path(cfg_path).write_text(json.dumps(spec))
        try:
            rc, launches = counted(f"(c) {Path(room).name} {room_solver}", counters,
                                   lambda: _quiet(roomsim_bem.main, [cfg_path, "-o", out,
                                                                     "--solver", room_solver]),
                                   dev, path="fmm")
        finally:
            roomsim_bem._solve_room_fmm = solve_fmm
            for undo in (restore, restore_csr, restore_ilu):
                undo()
        got = json.loads(Path(out).read_text())
    need_launches("fmm (c)", launches, ("kh",))
    spl = np.array([r["spl_db"] for r in got["results"]])
    res = got["results"]
    n_room = got["metadata"]["num_elements"]
    log(f"fmm (c) {Path(room).name}: exit {rc}, N = {n_room}, tier "
        f"{solutions[0].info['method'] if solutions else 'not fmm'}, {len(res)} frequencies")
    if rc != 0 or len(solutions) != len(FMM_ROOM_FREQS) or not np.isfinite(spl).all():
        raise AssertionError(f"fmm (c): exit {rc}, {len(solutions)} FMM solves, SPL {spl.tolist()}")
    for i, (sol, r) in enumerate(zip(solutions, res)):
        pre_rest = split["preconditioner"][i] - split_csr["near csr"][i] - split_ilu["factor"][i]
        log(f"fmm (c) f = {sol.frequency:.2f} Hz: converged {r['converged']}, GMRES iterations "
            f"{r['iterations']}; solve {r['solve_time_s'] * 1e3:.1f} ms = build "
            f"{split['build'][i] * 1e3:.1f} ms + near-field CSR (host) "
            f"{split_csr['near csr'][i] * 1e3:.1f} ms + ILU(0) factor (host C++) "
            f"{split_ilu['factor'][i] * 1e3:.1f} ms + factors to the card {pre_rest * 1e3:.1f} ms + "
            f"GMRES {split['gmres'][i] * 1e3:.1f} ms + rest; SPL {[round(v, 4) for v in r['spl_db']]} dB")
    if not res[0]["converged"]:
        raise AssertionError("fmm (c): GMRES did not converge at the lowest frequency")
    f_lo = solutions[0].frequency
    cfg_lo = RoomConfig.from_dict(dict(spec, frequencies=dict(spec["frequencies"], min_freq=f_lo,
                                                              max_freq=f_lo, num_points=1)))
    lu = roomsim_bem.run_bem_simulation(cfg_lo, verbose=0, solver="direct", device=dev)
    err_db = float(np.abs(np.array(res[0]["spl_db"]) - np.array(lu.results[0].spl_db)).max())
    log(f"fmm (c) {f_lo:.2f} Hz: SPL FMM vs dense LU on the card {err_db:.3e} dB (limit "
        f"{FMM_ROOM_DB:g})")
    if not err_db <= FMM_ROOM_DB:
        raise AssertionError(f"fmm (c): SPL off the dense LU by {err_db:.3e} dB")
    room_mesh, k_lo = solutions[0].mesh, solutions[0].k
    op_room = fmm.gather_form(fmm.build_room_fmm_system(
        room_mesh, k_lo, admittance=float(solutions[0].admittance[0]), dtype=f64,
        stability_tau=1e4, device=dev).to(c64))
    t = assembly._mesh_tensors(room_mesh, 3, torch.float32, dev)
    rb = assembly._resolve_row_block(None, n_room, t[2].shape[1], t[0], "mixed")
    a = room_acoustics._room_matrix(*t, k_lo, solutions[0].admittance.float(), rb)
    xr = torch.as_tensor(rng.standard_normal(n_room) + 1j * rng.standard_normal(n_room),
                         device=dev).to(c64)
    with full_f32_matmul():
        want = (a @ xr).cpu().numpy()
    err_mv = rel_l2(op_room.matvec(xr), want)
    log(f"fmm (c) {f_lo:.2f} Hz: FMM matvec vs the dense matrix ({a.numel() * 8 / 1e9:.2f} GB, "
        f"complex64) rel L2 {err_mv:.3e} (limit {FMM_ROOM_MATVEC:g})")
    del a
    torch.cuda.empty_cache()
    if not err_mv <= FMM_ROOM_MATVEC:
        raise AssertionError(f"fmm (c): FMM matvec off the dense one by {err_mv:.3e}")
    mv_c = fmm_matvec_record(f"(c) N = {n_room} at {f_lo:.2f} Hz complex64 gather", op_room, xr)
    del op_room, solutions
    torch.cuda.empty_cache()
    log(f"fmm: phase 15 took {time.perf_counter() - t_phase:.1f} s")

    one = RoomConfig.from_dict(dict(spec, frequencies=dict(spec["frequencies"], min_freq=f_lo,
                                                           max_freq=f_lo, num_points=1)))
    runs = {"fmm (a) complex64 solve": solve32,
            f"fmm (c) roomsim {f_lo:.0f} Hz": lambda: roomsim_bem.run_bem_simulation(
                one, verbose=0, solver=room_solver, device=dev)}
    return launches, runs, (mv_a, mv_c)


# Phase 16: the multilevel FMM (slice 5b) on the card. (a) is bench.py's
# mlfmm tier at its full shape (bench.py:523-661): the N = 20480 icosphere
# (subdivision 5), k = 16, CBIE, the MLFMM tree with max_per_leaf 32,
# stability_tau 1e4 and float32 aggregation phases, built in float64 and cast
# to complex64 in gather form, ClusterBlockPreconditioner, the cluster-major
# GMRES (restart 36, tol 1e-5, at most 200 iterations), a plane wave along +z;
# the selection form's matvec timed beside the gather form's. (b) Burton–Miller
# beta = i/k at the same tier, unpreconditioned, restart 80, at most 400
# iterations (bench.py:680-731, its gate). (c) examples/mlfmm_large_solve.py
# stages 1-2 at N = 5120, k = 2: the tree matvec (and the two-level MLFMM's)
# against the dense collocation matrix, the Burton–Miller tree against the
# dense Burton–Miller matrix, and the GMRES iterations of the tree against the
# SLFMM's, both cluster-block preconditioned. (d) the QA suite's three mlfmm
# cases. (e) the example's stage 4: the mixed-BC tree on a pulsating sphere at
# N = 20480, ka = 1.3, float64 end to end.
MLFMM_SUBDIV, MLFMM_K = 5, 16.0
MLFMM_BUILD = dict(max_per_leaf=32, stability_tau=1e4, agg_phase_f32=True)
MLFMM_GMRES = dict(max_iterations=200, tolerance=1e-5, restart=36)
MLFMM_BM_GMRES, MLFMM_BM_MIE = dict(max_iterations=400, tolerance=1e-5, restart=80), 1e-2
MLFMM_DENSE_SUBDIV, MLFMM_DENSE_K = 4, 2.0
MLFMM_DENSE_GMRES = dict(max_iterations=400, tolerance=1e-6, restart=60)
MLFMM_DENSE_TOL, MLFMM_ITER_RATIO = 0.5, 2.0  # examples/mlfmm_large_solve.py's gates
MLFMM_QA_CASES = ((0.5, 2), (2.0, 3), (5.0, 3))  # apps/qa_suite_bem.py main's mlfmm cases
MLFMM_MIXED_KA, MLFMM_MIXED_TOL = 1.3, 0.05
MLFMM_MIXED_GMRES = dict(max_iterations=400, tolerance=1e-7, restart=60)
# Build stages: functions of bem/fmm.py whose synchronised wall time each
# stage sums ("skeleton" includes the screen, the translations and the
# interpolations, which are reported on their own).
MLFMM_STAGES = {"skeleton": ("_tree_skeleton",), "screen": ("_stable_far_orders",),
                "translations": ("_translation_padded",),
                "interpolations": ("sphere_interp_matrix",),
                "aggregation": ("_agg_disagg_tensors", "_apply_bm_row_factor"),
                "near blocks": ("_near_blocks", "_static_dlp_row_sums")}


def fmm_data_bytes(data):
    """Bytes of the tensors an FMM operator's matvec reads, each once: every
    tensor of its data, levels included, but a level's pair gather table
    where the level reduces through its selection matrix instead."""
    total = 0
    for name, v in zip(data._fields, data):
        if v is None:
            continue
        if hasattr(v, "_fields"):
            total += fmm_data_bytes(v)
        elif isinstance(v, tuple):
            total += sum(fmm_data_bytes(lv) for lv in v)
        elif not (name == "trans_of_tgt" and getattr(data, "sel", None) is not None):
            total += v.numel() * v.element_size()
    return total


def _tree_split(calls, total):
    """The tree build's seconds split: octree and lists, screen, translations,
    interpolations, aggregation, near blocks and row sums, the rest."""
    sums = {g: sum(v) for g, v in calls.items()}
    octree = sums["skeleton"] - sums["screen"] - sums["translations"] - sums["interpolations"]
    rest = total - sums["skeleton"] - sums["aggregation"] - sums["near blocks"]
    return (f"octree, lists, shifts and transfers {octree:.3f} s, screen {sums['screen']:.3f} s, "
            f"translations {sums['translations']:.3f} s, interpolations "
            f"{sums['interpolations']:.3f} s, aggregation {sums['aggregation']:.3f} s, near blocks "
            f"and row sums {sums['near blocks']:.3f} s, rest {rest:.3f} s")


def _tree_shape(op):
    """Per level: nodes C, directions Q, far pairs translated there."""
    return "; ".join(f"level {i}: C = {lv.parent.shape[0]}, Q = {lv.trans_op.shape[1]}, "
                     f"{lv.trans_op.shape[0]} pairs" for i, lv in enumerate(op.data.levels))


def mlfmm_phase(ops, dev, counters, subdiv=MLFMM_SUBDIV, k=MLFMM_K, dense_subdiv=MLFMM_DENSE_SUBDIV,
                qa_cases=MLFMM_QA_CASES):
    """Phase 16: the MLFMM on the card, (a)-(e) above. Returns ({variant:
    launches} of its counted runs, the double_layer record of (c),
    callables for the profiler, the matvec records)."""
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import qa_suite_bem as qa
    from mathaudio_tpu_torch.bem import assembly, fmm, sweep
    from mathaudio_tpu_torch.bem.fmm_chip import fmm_chip_solve_cm_fn
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.types import BoundaryCondition
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
    from mathaudio_tpu_torch.wave.analytical.solutions_3d import pulsating_sphere_3d
    from mathaudio_tpu_torch.xtypes import full_f32_matmul

    t_phase = time.perf_counter()
    c64, f64 = torch.complex64, torch.float64
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    log(f"mlfmm: TF32 matmul allowed {tf32[0]}, float32 matmul precision {tf32[1]!r}")
    if tf32 != (False, "highest"):
        raise AssertionError(f"the MLFMM needs true float32 products, not TF32: {tf32}")
    inc = plane_wave((0.0, 0.0, 1.0))
    rng = np.random.default_rng(0)

    def surface(mesh, beta):
        """(rhs in float64 on the card, Mie surface pressure) for ``mesh``."""
        rhs = _rigid_rhs(mesh, inc, k, beta, {"dtype": f64, "device": dev})
        mie = _mie_surface(mesh, k, dev, max(60, int(2 * k) + 20),
                           float(np.linalg.norm(mesh.centers, axis=1).mean()))
        return rhs, mie

    # (a) bench.py's mlfmm tier
    mesh = icosphere(1.0, subdiv)
    n = mesh.num_elements
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    stages, restore = _timed_functions(fmm, MLFMM_STAGES)  # {stage: [seconds]}
    try:
        t0 = time.perf_counter()
        op64 = fmm.build_mlfmm_tree_system(mesh, k, **MLFMM_BUILD, dtype=f64, device=dev)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
    finally:
        restore()
    t0 = time.perf_counter()
    pre64 = fmm.ClusterBlockPreconditioner.from_operator(op64)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t0
    d = op64.data
    log(f"mlfmm (a) N = {n}, k = {k:g}, CBIE: float64 build {t_build:.3f} s on the card "
        f"({_tree_split(stages, t_build)}), ClusterBlockPreconditioner {t_pre:.3f} s; leaves C = "
        f"{d.clusters.shape[0]}, m = {d.clusters.shape[1]}, Q = {d.quad_w.shape[0]}, near pairs "
        f"{d.near_b.shape[0]}; {_tree_shape(op64)}")
    t0 = time.perf_counter()
    op64g = fmm.gather_form(op64)
    op32 = fmm.gather_form(op64.to(c64))
    sel32 = fmm.sel_form(op64.to(c64))
    pre32 = pre64.to(c64)
    torch.cuda.synchronize()
    log(f"mlfmm (a) gather and selection forms, complex64 casts: {time.perf_counter() - t0:.3f} s")
    x = torch.as_tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n), device=dev)
    y64 = op64g.matvec(x).cpu().numpy()
    records = {}
    for form, op in (("gather", op32), ("sel", sel32)):
        err = rel_l2(op.matvec(x.to(c64)), y64)
        log(f"mlfmm (a) complex64 {form} matvec vs the float64 one on the card: rel {err:.3e} "
            f"(limit {FMM_MATVEC_TOL:g})")
        if not err <= FMM_MATVEC_TOL:
            raise AssertionError(f"mlfmm (a): complex64 {form} matvec off by {err:.3e}")
        records[form] = fmm_matvec_record(f"(a) N = {n} complex64 {form}", op, x.to(c64))
    del sel32
    torch.cuda.empty_cache()

    rhs, mie = surface(mesh, 0.0)
    solve = fmm_chip_solve_cm_fn(KrylovConfig(**MLFMM_GMRES))
    x64, it64, conv64 = solve(op64g, pre64, rhs)

    def solve32():
        return solve(op32, pre32, rhs.to(c64))

    peak = torch.cuda.max_memory_allocated(dev)  # the build's and the float64 solve's
    (x32, it32, conv32), launches_a = counted("(a) complex64 cluster-major solve", counters, solve32,
                                              dev, path="mlfmm")
    t_solve = median_ms(solve32)
    peak = max(peak, torch.cuda.max_memory_allocated(dev)) / 2**30
    it64, it32 = int(it64), int(it32)
    mie64, mie32 = rel_l2(x64, mie), rel_l2(x32, mie)
    log(f"mlfmm (a) cluster-major GMRES: float64 {it64} iterations (converged {bool(conv64)}), "
        f"complex64 {it32} (converged {bool(conv32)}); surface pressure vs Mie rel L2 float64 "
        f"{mie64:.4e}, complex64 {mie32:.4e} (diff limit {FMM_MIE_TOL:g}); complex64 solve "
        f"{t_solve:.2f} ms (median of 3 after a warm run), {1e3 / t_solve:.3f} solves/s; peak "
        f"memory {peak:.2f} GiB; hand-written kernel launches {launches_a}")
    if not (bool(conv32) and abs(mie32 - mie64) <= FMM_MIE_TOL and abs(it32 - it64) <= FMM_ITER_TOL):
        raise AssertionError(f"mlfmm (a): complex64 solve converged {bool(conv32)}, Mie "
                             f"{mie32:.4e} vs {mie64:.4e}, iterations {it32} vs {it64}")
    profile_run("mlfmm (a) complex64 cluster-major solve", solve32, None)
    del op64, op64g, op32, pre64, pre32, x64, x32
    torch.cuda.empty_cache()

    # (b) Burton-Miller beta = i/k at the same tier, unpreconditioned
    beta = 1j / k
    t0 = time.perf_counter()
    op_bm = fmm.build_mlfmm_tree_system(mesh, k, beta=beta, **MLFMM_BUILD, dtype=f64, device=dev)
    op_bm = fmm.gather_form(op_bm.to(c64))
    torch.cuda.synchronize()
    t_bm_build = time.perf_counter() - t0
    rhs_bm, _ = surface(mesh, beta)
    config_bm = KrylovConfig(**MLFMM_BM_GMRES)

    def solve_bm():
        return gmres(op_bm, rhs_bm.to(c64), config=config_bm)

    sol_bm = solve_bm()
    t_bm = median_ms(solve_bm, repeats=1)
    mie_bm = rel_l2(sol_bm.x, mie)
    log(f"mlfmm (b) Burton-Miller beta = i/k: build {t_bm_build:.3f} s, GMRES (unpreconditioned, "
        f"restart 80) {int(sol_bm.iterations)} iterations, converged {bool(sol_bm.converged)}, "
        f"{t_bm:.1f} ms; surface pressure vs Mie rel L2 {mie_bm:.4e} (limit {MLFMM_BM_MIE:g})")
    if not (bool(sol_bm.converged) and mie_bm <= MLFMM_BM_MIE):
        raise AssertionError(f"mlfmm (b): converged {bool(sol_bm.converged)}, Mie {mie_bm:.4e}")
    del op_bm, sol_bm
    torch.cuda.empty_cache()

    # (c) accuracy against the dense matrices at N = 5120, k = 2
    kd = MLFMM_DENSE_K
    mesh4 = icosphere(1.0, dense_subdiv)
    n4 = mesh4.num_elements
    a_dense, launches_c = counted(f"(c) dense collocation matrix N = {n4}", counters, lambda: (
        assembly.assemble_collocation_matrix(mesh4, kd, dtype=torch.float32, device=dev)), dev,
        path="mlfmm")
    need_launches("mlfmm (c)", launches_c, ("double_layer",))
    x4 = torch.as_tensor(rng.standard_normal(n4) + 1j * rng.standard_normal(n4), device=dev)
    with full_f32_matmul():
        want = (a_dense @ x4.to(c64)).cpu().numpy()
    del a_dense
    ops_c = {}
    for label, build in (
            ("tree", lambda: fmm.build_mlfmm_tree_system(mesh4, kd, dtype=f64, device=dev)),
            ("two-level", lambda: fmm.build_mlfmm_system(mesh4, kd, dtype=f64, device=dev))):
        t0 = time.perf_counter()
        op = fmm.gather_form(build())
        torch.cuda.synchronize()
        err = rel_l2(op.matvec(x4), want)
        log(f"mlfmm (c) {label} matvec vs the dense collocation matrix at N = {n4}, k = {kd:g}: rel "
            f"{err:.3e} (limit {MLFMM_DENSE_TOL:g}); float64 build {time.perf_counter() - t0:.3f} s")
        if not err < MLFMM_DENSE_TOL:
            raise AssertionError(f"mlfmm (c): {label} matvec off the dense one by {err:.3e}")
        ops_c[label] = op
    beta4 = 1j / kd
    a_bm, launches_bm = counted(f"(c) dense Burton-Miller matrix N = {n4}", counters, lambda: (
        assembly.assemble_burton_miller(mesh4, kd, beta4, dtype=torch.float32, device=dev)), dev,
        path="mlfmm")
    need_launches("mlfmm (c)", launches_bm, ("burton_miller",))
    with full_f32_matmul():
        want_bm = (a_bm @ x4.to(c64)).cpu().numpy()
    del a_bm
    op_tbm = fmm.gather_form(fmm.build_mlfmm_tree_system(mesh4, kd, beta=beta4, dtype=f64,
                                                         device=dev))
    err = rel_l2(op_tbm.matvec(x4), want_bm)
    log(f"mlfmm (c) Burton-Miller (beta = i/k) tree matvec vs the dense Burton-Miller matrix: rel "
        f"{err:.3e} (limit {MLFMM_DENSE_TOL:g})")
    if not err < MLFMM_DENSE_TOL:
        raise AssertionError(f"mlfmm (c): Burton-Miller tree matvec off the dense one by {err:.3e}")
    del op_tbm
    its = {}
    rhs4 = inc.pressure(torch.tensor(mesh4.centers, dtype=f64, device=dev), kd)
    for label, op in (("slfmm", fmm.gather_form(fmm.build_slfmm_system(mesh4, kd, dtype=f64,
                                                                       device=dev))),
                      ("mlfmm tree", ops_c["tree"])):
        sol = gmres(op, rhs4, config=KrylovConfig(**MLFMM_DENSE_GMRES),
                    preconditioner=fmm.ClusterBlockPreconditioner.from_operator(op))
        its[label] = int(sol.iterations)
        log(f"mlfmm (c) {label} GMRES at N = {n4} (cluster-block preconditioner, tol 1e-6): "
            f"{its[label]} iterations, converged {bool(sol.converged)}")
        if not bool(sol.converged):
            raise AssertionError(f"mlfmm (c): the {label} GMRES did not converge")
    ratio = its["mlfmm tree"] / max(its["slfmm"], 1)
    log(f"mlfmm (c) iteration ratio tree / SLFMM {ratio:.2f} (limit {MLFMM_ITER_RATIO:g})")
    if not ratio < MLFMM_ITER_RATIO:
        raise AssertionError(f"mlfmm (c): the tree needs {ratio:.2f}x the SLFMM's iterations")
    del ops_c
    torch.cuda.empty_cache()
    twin = twin_pairwise(ops)
    st = sweep.sweep_statics(mesh4, dtype=torch.float32, device=dev)
    ks = torch.tensor([kd], dtype=torch.float32, device=dev)
    dl_record = bem_kernel_record(f"f32 {n4} x {n4} F=1", ops, twin, "double_layer",
                                  (st.centers, None, st.qp, st.normals, st.qw, ks), True)
    dl_record["launches"] = launches_c.get("double_layer", 0)
    launches = {v: launches_c.get(v, 0) + launches_bm.get(v, 0)
                for v in set(launches_c) | set(launches_bm)}

    # (d) the QA suite's mlfmm cases: in float64, the recorded run's precision
    # (the gate), and in float32, the app's default on the card (reported;
    # its screen, tau 1e4, truncates the tree's pair series)
    with open(QA_SUMMARY) as fh:
        recorded = {cs["name"]: cs["rel_l2"] for cs in json.load(fh)["cases"]}
    with tempfile.TemporaryDirectory() as tmp:
        for ka, sub in qa_cases:
            for dtype in (torch.float64, torch.float32):
                r = qa.sphere_case(ka, sub, tmp, 0, "mlfmm", dtype=dtype, device=dev)
                got, want_qa = r.metrics.l2_relative, recorded[r.name]
                limit = QA_REL * want_qa + QA_ABS
                log(f"mlfmm (d) qa {r.name} {str(dtype)[6:]} (N = {r.metadata.num_dofs}, "
                    f"{r.metadata.solver}): rel_l2 {got:.6e}, recorded {want_qa:.6e}, diff "
                    f"{abs(got - want_qa):.3e} (limit {limit:.3e} in float64; float32 reported, "
                    f"QA threshold {QA_THRESHOLD:g}), solve {r.metadata.wall_time_s * 1e3:.1f} ms")
                if dtype == torch.float64 and not abs(got - want_qa) <= limit:
                    raise AssertionError(f"mlfmm (d) qa {r.name}: rel_l2 {got:.6e} vs the recorded "
                                         f"{want_qa:.6e}")
                if not got <= QA_THRESHOLD:
                    raise AssertionError(f"mlfmm (d) qa {r.name} {dtype}: rel_l2 {got:.6e} fails "
                                         f"the QA suite's threshold")

    # (e) the mixed-BC tree: a pulsating sphere, float64 end to end
    ka_m = MLFMM_MIXED_KA
    bc = BoundaryCondition(types=np.zeros(n, np.int32), values=np.full(n, 1.0 + 0.0j))
    t0 = time.perf_counter()
    op_m, rhs_m, up = fmm.build_mlfmm_tree_mixed_system(mesh, ka_m, bc, dtype=f64, device=dev)
    op_m = fmm.gather_form(op_m)
    torch.cuda.synchronize()
    t_m_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol_m = gmres(op_m, rhs_m, config=KrylovConfig(**MLFMM_MIXED_GMRES))
    torch.cuda.synchronize()
    t_m = time.perf_counter() - t0
    exact = pulsating_sphere_3d(ka_m, 1.0, mesh.centers, velocity=1.0, dtype=f64,
                                device=dev).pressure.cpu().numpy()
    err_m = rel_l2(sol_m.x, exact)
    log(f"mlfmm (e) mixed tree, pulsating sphere N = {n}, ka = {ka_m:g}: float64 build "
        f"{t_m_build:.3f} s ({_tree_shape(op_m)}), GMRES {int(sol_m.iterations)} iterations, "
        f"converged {bool(sol_m.converged)}, {t_m:.3f} s; surface rel L2 {err_m:.3e} (limit "
        f"{MLFMM_MIXED_TOL:g})")
    if not (bool(up.all()) and bool(sol_m.converged) and err_m <= MLFMM_MIXED_TOL):
        raise AssertionError(f"mlfmm (e): converged {bool(sol_m.converged)}, rel L2 {err_m:.3e}")
    del op_m, sol_m
    torch.cuda.empty_cache()
    log(f"mlfmm: phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return launches, dl_record, records


# Phase 17: slices 6b and 6c, the general FEM problem and the solvers
# (apps/qa_suite_fem.py's full list and --fast; the BemSolver routes of the
# other Krylov solvers on path 3 (c)'s rigid sphere).
QA_FEM_SUMMARY = REPO / "qa_fem_results" / "summary.json"
QA_FEM_THRESHOLD = 0.1  # apps/qa_suite_fem.py main's --threshold default
QA_FEM_PRECONDITIONERS = ("AmgPreconditioner", "AdditiveSchwarz", "IluColored", "IluFixedPoint")
KRYLOV_ROUTES = ("bicgstab", "cgs", "qmrcgstab")
# Phase 18: the FEM room simulator (apps/roomsim_fem.py). (a) small_room.json
# uncut, complex64 against a float64 run on the card; (b) nearfield_stereo.json
# at its own mesh resolution with the cuts below, against a float64 sparse
# direct solve of the same assembled system.
ROOMSIM_FEM_DB = 0.05  # (a): complex64 vs float64 on the card
ROOMSIM_FEM_DIRECT_DB = 0.1  # (b): complex64 vs the float64 sparse direct solve
ROOMSIM_FEM_WIDE_CUTS = dict(frequencies=8, tolerance=1e-6, max_iter=100, batch_size=8)


def qa_fem_cases(qa):
    """(case function, ka, its two mesh sizes, solver) in the order of
    apps/qa_suite_fem.py main's full list: 21 cases."""
    cases = [("cylinder_case", 1.0, (24, 96), s) for s in qa.SOLVERS]
    for s in qa.SECOND_SOLVERS:
        cases += [("cylinder_case", 2.0, (32, 128), s), ("sphere_case", 1.0, (8, 2), s)]
    return cases


class _Recorded:
    """Stands in for a function or a class in a module's namespace: each
    call (of the function, the class, or a classmethod such as
    ``from_csr``) appends (name, synchronised seconds, result) to
    ``calls``."""

    def __init__(self, target, name, calls):
        self._target, self._name, self._calls = target, name, calls

    def _timed(self, fn, *args, **kw):
        import torch

        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self._calls.append((self._name, time.perf_counter() - t0, out))
        return out

    def __call__(self, *args, **kw):
        return self._timed(self._target, *args, **kw)

    def __getattr__(self, attr):
        return lambda *args, **kw: self._timed(getattr(self._target, attr), *args, **kw)


def _recording(module, names, calls):
    """Put a ``_Recorded`` in place of each of ``module``'s ``names``;
    returns restore()."""
    saved = {name: getattr(module, name) for name in names}
    for name, target in saved.items():
        setattr(module, name, _Recorded(target, name, calls))

    def restore():
        for name, target in saved.items():
            setattr(module, name, target)

    return restore


def qa_fem_phase(ops, dev, counters, cases=None, bem_subdiv=BEM_SUBDIV):
    """Phase 17 (path 10): (a) apps/qa_suite_fem.py's full list through its
    case functions on the card in float64, each rel_l2 within QA_REL of the
    recorded run's (qa_fem_results/) plus QA_ABS, then in float32 (the
    app's default, complex64) held to the threshold 0.1, and main --fast;
    per case the solve's ms, iterations, the preconditioner's set-up seconds
    and device launches per apply (colors of the colored ILU); (b) path 3
    (c)'s rigid sphere through BemSolver with BiCGStab, CGS and QMR-CGSTAB
    (Burton–Miller: one ``burton_miller`` launch each, counted, converged,
    residual ||A p - b||/||b|| <= 1e-4) and a rigid CBIE solve (one
    ``double_layer`` launch), both variants held against their twins at
    that shape. Returns ({variant: [records]}, callables for the profiler)."""
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import qa_suite_fem as qa
    from mathaudio_tpu_torch.bem import assembly, sweep
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod
    from mathaudio_tpu_torch.fem import problem as fem_problem
    from mathaudio_tpu_torch.solvers.preconditioners import IluColored

    t_phase = time.perf_counter()
    cases = qa_fem_cases(qa) if cases is None else cases
    with open(QA_FEM_SUMMARY) as fh:
        recorded = {c["name"]: c["rel_l2"] for c in json.load(fh)["cases"]}
    rng = np.random.default_rng(0)

    def run_cases(dtype, tmp):
        rows = []
        for fn, ka, sizes, solver in cases:
            calls = []
            restore = [_recording(qa, ("solve_helmholtz",), calls),
                       _recording(fem_problem, QA_FEM_PRECONDITIONERS, calls)]
            try:
                vr = getattr(qa, fn)(ka, *sizes, solver, tmp, verbose=0, dtype=dtype, device=dev)
            finally:
                for r in restore:
                    r()
            (_, solve_s, (_, info)), = [c for c in calls if c[0] == "solve_helmholtz"]
            pres = [c for c in calls if c[0] != "solve_helmholtz"]
            extra = ""
            if pres:
                name, setup_s, pre = pres[0]
                n = vr.parameters["n_nodes"]
                r = torch.tensor(rng.normal(size=n) + 1j * rng.normal(size=n),
                                 dtype=torch.complex128 if dtype == torch.float64 else torch.complex64,
                                 device=dev)
                # a profiler session can miss a short trace: the larger of two
                launches = max(device_launches(lambda: pre.matvec(r)) for _ in range(2))
                colors = f", {pre.n_colors} colors" if isinstance(pre, IluColored) else ""
                extra = (f", {name} set-up {setup_s:.3f} s, {launches} device launches per "
                         f"apply{colors}")
            rows.append((vr, info, solve_s))
            log(f"qa_fem {str(dtype)[6:]} {vr.name} (N = {vr.parameters['n_nodes']}): rel_l2 "
                f"{vr.metrics.l2_relative:.6e}, solve {solve_s * 1e3:.1f} ms, iterations "
                f"{info['iterations']}, converged {info['converged']}, residual "
                f"{info.get('residual', 0.0):.3e}{extra}")
        return rows

    with tempfile.TemporaryDirectory() as tmp:
        # (a) float64: the recorded run's precision
        rows64, launches = counted(f"{len(cases)} cases in float64", counters,
                                   lambda: run_cases(torch.float64, tmp), dev, path="qa_fem")
        for vr, info, _ in rows64:
            got, want = vr.metrics.l2_relative, recorded[vr.name]
            limit = QA_REL * want + QA_ABS
            log(f"qa_fem f64 {vr.name}: rel_l2 {got:.6e}, recorded {want:.6e}, diff "
                f"{abs(got - want):.3e} (limit {limit:.3e})")
            if not abs(got - want) <= limit:
                raise AssertionError(f"qa_fem {vr.name}: rel_l2 {got:.6e} vs the recorded {want:.6e}")
            if not info["converged"]:
                raise AssertionError(f"qa_fem {vr.name} float64 did not converge: {info}")
        # float32, the app's default on the card
        rows32, _ = counted(f"{len(cases)} cases in float32", counters,
                            lambda: run_cases(torch.float32, tmp), dev, path="qa_fem")
        for (vr64, _, s64), (vr, info, s32) in zip(rows64, rows32):
            got = vr.metrics.l2_relative
            log(f"qa_fem {vr.name}: rel_l2 float32 {got:.6e} beside float64 "
                f"{vr64.metrics.l2_relative:.6e} (threshold {QA_FEM_THRESHOLD:g}); solve ms "
                f"float32 {s32 * 1e3:.1f}, float64 {s64 * 1e3:.1f}")
            if not got < QA_FEM_THRESHOLD:
                raise AssertionError(f"qa_fem {vr.name} float32: rel_l2 {got:.3e}, {info}")
        if len(rows64) == 21 and {vr.name for vr, _, _ in rows64} != set(recorded):
            raise AssertionError("the QA FEM cases are not the recorded run's 21")
        rc, _ = counted("main --fast", counters, lambda: _quiet(qa.main, ["--fast", "-o", tmp]),
                        dev, path="qa_fem")
        with open(f"{tmp}/summary.json") as fh:
            fast = json.load(fh)
        log(f"qa_fem main --fast: exit {rc}, {fast['passed']}/{fast['total']} passed: "
            + ", ".join(f"{c['name']} {c['rel_l2']:.3e}" for c in fast["cases"]))
        if rc != 0:
            raise AssertionError(f"qa_fem main --fast exited {rc}")

    # (b) path 3 (c)'s rigid sphere through the new BemSolver routes
    prob = BemProblem.rigid_sphere(PATH3_RIGID_KA, subdivisions=bem_subdiv)
    where = dict(dtype=torch.float32, device=dev)
    k = prob.physics.wave_number
    counts = {"burton_miller": 0, "double_layer": 0}
    runs = {}
    for method, bm in [(m, True) for m in KRYLOV_ROUTES] + [("bicgstab", False)]:
        cfg = BemSolverConfig(method=SolverMethod(method), burton_miller=bm,
                              tolerance=PATH3_GMRES_TOL)
        solver = BemSolver(cfg, **where)
        label = f"(b) rigid sphere {method}{' Burton-Miller' if bm else ' CBIE'}"
        t0 = time.perf_counter()
        sol, launches = counted(label, counters, lambda: solver.solve(prob), dev, path="qa_fem")
        solve_ms = (time.perf_counter() - t0) * 1e3
        variant = "burton_miller" if bm else "double_layer"
        if launches != {variant: 1}:
            raise AssertionError(f"qa_fem {label}: launches {launches}, not one {variant}")
        counts[variant] += 1
        if bm:
            beta = solver.burton_miller_beta(prob)
            a = assembly.assemble_burton_miller(prob.mesh, k, beta, **where)
        else:
            beta = 0.0
            a = assembly.assemble_collocation_matrix(prob.mesh, k, **where)
        centers = torch.tensor(prob.mesh.centers, **where)
        normals = torch.tensor(prob.mesh.normals, **where)
        b = prob.incident.pressure(centers, k)
        if bm:
            b = b - beta * prob.incident.normal_derivative(centers, normals, k)
        res = float(torch.linalg.vector_norm(a @ sol.surface_pressure - b)
                    / torch.linalg.vector_norm(b))
        del a
        torch.cuda.empty_cache()
        log(f"qa_fem {label}: converged {sol.info['converged']}, iterations "
            f"{sol.info['iterations']}, residual ||A p - b||/||b|| {res:.3e} (limit 1e-4), "
            f"counted solve {solve_ms:.1f} ms")
        if not (sol.info["converged"] and res <= 1e-4):
            raise AssertionError(f"qa_fem {label}: {sol.info}, residual {res:.3e}")
        runs[f"bem {method}{'' if bm else ' cbie'}"] = lambda s=solver: s.solve(prob)

    twin = twin_pairwise(ops)
    st = sweep.sweep_statics(icosphere(1.0, bem_subdiv), **where)
    n = st.centers.shape[0]
    ks = torch.tensor([k], **where)
    records = {}
    for variant, count in counts.items():
        r = bem_kernel_record(f"f32 {n} x {n} F=1", ops, twin, variant,
                              (st.centers, st.normals, st.qp, st.normals, st.qw, ks), True)
        r["launches"] = count
        records[variant] = [r]
    log(f"qa_fem phase: {time.perf_counter() - t_phase:.1f} s")

    def run_fast():
        with tempfile.TemporaryDirectory() as tmp:
            return _quiet(qa.main, ["--fast", "-o", tmp])

    runs["qa_fem main --fast"] = run_fast
    return records, runs


def _spl_of(path):
    """(SPL (F, L), converged, iterations) of a results JSON."""
    import numpy as np

    with open(path) as fh:
        res = json.load(fh)["results"]
    return (np.asarray([r["spl_db"] for r in res], float), [r["converged"] for r in res],
            [r["iterations"] for r in res])


def roomsim_fem_phase(dev, small=ROOMSIM_SMALL, wide=ROOMSIM_WIDE, wide_cuts=None):
    """Phase 18 (path 11): (a) main(argv) on small_room.json, flat and
    --hierarchical (complex64, the app's default), each within
    ROOMSIM_FEM_DB of run_fem_simulation in float64 on the card, every
    frequency converged; (b) nearfield_stereo.json at its own mesh
    resolution with ROOMSIM_FEM_WIDE_CUTS (printed): 40 Hz converged, and at
    40 Hz and the highest converged frequency the SPL within
    ROOMSIM_FEM_DIRECT_DB of a float64 scipy sparse direct solve of the same
    assembled system; per batch iterations, converged flags, ms per
    frequency, batch size, peak memory and the idle share of a profiled
    repeat. Returns callables for the profiler."""
    import tempfile

    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from mathaudio_tpu_torch.apps import roomsim_fem
    from mathaudio_tpu_torch.common.config import RoomConfig
    from mathaudio_tpu_torch.xtypes import SPEED_OF_SOUND, pressure_to_spl

    t_phase = time.perf_counter()
    cuts = dict(ROOMSIM_FEM_WIDE_CUTS if wide_cuts is None else wide_cuts)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) small_room.json, flat and hierarchical
        for flags in ([], ["--hierarchical"]):
            label = "small_room" + (" --hierarchical" if flags else "")
            out = f"{tmp}/fem{len(flags)}.json"
            argv = [str(small), "-o", out, "-v", "0"] + flags
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = _quiet(roomsim_fem.main, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            spl, conv, its = _spl_of(out)
            ref = roomsim_fem.run_fem_simulation(RoomConfig.from_file(str(small)), verbose=0,
                                                 hierarchical=bool(flags), dtype=torch.float64,
                                                 device=dev)
            spl64 = np.asarray([r.spl_db for r in ref.results], float)
            diff = float(np.max(np.abs(spl - spl64)))
            log(f"roomsim_fem {label}: exit {rc}, {wall:.3f} s (complex64), iterations {its} "
                f"(float64 {[r.iterations for r in ref.results]}), converged {sum(conv)}/{len(conv)}, "
                f"SPL max |complex64 - float64| {diff:.4f} dB (limit {ROOMSIM_FEM_DB})")
            if rc != 0 or not all(conv) or not diff <= ROOMSIM_FEM_DB or not np.isfinite(spl).all():
                raise AssertionError(f"roomsim_fem {label}: rc {rc}, converged {conv}, {diff} dB")
            runs[f"roomsim_fem {label}"] = lambda argv=argv: _quiet(roomsim_fem.main, argv)

    # (b) nearfield_stereo.json at its own resolution, cut
    cfg = RoomConfig.from_file(str(wide))
    full = cfg.to_simulation().frequencies
    gm = cfg.solver.gmres
    log(f"roomsim_fem nearfield_stereo cuts: {len(full)} -> {cuts['frequencies']} log-spaced "
        f"frequencies over {full[0]:g}-{full[-1]:g} Hz; GMRES tolerance {gm.tolerance:g} -> "
        f"{cuts['tolerance']:g} (below what complex64 resolves); max_iter {gm.max_iter} -> "
        f"{cuts['max_iter']} ({cuts['max_iter'] * 10} iterations); batch {cuts['batch_size']} "
        f"(the automatic batch would pad the {cuts['frequencies']} frequencies to 64 lanes)")
    cfg.frequencies.num_points = cuts["frequencies"]
    cfg.solver.gmres.tolerance = cuts["tolerance"]
    cfg.solver.gmres.max_iter = cuts["max_iter"]
    t0 = time.perf_counter()
    sim = roomsim_fem.FemRoomSimulation(cfg, verbose=0, batch_size=cuts["batch_size"], device=dev)
    torch.cuda.synchronize()
    log(f"roomsim_fem nearfield_stereo: {sim.mesh.num_nodes} nodes, {sim.mesh.num_elements} tets, "
        f"levels {[m.num_nodes for m in sim.mg.meshes]}, set-up {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    freqs = [float(r.frequency) for r in res.results]
    conv = [r.converged for r in res.results]
    its = [r.iterations for r in res.results]
    ms = [r.solve_time_s * 1e3 for r in res.results]
    log(f"roomsim_fem nearfield_stereo batch of {cuts['batch_size']}: frequencies "
        f"{[round(f, 1) for f in freqs]}, iterations {its}, converged {conv}, {ms[0]:.1f} ms per "
        f"frequency, peak memory {peak:.2f} GiB, run {wall:.2f} s (with the slice)")
    if not conv[0]:
        raise AssertionError("roomsim_fem nearfield_stereo: 40 Hz did not converge")
    top = max(i for i, c in enumerate(conv) if c)
    sim64 = roomsim_fem.FemRoomSimulation(cfg, verbose=0, dtype=torch.float64, device=dev)
    asm = sim64.assembler
    weights = sim64.source_weights(freqs)
    for i in sorted({0, top}):
        k = 2.0 * np.pi * freqs[i] / SPEED_OF_SOUND
        coeffs = sim64._robin_coeffs([k])[:, 0]
        vals = (asm.k_vals - k**2 * asm.m_vals).to(torch.complex128) + sum(
            coeffs[t] * asm.b_vals[roomsim_fem.WALL_TAGS[w]].to(torch.complex128)
            for t, w in enumerate(sim64.wall_names))
        a = sp.csr_matrix((vals.cpu().numpy(), asm.csr.indices, asm.csr.indptr),
                          shape=asm.csr.shape)
        rhs = (sim64.rhs_stack.T @ torch.as_tensor(weights[i], device=dev).to(torch.complex128))
        t0 = time.perf_counter()
        x = spla.spsolve(a.tocsc(), rhs.cpu().numpy())
        t_direct = time.perf_counter() - t0
        p = x[sim64.listen_idx.cpu().numpy()]
        spl_direct = pressure_to_spl(np.abs(p)).numpy()
        diff = float(np.max(np.abs(np.asarray(res.results[i].spl_db) - spl_direct)))
        log(f"roomsim_fem nearfield_stereo {freqs[i]:.1f} Hz: SPL {res.results[i].spl_db} dB, float64 "
            f"sparse direct {spl_direct.tolist()} dB ({t_direct:.1f} s on the host), diff "
            f"{diff:.4f} dB (limit {ROOMSIM_FEM_DIRECT_DB})")
        if not diff <= ROOMSIM_FEM_DIRECT_DB:
            raise AssertionError(f"roomsim_fem nearfield_stereo {freqs[i]:.1f} Hz: {diff} dB off")
    # the idle share: the batch's first 30 Arnoldi steps under the profiler
    # (~700 launches a step; the whole run would trace millions)
    kcfg = sim._krylov()._replace(max_iterations=30, restart=30)
    sweep = sim._sweep_fn(kcfg)
    ks = [2.0 * np.pi * f / SPEED_OF_SOUND for f in freqs]
    profile_run(f"roomsim_fem nearfield_stereo batch of {len(freqs)}, its first 30 steps",
                lambda: sweep(ks, sim.source_weights(freqs), None), None)
    log(f"roomsim_fem phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# Phase 19: slices 4c and 6c's rest. Path 12 (BEM, complex64 on the card):
# (a) the all-quad cube sphere (6 x 29^2 = 5046 bilinear quads, nq = 4 from
# the 2 x 2 tensor rule, sized like path 3's 5120 triangles), a rigid sphere
# under a +z plane wave through BemSolver: CBIE at ka = 1, Burton–Miller at
# ka = 2 (Jacobi-GMRES, tol 1e-5), each gated against the Mie series as
# tests/test_bem.py's quad case is (< 0.1), then the field at path 3's 8192
# points; (b) the near-pair upgrade on path 3 (c)'s N = 5120 icosphere; (c)
# BemConfig JSON files (uv_sphere 36 x 72 and a closed cylinder 72 x 34, 5040
# triangles each) through build_problem and BemSolver; (d) an NC.inp with its
# node and element files written from the icosphere and parsed back.
QUAD_N = 29
QUAD_CASES = ((1.0, False), (2.0, True))  # (ka, Burton–Miller)
QUAD_MIE = 0.1  # tests/test_bem.py TestQuadElements.test_quad_bem_vs_mie
NEAR_DELTA_TOL = 1e-9  # the float64 near-pair deltas, card vs CPU
CONFIG_MESHES = ({"type": "uv_sphere", "radius": 1.0, "n_theta": 36, "n_phi": 72},
                 {"type": "cylinder", "radius": 1.0, "height": 2.0, "n_circ": 72, "n_height": 34})
# Path 13 (FEM element types): (a) P1, P2 and P3 (refinement.to_p2/to_p3) of
# the QA FEM suite's ka = 1 annulus and spherical shell (apps/qa_suite_fem.py
# main's sizes) in float64 on the card under direct, gmres_jacobi and
# gmres_amg where each fits (P_SKIP), a pair per mesh and order also on the
# CPU, and the Dirichlet plane-wave problems of tests/test_fem_extras.py at a
# larger size; (b) the trilinear hex room at nearfield_stereo.json's own
# resolution; (c) PML assembly and absorption; (d) h-refinement on the tet
# room mesh.
P_MESHES = (("annulus", "annular_mesh_triangles", (1.0, 3.0, 24, 96)),
            ("shell", "spherical_shell_mesh_tetrahedra", (1.0, 2.5, 8, 2)))
P_SOLVERS = ("direct", "gmres_jacobi", "gmres_amg")
# (mesh, order) -> solver names left out: the dense LU of the 36,050-node P3
# shell (21 GB), Jacobi-GMRES on the P3 annulus (4020 iterations without
# reaching 1e-8 on the CPU), AMG on the P3 shell (1.7M nonzeros; its host
# set-up and solve exceed minutes on the CPU)
P_SKIP = {("annulus", "p3"): ("gmres_jacobi",), ("shell", "p3"): ("direct", "gmres_amg")}
# (mesh, order) -> (solver, iteration cap) of its card-vs-CPU check: P1 and P2
# solve to the end on both sides; P3 stops both at one restart cycle (60
# steps), as the CPU's whole solve takes 30 s (annulus, AMG, 329 steps) and
# 89 s (shell, Jacobi, 1063 steps) on 4 host cores. The P1 annulus is held
# under AMG (40 steps): its Jacobi solve ends within a step of the tolerance
# after ~713, so a last-bit difference in the card's sums moves it a step
# (714 on the card against 713 on the CPU, 2.1e-9 apart, in one run)
P_CPU = {("annulus", "p1"): ("gmres_amg", None), ("annulus", "p2"): ("gmres_amg", None),
         ("annulus", "p3"): ("gmres_amg", 60), ("shell", "p1"): ("gmres_amg", None),
         ("shell", "p2"): ("gmres_jacobi", None), ("shell", "p3"): ("gmres_jacobi", 60)}
P_CARD_CPU_TOL = 1e-9
P_AGREE = 1e-4  # rel_l2 of one mesh and order under its different solvers
PLANE_WAVE_MESHES = (("unit square", "unit_square_triangles", 16, (1, 2, 3, 4)),
                     ("unit cube", "unit_cube_tetrahedra", 6, (1, 2, 3, 4, 5, 6)))
HEX_F, HEX_BETA, HEX_SIGMA = 40.0, 0.1, 0.1  # Hz, wall admittance, source width (m)
HEX_DB = 0.1
HEX_SOLVERS = ("gmres_jacobi", "gmres_shifted_laplacian")
PML_TOL = 1e-9


def _residual(a, p, b):
    import torch

    return float(torch.linalg.vector_norm(a @ p - b) / torch.linalg.vector_norm(b))


def _phase_launches(label, launches, wanted):
    if launches != wanted:
        raise AssertionError(f"{label}: launches {launches}, wanted exactly {wanted}")


def bem_quads_phase(ops, dev, counters, quad_n=QUAD_N, near_subdiv=BEM_SUBDIV,
                    config_meshes=CONFIG_MESHES, points=None):
    """Phase 19, path 12 (see above): gates each solve (GMRES converged,
    ||A p - b||/||b|| <= 1e-4 on the assembled matrix, Mie < QUAD_MIE on the
    spheres), its exact launches, and holds every new kernel shape against
    its twin (float32 <= 1e-5 per plane, off the diagonal) and times it.
    Returns ({variant: [records]}, callables for the profiler)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mathaudio_tpu_torch.bem import assembly
    from mathaudio_tpu_torch.bem import io as bem_io
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import SurfaceMesh, cube_sphere
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.bem.types import PhysicsParams
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres
    from mathaudio_tpu_torch.solvers.preconditioners.basic import jacobi_preconditioner
    from mathaudio_tpu_torch.wave.analytical import sphere_scattering_3d

    t_phase = time.perf_counter()
    where = dict(dtype=torch.float32, device=dev)
    pts = field_points() if points is None else points
    twin = twin_pairwise(ops)
    records, runs = {}, {}

    def hold(variant, label, a, off_diagonal, launches):
        r = bem_kernel_record(label, ops, twin, variant, a, off_diagonal)
        r["launches"] = launches
        records.setdefault(variant, []).append(r)

    # (a) the cube sphere: CBIE at ka = 1, Burton-Miller at ka = 2, then the field
    mesh = cube_sphere(1.0, quad_n)
    n = mesh.num_elements
    log(f"bem_quads (a) cube_sphere(1.0, {quad_n}): {n} quads, {mesh.nodes_per_element} nodes "
        f"each, nq {mesh.quad_points()[1].shape[1]}, area {mesh.areas.sum():.6f} (4 pi "
        f"{4 * np.pi:.6f})")
    theta_pts = np.arccos(np.clip(pts[:, 2] / np.linalg.norm(pts, axis=1), -1, 1))
    for ka, bm in QUAD_CASES:
        prob = BemProblem(mesh=mesh, physics=PhysicsParams.from_wave_number(ka),
                          incident=plane_wave((0.0, 0.0, 1.0)))
        solver = BemSolver(gmres_config(bm), **where)
        variant = "burton_miller" if bm else "double_layer"
        label = f"(a) cube sphere ka {ka:g} {'Burton-Miller' if bm else 'CBIE'}"

        def run(solver=solver, prob=prob):
            sol = solver.solve(prob)
            return sol, sol.evaluate_pressure_field(pts)

        (sol, field), launches = counted(label, counters, run, dev, path="bem_quads")
        _phase_launches(f"bem_quads {label}", launches, {variant: 1, "kh_double": 1})
        k = prob.physics.wave_number
        beta = solver.burton_miller_beta(prob) if bm else 0.0
        a = (assembly.assemble_burton_miller(mesh, k, beta, **where) if bm
             else assembly.assemble_collocation_matrix(mesh, k, **where))
        res = _residual(a, sol.surface_pressure, _rigid_rhs(prob.mesh, prob.incident, k, beta, where))
        del a
        torch.cuda.empty_cache()
        err = rel_l2(sol.surface_pressure, _mie_surface(mesh, k, dev))
        mie_field = sphere_scattering_3d(k, 1.0, 30, [2.0], theta_pts, dtype=torch.float64,
                                         device=dev).pressure.reshape(-1).cpu().numpy()
        err_field = rel_l2(field.p_total, mie_field)
        t_solve = median_ms(lambda: solver.solve(prob))
        t_field = median_ms(lambda: sol.evaluate_pressure_field(pts))
        log(f"bem_quads {label}: converged {sol.info['converged']}, iterations "
            f"{sol.info['iterations']}, residual {res:.3e} (limit 1e-4), surface rel L2 to Mie "
            f"{err:.4e} (limit {QUAD_MIE}), field at {len(pts)} points on r = 2 rel L2 to Mie "
            f"{err_field:.4e} (limit {QUAD_MIE}); solve {t_solve:.2f} ms, field {t_field:.2f} ms "
            f"(medians of 3)")
        if not (sol.info["converged"] and res <= 1e-4 and err < QUAD_MIE and err_field < QUAD_MIE):
            raise AssertionError(f"bem_quads {label}: {sol.info}, residual {res:.3e}, Mie {err:.3e}"
                                 f", field {err_field:.3e}")
        runs[f"bem_quads ka {ka:g}"] = run
        centers, normals, qp, qw, _, _ = assembly._mesh_tensors(mesh, 3, torch.float32, dev)
        ks = torch.tensor([k], **where)
        hold(variant, f"f32 {n} x {n} F=1 (quads)", (centers, normals, qp, normals, qw, ks), True,
             1)
        if not bm:
            x = torch.tensor(pts, **where)
            hold("kh_double", f"f32 {len(pts)} x {n} F=1 (quads)", (x, None, qp, normals, qw, ks),
                 False, 2)

    # (b) the near-pair upgrade on path 3 (c)'s icosphere, Burton-Miller at ka = 2
    prob = BemProblem.rigid_sphere(PATH3_RIGID_KA, subdivisions=near_subdiv)
    ico = prob.mesh
    k = prob.physics.wave_number
    beta = BemSolver(gmres_config(True), **where).burton_miller_beta(prob)
    t0 = time.perf_counter()
    pi, pj = assembly._near_pairs(ico)
    t_pairs = (time.perf_counter() - t0) * 1e3
    b = _rigid_rhs(prob.mesh, prob.incident, k, beta, where)
    mie = _mie_surface(ico, k, dev)
    cfg = KrylovConfig(max_iterations=1000, tolerance=PATH3_GMRES_TOL, restart=50)

    def solve(a):
        sol = gmres(a, b, config=cfg, preconditioner=jacobi_preconditioner(torch.diagonal(a)))
        if not bool(sol.converged):
            raise AssertionError(f"bem_quads (b): GMRES did not converge ({sol.iterations})")
        return sol.x, int(sol.iterations)

    a = assembly.assemble_burton_miller(ico, k, beta, **where)
    p0, it0 = solve(a)
    a_up, launches = counted("(b) near-pair upgrade", counters,
                             lambda: assembly.apply_near_pair_upgrade(a, ico, k, beta), dev,
                             path="bem_quads")
    _phase_launches("bem_quads (b) near-pair upgrade", launches, {})
    t_up = median_ms(lambda: assembly.apply_near_pair_upgrade(a, ico, k, beta))
    p1, it1 = solve(a_up)
    res1 = _residual(a_up, p1, b)
    del a, a_up
    torch.cuda.empty_cache()
    e0, e1 = rel_l2(p0, mie), rel_l2(p1, mie)
    zeros = {w: torch.zeros((ico.num_elements,) * 2, dtype=torch.complex128, device=w)
             for w in (dev, torch.device("cpu"))}
    deltas = {w.type: assembly.apply_near_pair_upgrade(z, ico, k, beta) for w, z in zeros.items()}
    d_cpu = deltas["cpu"]
    d_err = float(torch.max(torch.abs(deltas[dev.type].cpu() - d_cpu)) / torch.max(torch.abs(d_cpu)))
    del zeros, deltas, d_cpu
    torch.cuda.empty_cache()
    log(f"bem_quads (b) near-pair upgrade on icosphere N = {ico.num_elements}, ka "
        f"{PATH3_RIGID_KA:g}, Burton-Miller: {len(pi)} near pairs ({len(pi) / ico.num_elements:.1f} "
        f"a row; pair list {t_pairs:.1f} ms on the host), upgrade {t_up:.2f} ms on the card "
        f"(median of 3, host pair list and points included); GMRES iterations {it0} -> {it1}, "
        f"surface rel L2 to Mie {e0:.4e} -> {e1:.4e}, residual after {res1:.3e}; float64 deltas "
        f"card vs CPU {d_err:.3e} of max (limit {NEAR_DELTA_TOL:g})")
    if not (d_err <= NEAR_DELTA_TOL and res1 <= 1e-4 and e1 < QUAD_MIE):
        raise AssertionError(f"bem_quads (b): deltas {d_err:.3e}, residual {res1:.3e}, Mie {e1:.3e}")

    # (c) BemConfig JSON -> build_problem -> BemSolver (CBIE at ka = 1)
    f_ka1 = C_SOUND / (2 * np.pi)
    with tempfile.TemporaryDirectory() as tmp:
        for spec in config_meshes:
            path = os.path.join(tmp, f"{spec['type']}.json")
            with open(path, "w") as fh:
                json.dump({"frequency": f_ka1, "speed_of_sound": C_SOUND, "mesh": spec,
                           "incident": {"type": "plane", "direction": [0.0, 0.0, 1.0]},
                           "solver": {"method": "gmres"}}, fh)
            t0 = time.perf_counter()
            prob = bem_io.BemConfig.from_file(path).build_problem()
            t_build = (time.perf_counter() - t0) * 1e3
            solver = BemSolver(gmres_config(False), **where)
            label = f"(c) BemConfig {spec['type']}"
            sol, launches = counted(label, counters, lambda: solver.solve(prob), dev,
                                    path="bem_quads")
            _phase_launches(f"bem_quads {label}", launches, {"double_layer": 1})
            m, k = prob.mesh, prob.physics.wave_number
            a = assembly.assemble_collocation_matrix(m, k, **where)
            res = _residual(a, sol.surface_pressure, _rigid_rhs(m, prob.incident, k, 0.0, where))
            del a
            torch.cuda.empty_cache()
            mie_txt, ok = "", True
            if spec["type"] == "uv_sphere":
                err = rel_l2(sol.surface_pressure, _mie_surface(m, k, dev))
                mie_txt, ok = f", surface rel L2 to Mie {err:.4e} (limit {QUAD_MIE})", err < QUAD_MIE
            log(f"bem_quads {label}: {m.num_elements} triangles, config + mesh {t_build:.1f} ms, "
                f"converged {sol.info['converged']}, iterations {sol.info['iterations']}, residual "
                f"{res:.3e} (limit 1e-4){mie_txt}")
            if not (sol.info["converged"] and res <= 1e-4 and ok):
                raise AssertionError(f"bem_quads {label}: {sol.info}, residual {res:.3e}")
            if spec["type"] == "uv_sphere":  # the cylinder's launch has the same shape
                centers, normals, qp, qw, _, _ = assembly._mesh_tensors(m, 3, torch.float32, dev)
                ks = torch.tensor([k], **where)
                hold("double_layer", f"f32 {m.num_elements} x {m.num_elements} F=1 (BemConfig)",
                     (centers, normals, qp, normals, qw, ks), True, len(config_meshes))

        # (d) NC.inp with node and element files from the icosphere, parsed back
        nc_nodes, nc_elements = ico.nodes, ico.elements
        with open(os.path.join(tmp, "nodes.txt"), "w") as fh:
            fh.write(f"{len(nc_nodes)}\n")
            fh.writelines(f"{i} {float(x)!r} {float(y)!r} {float(z)!r}\n"
                         for i, (x, y, z) in enumerate(nc_nodes))
        with open(os.path.join(tmp, "elements.txt"), "w") as fh:
            fh.write(f"{len(nc_elements)}\n")
            fh.writelines(f"{i} {a} {b} {c}\n" for i, (a, b, c) in enumerate(nc_elements))
        nc_text = "\n".join([
            "Mesh2HRTF 1.0.0", "##", f"icosphere N = {len(nc_elements)}", "##",
            "## Controlparameter I", "0 0 0 0 7 0", "##", "## Load Frequency Curve", "0 2",
            "0.000000 0.000000e+00 0.0", f"0.000001 {f_ka1:.6e} 0.0", "##",
            "## 1. Main Parameters I", f"2 {len(nc_nodes)} {len(nc_elements)} 0 0 2 1 0 0", "##",
            "## 4. Main Parameters IV", f"{C_SOUND:g} {RHO:g} 1.0 0.0 0.0 0.0 0.0", "##",
            "NODES", "nodes.txt", "##", "ELEMENTS", "elements.txt", "##", "BOUNDARY",
            f"ELEM 0 TO {len(nc_elements) - 1} VELO 0.0 -1 0.0 -1", "RETU", "##", "PLANE WAVES",
            "1 0.0 0.0 1.0 1.0 -1 0.0 -1", "##", "END", ""])
        with open(os.path.join(tmp, "NC.inp"), "w") as fh:
            fh.write(nc_text)
        t0 = time.perf_counter()
        nc = bem_io.parse_nc_input(os.path.join(tmp, "NC.inp"))
        back = SurfaceMesh(bem_io.load_nc_nodes(os.path.join(nc.base_dir, nc.node_files[0])),
                           bem_io.load_nc_elements(os.path.join(nc.base_dir, nc.element_files[0])))
        t_nc = (time.perf_counter() - t0) * 1e3
        same = (np.array_equal(back.nodes, ico.nodes) and np.array_equal(back.elements, ico.elements)
                and nc.main_params_i.num_elements == ico.num_elements
                and np.allclose(nc.frequencies(), [f_ka1], rtol=1e-6)
                and len(nc.boundary_conditions) == 1 and len(nc.plane_waves) == 1)
        log(f"bem_quads (d) NC.inp: {nc.main_params_i.num_nodes} nodes, "
            f"{nc.main_params_i.num_elements} elements, frequencies {nc.frequencies().tolist()}, "
            f"parsed back in {t_nc:.1f} ms, same mesh {same}")
        if not same:
            raise AssertionError("bem_quads (d): the NC.inp round trip changed the mesh")
    log(f"bem_quads phase: {time.perf_counter() - t_phase:.1f} s")
    return records, runs


def _qa_fem_problem(kind, mesh, k, r_outer, dtype, device):
    """The QA FEM suite's rigid-scatterer problem on ``mesh`` (its case
    functions' boundary conditions) and its closed form at the nodes inside
    0.8 r_outer: (problem, selected nodes, exact total field, incident axis)."""
    import numpy as np
    import torch

    from mathaudio_tpu_torch.apps import qa_suite_fem as qa
    from mathaudio_tpu_torch.fem import HelmholtzProblem, NeumannBC, RobinBC

    ax, dim = (0, 2) if kind == "annulus" else (2, 3)

    def dpinc_dn(x):
        n_hat = -x / torch.linalg.norm(x, dim=-1, keepdim=True)
        return -(1j * k * n_hat[..., ax]) * torch.exp(1j * k * x[..., ax])

    prob = HelmholtzProblem(mesh, k, neumann=[NeumannBC(1, dpinc_dn)],
                            robin=[RobinBC.absorbing_curved(2, k, r_outer, dim=dim)],
                            dtype=dtype, device=device)
    nodes = mesh.nodes
    r = np.linalg.norm(nodes, axis=1)
    sel = r < 0.8 * r_outer
    if kind == "annulus":
        exact = qa._cylinder_exact(k, 1.0, 40, r[sel], np.arctan2(nodes[sel, 1], nodes[sel, 0]),
                                   device="cpu")
    else:
        exact = qa._sphere_exact(k, 1.0, 40, r[sel], np.arccos(np.clip(nodes[sel, 2] / r[sel], -1, 1)),
                                 device="cpu")
    return prob, sel, exact.numpy(), ax


def fem_elements_phase(dev, p_meshes=P_MESHES, plane_wave_meshes=PLANE_WAVE_MESHES, hex_room=None,
                       pml_box=None):
    """Phase 19, path 13 (see above). No hand-written kernel lies on these
    paths (the general FEM problem runs ELL/CSR torch ops). Returns callables
    for the profiler."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from mathaudio_tpu_torch.apps import roomsim_fem
    from mathaudio_tpu_torch.common.config import RoomConfig
    from mathaudio_tpu_torch.fem import DirichletBC, HelmholtzProblem, RobinBC, solve_helmholtz
    from mathaudio_tpu_torch.fem import mesh as fem_mesh
    from mathaudio_tpu_torch.fem.pml import PmlRegion, assemble_pml_values, pml_box_regions
    from mathaudio_tpu_torch.fem.problem import l2_error_at_nodes
    from mathaudio_tpu_torch.fem.refinement import (
        adaptive_refine,
        residual_indicator,
        to_p2,
        to_p3,
        uniform_refine,
    )
    from mathaudio_tpu_torch.solvers.direct import lu_solve
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig
    from mathaudio_tpu_torch.xtypes import pressure_to_spl

    t_phase = time.perf_counter()
    f64, cpu = torch.float64, torch.device("cpu")
    orders = (("p1", lambda m: m), ("p2", to_p2), ("p3", to_p3))
    runs = {}

    # (a) P2 and P3 of the QA suite's annulus and shell (ka = 1)
    qa_cfg = KrylovConfig(max_iterations=4000, tolerance=1e-8, restart=60)  # the QA suite's float64
    for kind, gen, args in p_meshes:
        base = getattr(fem_mesh, gen)(*args)
        r_outer = args[1]
        errs = {}
        for order, up in orders:
            m = up(base)
            prob, sel, exact, ax = _qa_fem_problem(kind, m, 1.0, r_outer, f64, dev)
            per = {}
            for name in P_SOLVERS:
                if name in P_SKIP.get((kind, order), ()):
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                u, info = solve_helmholtz(prob, name, qa_cfg)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                u = u.cpu().numpy()
                err = float(np.linalg.norm(u[sel] + np.exp(1j * m.nodes[sel, ax]) - exact)
                            / np.linalg.norm(exact))
                per[name] = (u, err, info)
                log(f"fem_elements (a) {kind} {order} ({m.element_type}, {m.num_nodes} nodes) "
                    f"{name}: rel_l2 {err:.6e}, iterations {info['iterations']}, converged "
                    f"{info['converged']}, {ms:.1f} ms (float64, set-up included)")
                if not info["converged"]:
                    raise AssertionError(f"fem_elements (a) {kind} {order} {name}: {info}")
            if (kind, order) in P_CPU:
                name, cap = P_CPU[(kind, order)]
                cfg = qa_cfg if cap is None else qa_cfg._replace(max_iterations=cap)
                prob_cpu = _qa_fem_problem(kind, m, 1.0, r_outer, f64, cpu)[0]
                u_cpu, info_cpu = solve_helmholtz(prob_cpu, name, cfg)
                if cap is None:
                    u_card, _, info_card = per[name]
                else:
                    u_card, info_card = solve_helmholtz(prob, name, cfg)
                    u_card = u_card.cpu().numpy()
                diff = float(np.max(np.abs(u_card - u_cpu.numpy())) / np.max(np.abs(u_cpu.numpy())))
                log(f"fem_elements (a) {kind} {order} {name}"
                    f"{'' if cap is None else f' capped at {cap} steps'}: card vs CPU {diff:.3e} "
                    f"of max|u| (limit {P_CARD_CPU_TOL:g}), iterations "
                    f"{info_card['iterations']} / {info_cpu['iterations']}")
                if not (diff <= P_CARD_CPU_TOL and info_card["iterations"] == info_cpu["iterations"]):
                    raise AssertionError(f"fem_elements (a) {kind} {order}: card vs CPU {diff:.3e}")
            vals = [e for _, e, _ in per.values()]
            if max(vals) - min(vals) > P_AGREE:
                raise AssertionError(f"fem_elements (a) {kind} {order}: solvers disagree {vals}")
            errs[order] = float(np.mean(vals))
        log(f"fem_elements (a) {kind}: closed-form rel_l2 P1 {errs['p1']:.6e}, P2 {errs['p2']:.6e},"
            f" P3 {errs['p3']:.6e}")
        if not (errs["p2"] <= errs["p1"] and errs["p3"] <= errs["p1"]):
            raise AssertionError(f"fem_elements (a) {kind}: P2/P3 error above P1's: {errs}")
        if kind == "shell" and not errs["p3"] < errs["p2"] < errs["p1"]:
            raise AssertionError(f"fem_elements (a) shell: not P3 < P2 < P1: {errs}")

    # the Dirichlet plane-wave problems of tests/test_fem_extras.py, larger
    for label, gen, n, tags in plane_wave_meshes:
        base = getattr(fem_mesh, gen)(n)
        kd = torch.tensor([0.6, 0.8] if base.dim == 2 else [0.48, 0.6, 0.64], dtype=f64,
                          device=dev) * 2.0

        def exact(x, kd=kd):
            return torch.exp(1j * (x @ kd.to(x.dtype)))

        errs = {}
        for order, up in orders:
            m = up(base)
            prob = HelmholtzProblem(m, 2.0, dirichlet=[DirichletBC(t, exact) for t in tags],
                                    dtype=f64, device=dev)
            u, _ = solve_helmholtz(prob, "direct")
            errs[order] = float(l2_error_at_nodes(m, u, exact))
        log(f"fem_elements (a) plane wave on the {label} n={n} (direct, float64): nodal rel L2 "
            f"P1 {errs['p1']:.4e}, P2 {errs['p2']:.4e}, P3 {errs['p3']:.4e} (P2 < P1/5 and P3 < "
            f"P2/3 wanted, as tests/test_fem_extras.py)")
        if not (errs["p2"] < errs["p1"] / 5.0 and errs["p3"] < errs["p2"] / 3.0):
            raise AssertionError(f"fem_elements (a) plane wave {label}: {errs}")

    # (b) the hex room at nearfield_stereo.json's resolution
    cfg = RoomConfig.from_file(str(ROOMSIM_WIDE))
    sim = cfg.to_simulation()
    w, d, h = sim.geometry.dimensions()
    dims = hex_room or roomsim_fem._mesh_dims(w, d, h, cfg.solver.mesh_resolution, multiple=4)
    t0 = time.perf_counter()
    hexes = fem_mesh.box_mesh_hexahedra(0, w, 0, d, 0, h, *dims)
    t_mesh = time.perf_counter() - t0
    k = 2.0 * np.pi * HEX_F / C_SOUND
    x0 = np.asarray(sim.sources[0].position.to_array(), float)
    lp = np.asarray(sim.listening_positions[0].to_array(), float)
    listen = int(np.argmin(np.linalg.norm(hexes.nodes - lp, axis=1)))

    def hex_problem(dtype, device):
        def source(x):
            r2 = torch.sum((x - torch.as_tensor(x0, dtype=x.dtype, device=x.device)) ** 2, dim=-1)
            return torch.exp(-r2 / (2 * HEX_SIGMA**2)).to(torch.complex128 if x.dtype == f64
                                                          else torch.complex64)

        return HelmholtzProblem(hexes, k, source_fn=source,
                                robin=[RobinBC.admittance(t, k, HEX_BETA) for t in WALLS],
                                dtype=dtype, device=device)

    t0 = time.perf_counter()
    p64 = hex_problem(f64, cpu)
    asm = p64.assembler
    a = sp.csr_matrix((p64.vals.numpy(), asm.csr.indices, asm.csr.indptr), shape=asm.csr.shape)
    # the sparsity is symmetric: minimum degree on A^T + A halves SuperLU's default time here
    x_direct = spla.splu(a.tocsc(), permc_spec="MMD_AT_PLUS_A").solve(p64.rhs.numpy())
    t_direct = time.perf_counter() - t0
    spl_direct = float(pressure_to_spl(abs(x_direct[listen])))
    del p64, a
    t0 = time.perf_counter()
    p32 = hex_problem(torch.float32, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"fem_elements (b) hex room {dims[0]} x {dims[1]} x {dims[2]}: {hexes.num_nodes} nodes, "
        f"{hexes.num_elements} hexes, mesh {t_mesh:.2f} s, complex64 problem on the card "
        f"{t_build:.2f} s, {p32.assembler.csr.nnz} nonzeros (ELL width {p32.assembler.ell_width}); "
        f"{HEX_F:g} Hz, walls of admittance {HEX_BETA:g}, a Gaussian source (sigma {HEX_SIGMA:g} m) "
        f"at {x0.tolist()}; float64 sparse direct on the host {t_direct:.1f} s (set-up "
        f"included), SPL {spl_direct:.4f} dB at node {listen}")
    hex_cfg = KrylovConfig(max_iterations=4000, tolerance=1e-5, restart=60)
    for name in HEX_SOLVERS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        u, info = solve_helmholtz(p32, name, hex_cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        spl = float(pressure_to_spl(abs(complex(u[listen].item()))))
        log(f"fem_elements (b) hex room {name}: iterations {info['iterations']}, converged "
            f"{info['converged']}, {ms:.1f} ms (set-up included), peak memory {peak:.2f} GiB, SPL "
            f"{spl:.4f} dB vs direct {spl_direct:.4f} (diff {abs(spl - spl_direct):.4f}, limit "
            f"{HEX_DB})")
        if not (info["converged"] and abs(spl - spl_direct) <= HEX_DB):
            raise AssertionError(f"fem_elements (b) hex room {name}: {info}, SPL {spl} vs "
                                 f"{spl_direct}")
        runs[f"fem hex room {name}"] = lambda name=name: solve_helmholtz(p32, name, hex_cfg)

    # (c) PML: a tet box with layers on all faces, card vs CPU; then absorption
    box_dims = pml_box or roomsim_fem._mesh_dims(w, d, h, cfg.solver.mesh_resolution, multiple=4)
    tets = fem_mesh.box_mesh_tetrahedra(0, w, 0, d, 0, h, *box_dims)
    regions = pml_box_regions((0, w, 0, d, 0, h), 0.5, sigma_max=4.0 * k)
    got = {}
    for where in (dev, cpu):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, kv, mv = assemble_pml_values(tets, regions, k, dtype=f64, device=where)
        torch.cuda.synchronize()
        got[where.type] = (kv.cpu(), mv.cpu(), (time.perf_counter() - t0) * 1e3)
    errs = [float(torch.max(torch.abs(g - c)) / torch.max(torch.abs(c)))
            for g, c in zip(got[dev.type][:2], got["cpu"][:2])]
    t_card = {dt: median_ms(lambda dt=dt: assemble_pml_values(tets, regions, k, dtype=dt,
                                                              device=dev))
              for dt in (f64, torch.float32)}
    log(f"fem_elements (c) PML on the tet box ({tets.num_nodes} nodes, {tets.num_elements} tets, "
        f"6 layers of 0.5 m): float64 K / M card vs CPU {errs[0]:.3e} / {errs[1]:.3e} (limit "
        f"{PML_TOL:g}); float64 first call {got[dev.type][2]:.1f} ms on the card, "
        f"{got['cpu'][2]:.1f} ms on the CPU; on the card medians of 3 after it: float64 "
        f"{t_card[f64]:.1f} ms, float32 {t_card[torch.float32]:.1f} ms")
    if not max(errs) <= PML_TOL:
        raise AssertionError(f"fem_elements (c) PML card vs CPU: {errs}")
    kw = 6.0  # tests/test_fem_extras.py TestPml.test_pml_absorbs_outgoing_wave, on the card
    strip = fem_mesh.rectangular_mesh_triangles(0.0, 3.0, 0.0, 0.1, 120, 2)
    csr, kv, mv = assemble_pml_values(strip, [PmlRegion(0, +1, 2.0, 1.0, sigma_max=4.0 * kw)], kw,
                                      dtype=f64, device=dev)
    nn = strip.num_nodes
    rows = torch.as_tensor(np.repeat(np.arange(nn), np.diff(csr.indptr)), device=dev)
    cols = torch.as_tensor(csr.indices.astype(np.int64), device=dev)
    a = torch.zeros((nn, nn), dtype=torch.complex128, device=dev).index_put_(
        (rows, cols), kv - kw**2 * mv, accumulate=True)
    left = torch.as_tensor(np.abs(strip.nodes[:, 0]) < 1e-12, device=dev)
    fixed = left | torch.as_tensor(np.abs(strip.nodes[:, 0] - 3.0) < 1e-12, device=dev)
    g = left.to(torch.complex128)
    bvec = torch.where(fixed, g, -(a[:, fixed] @ g[fixed]))
    a[fixed, :] = 0.0
    a[:, fixed] = 0.0
    a[fixed, fixed] = 1.0
    u = lu_solve(a, bvec).cpu().numpy()
    inner = (strip.nodes[:, 0] > 0.2) & (strip.nodes[:, 0] < 1.8)
    mags = np.abs(u[inner])
    ripple = (mags.max() - mags.min()) / mags.mean()
    log(f"fem_elements (c) PML strip k = {kw:g} on the card: ripple {ripple:.4f} (limit 0.12), "
        f"mean |u| {mags.mean():.4f} (1 +- 0.1)")
    if not (ripple < 0.12 and abs(mags.mean() - 1.0) <= 0.1):
        raise AssertionError(f"fem_elements (c) PML strip: ripple {ripple}, mean {mags.mean()}")

    # (d) h-refinement on the tet room mesh (host)
    vol = w * d * h
    t0 = time.perf_counter()
    fine = uniform_refine(tets)
    t_uni = time.perf_counter() - t0
    r = np.linalg.norm(tets.nodes - x0, axis=1)
    u_free = np.exp(1j * k * r) / (4 * np.pi * np.maximum(r, 0.05))
    t0 = time.perf_counter()
    eta = residual_indicator(tets, u_free, k)
    adapted = adaptive_refine(tets, eta, theta=0.5)
    t_ad = time.perf_counter() - t0
    v_err = max(abs(fine.element_measures().sum() - vol), abs(adapted.element_measures().sum()
                                                               - vol)) / vol
    log(f"fem_elements (d) refinement of the tet room ({tets.num_elements} tets): "
        f"uniform_refine {t_uni:.2f} s -> {fine.num_elements} tets, {fine.num_nodes} nodes; "
        f"residual_indicator + adaptive_refine (theta 0.5) {t_ad:.2f} s -> "
        f"{adapted.num_elements} tets; volume off {v_err:.2e} (limit 1e-9)")
    if not (fine.num_elements == 8 * tets.num_elements and v_err <= 1e-9
            and adapted.num_elements > tets.num_elements):
        raise AssertionError("fem_elements (d): refinement lost volume or elements")
    log(f"fem_elements phase: {time.perf_counter() - t_phase:.1f} s")
    return runs


# Phase 20 (path 14): slice 7b, the optimizer test-function registry and the
# four DE apps on the card in float64 (the port's DE dtype), and the hull on
# the host as in the reference. No hand-written kernel lies on this path.
DE_POINTS = 4096  # (a): seeded points per function
DE_ANY_WIDTH = 10  # (a): the width of a function that admits any width
DE_CARD_CPU = 1e-10  # (a), (d): |card - CPU| <= DE_CARD_CPU * max(1, |CPU|)
DE_RUN_KEYS = ["function", "x", "fun", "expected_minimum", "success", "message", "nit", "nfev"]
DE_RUNS = (["rastrigin", "--dims", "10"], ["rosenbrock", "--dims", "10"],
           ["keanes_bump_objective"])  # (b): the CLI's defaults (popsize 15, maxiter 1000, tol 1e-2)
DE_SPHERE = ["sphere", "--dims", "10", "--tol", "0", "--maxiter", "400", "--seed", "42"]
DE_SPHERE_FUN = 1e-4
DE_FILTER = "_10d"  # (c): benchmark_convergence -f _10d --quick, the 46 ten-dimensional configs
DE_SUMMARY = REPO / "de_benchmark_results" / "quick_10d_summary.json"
DE_PASS_SLACK = 2  # (c): passes >= the reference's on the same list - 2
DE_RECORDER_CONFIG = "rastrigin_10d"  # (c): the recorder's cost, with and without it
DE_PROFILE_MAXITER = 50  # (c) --profile: the profiled configuration's generations
PLOT_RESOLUTION = 80  # (d): plot_functions all --resolution 80 --metadata
HULL_TOL = 1e-9  # (e): volume and area, relative to scipy.spatial.ConvexHull


def _de_points(meta, rng, count):
    """(count, width) float64 points uniform in ``meta``'s bounds at its
    registered width, or DE_ANY_WIDTH (run_de's --dims: the first bound
    repeated) where any width is admitted."""
    import numpy as np

    bounds = meta.bounds if meta.dimensions else [meta.bounds[0]] * DE_ANY_WIDTH
    lo, hi = np.array(bounds).T
    return rng.uniform(lo, hi, size=(count, len(bounds)))


def _card_cpu_err(card, cpu):
    import numpy as np

    card, cpu = np.asarray(card, float), np.asarray(cpu, float)
    return float(np.max(np.abs(card - cpu) / np.maximum(1.0, np.abs(cpu))))


def _plotly_data(html):
    m = re.search(r'Plotly\.newPlot\("plot", (.*), (\{.*\})\);</script>', html)
    if m is None:
        raise AssertionError("no Plotly.newPlot call in the HTML")
    return json.loads(m.group(1))


def _run_cli(main, argv):
    """(exit code, standard output, seconds) of ``main(argv)``, its
    standard error swallowed; synchronised before and after."""
    import contextlib
    import io

    import torch

    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def de_apps_phase(dev, points=DE_POINTS, de_filter=DE_FILTER, resolution=PLOT_RESOLUTION,
                  hull_sizes=(500, 500, 180)):
    """Phase 20, path 14 (slice 7b) on the card in float64: (a) every
    registered function and constraint at ``points`` seeded points through
    ``torch.func.vmap`` against the CPU; (b) run_de at the CLI's defaults and
    the sphere gate; (c) benchmark_convergence over ``de_filter`` --quick
    against the reference's recorded outcomes, with the recorder's cost; (d) plot_functions all against a
    --device cpu run, then plot_de over (c)'s traces; (e) the hull on the
    host against scipy. Every launch count stays 0 (no hand-written kernel on
    this path). Returns callables for the profiler."""
    import dataclasses
    import glob
    import os
    import tempfile

    import numpy as np
    import scipy.spatial
    import torch

    from mathaudio_tpu_torch.apps import benchmark_convergence as bc
    from mathaudio_tpu_torch.apps import plot_de, plot_functions, run_de
    from mathaudio_tpu_torch.fem import dia
    from mathaudio_tpu_torch.hull import hull_to_obj, quickhull_3d, random_points, sphere_points
    from mathaudio_tpu_torch.hull.testdata import fibonacci_sphere_points
    from mathaudio_tpu_torch.ops import bem_assembly
    from mathaudio_tpu_torch.optim import DEConfig, differential_evolution
    from mathaudio_tpu_torch.testfunctions import FUNCTIONS

    card = gpu_line()
    t_phase = time.perf_counter()
    for c in (dia, bem_assembly):
        c.reset_launches()

    # (a) the registry on the card against the CPU
    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    worst, timings, n_evals = (0.0, None), [], 0
    for name, (fn, meta) in FUNCTIONS.items():
        pts = _de_points(meta, rng, points)
        x_card = torch.tensor(pts, dtype=torch.float64, device=dev)
        x_cpu = torch.tensor(pts, dtype=torch.float64)
        for f in [fn] + list(meta.inequality_constraints):
            vf = torch.func.vmap(f)
            got = vf(x_card)
            if tuple(got.shape) != (points,) or got.dtype != torch.float64:
                raise AssertionError(f"de (a) {name}/{f.__name__}: {tuple(got.shape)} {got.dtype}")
            err = _card_cpu_err(got.cpu().numpy(), vf(x_cpu).numpy())
            n_evals += 1
            if not err <= DE_CARD_CPU:
                raise AssertionError(f"de (a) {name}/{f.__name__}: card vs CPU {err:.3e}")
            if err >= worst[0]:
                worst = (err, f"{name}/{f.__name__}" if f is not fn else name)
            if f is fn:
                timings.append((time_ms(lambda: vf(x_card), batches=5, per_batch=5), name,
                                x_card.shape[1]))
    timings.sort(reverse=True)
    log(f"de (a) registry: {len(FUNCTIONS)} functions + constraints, {n_evals} evaluations of "
        f"{points} points on the card vs the CPU, float64: worst {worst[1]} {worst[0]:.3e} "
        f"(limit {DE_CARD_CPU:g}), {time.perf_counter() - t0:.1f} s")
    log(f"de (a) slowest 4096-point evaluations (CUDA events, median of 5 x 5): " + ", ".join(
        f"{name} (n={n}) {ms:.3f} ms" for ms, name, n in timings[:5])
        + f"; median over the registry {statistics.median(t[0] for t in timings):.3f} ms; card {card}")

    # (b) run_de on the card
    dev_arg = ["--device", str(dev)]
    for argv in list(DE_RUNS) + [DE_SPHERE]:
        rc, out, secs = _run_cli(run_de.main, argv + dev_arg)
        report = json.loads(out)
        if rc != 0 or list(report) != DE_RUN_KEYS:
            raise AssertionError(f"de (b) run_de {argv}: exit {rc}, keys {list(report)}")
        if not all(math.isfinite(v) for v in report["x"] + [report["fun"]]):
            raise AssertionError(f"de (b) run_de {argv}: non-finite report")
        log(f"de (b) run_de {' '.join(argv)}: fun {report['fun']:.6e} (expected "
            f"{report['expected_minimum']}), nit {report['nit']}, nfev {report['nfev']}, "
            f"{report['message']}; {secs:.2f} s, {secs * 1e3 / max(report['nit'], 1):.2f} ms per "
            f"generation; card {card}")
    if not report["fun"] < DE_SPHERE_FUN:
        raise AssertionError(f"de (b) sphere 10-d: fun {report['fun']} not below {DE_SPHERE_FUN}")

    # (c) the convergence benchmark's ten-dimensional configurations, --quick
    reference = {r["name"]: r for r in json.loads(DE_SUMMARY.read_text())}
    ran = [c for c in bc.generate_all_benchmarks(quick=True) if de_filter in c.name]
    if de_filter == DE_FILTER and sorted(c.name for c in ran) != sorted(reference):
        raise AssertionError("de (c): the generated list is not the reference's recorded one")
    with tempfile.TemporaryDirectory() as tmp:
        traces = os.path.join(tmp, "traces")
        os.makedirs(traces)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = [bc.run_benchmark(cfg, traces, device=dev) for cfg in ran]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        crashed = [r.name for r in results if (r.error_message or "").startswith("optimization failed")]
        passed = {r.name for r in results if r.success}
        ref_passed = {r.name for r in ran if reference.get(r.name, {}).get("success")}
        gens = sum(r.nit for r in results)
        log(f"de (c) benchmark_convergence -f {de_filter} --quick on the card: {len(ran)} "
            f"configurations ({len(ran[0].bounds) * ran[0].popsize} individuals each), "
            f"{len(passed)} pass (reference on the CPU: {len(ref_passed)}), "
            f"{len(crashed)} crashed; wall {wall:.1f} s, {gens} generations, "
            f"{wall * 1e3 / max(gens, 1):.2f} ms per generation; card {card}")
        log(f"de (c) pass on the card, fail in the reference: {sorted(passed - ref_passed)}")
        log(f"de (c) fail on the card, pass in the reference: {sorted(ref_passed - passed)}")
        for r in results:
            log(f"de (c)   {r.line()}")
        if crashed:
            raise AssertionError(f"de (c): optimization failed in {crashed}")
        if len(passed) < len(ref_passed) - DE_PASS_SLACK:
            raise AssertionError(f"de (c): {len(passed)} pass, the reference {len(ref_passed)}")

        # the recorder's per-generation callback (a host sync and a CSV row):
        # the same configuration with and without it
        cfg = next((c for c in ran if c.name == DE_RECORDER_CONFIG), ran[0])
        fn = FUNCTIONS[cfg.function_name][0]
        de_cfg = DEConfig(maxiter=cfg.maxiter, popsize=cfg.popsize, recombination=cfg.recombination,
                          strategy=cfg.strategy, seed=cfg.seed, tol=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = differential_evolution(fn, cfg.bounds, de_cfg, device=dev)
        torch.cuda.synchronize()
        bare = (time.perf_counter() - t0) * 1e3 / rep.nit
        rec = next(r for r in results if r.name == cfg.name)
        recorded = rec.wall_s * 1e3 / rec.nit
        log(f"de (c) recorder cost on {cfg.name}: {recorded:.3f} ms per generation recorded vs "
            f"{bare:.3f} ms without the callback ({recorded - bare:+.3f} ms, "
            f"{100 * (recorded - bare) / bare:+.1f}%); card {card}")

        # (d) plot_functions on the card against the CPU, then plot_de over (c)'s traces
        grids = {}
        for where in (str(dev), "cpu"):
            out_dir = os.path.join(tmp, f"plots_{where.replace(':', '')}")
            argv = ["all", "--resolution", str(resolution), "--metadata", "-o", out_dir,
                    "--device", where]
            rc, _, secs = _run_cli(plot_functions.main, argv)
            if rc != 0:
                raise AssertionError(f"de (d) plot_functions on {where}: exit {rc}")
            grids[where] = {os.path.basename(p)[:-5]: np.array(_plotly_data(open(p).read())[0]["z"])
                            for p in sorted(glob.glob(os.path.join(out_dir, "*.html")))}
            n_json = len(glob.glob(os.path.join(out_dir, "*.json")))
            log(f"de (d) plot_functions all --resolution {resolution} --metadata on {where}: "
                f"{len(grids[where])} surfaces, {n_json} metadata files, {secs:.2f} s; card {card}")
        worst = max((_card_cpu_err(grids[str(dev)][n], z), n) for n, z in grids["cpu"].items())
        if sorted(grids[str(dev)]) != sorted(grids["cpu"]) or n_json != len(FUNCTIONS):
            raise AssertionError("de (d): the card and the CPU wrote different plots")
        log(f"de (d) z grids card vs CPU: worst {worst[1]} {worst[0]:.3e} (limit {DE_CARD_CPU:g})")
        if not worst[0] <= DE_CARD_CPU:
            raise AssertionError(f"de (d) {worst[1]}: z grid card vs CPU {worst[0]:.3e}")
        csvs = sorted(glob.glob(os.path.join(traces, "*.csv")))
        html = os.path.join(tmp, "de_convergence.html")
        rc, _, secs = _run_cli(plot_de.main, [os.path.join(traces, "*.csv"), "-o", html])
        data = _plotly_data(open(html).read())
        log(f"de (d) plot_de over {len(csvs)} traces: exit {rc}, {len(data)} traces in the HTML, "
            f"{secs:.2f} s on the host")
        if rc != 0 or len(data) != len(csvs) or len(csvs) != len(ran):
            raise AssertionError(f"de (d) plot_de: {len(data)} traces for {len(csvs)} CSVs")

    # (e) the hull on the host
    for label, pts in ((f"sphere_points({hull_sizes[0]})", sphere_points(hull_sizes[0])),
                       (f"random_points({hull_sizes[1]})", random_points(hull_sizes[1])),
                       (f"fibonacci_sphere_points({hull_sizes[2]})",
                        fibonacci_sphere_points(hull_sizes[2]))):
        t0 = time.perf_counter()
        h = quickhull_3d(pts)
        secs = time.perf_counter() - t0
        ref = scipy.spatial.ConvexHull(pts)
        vol_err = abs(h.volume() - ref.volume) / ref.volume
        area_err = abs(h.surface_area() - ref.area) / ref.area
        lines = hull_to_obj(h).splitlines()
        verts = np.array([[float(v) for v in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
        faces = [tuple(int(h.vertices[int(i) - 1]) for i in ln.split()[1:])
                 for ln in lines if ln.startswith("f ")]
        same_faces = faces == [tuple(int(v) for v in f.vertices) for f in h.faces]
        vert_err = float(np.max(np.abs(verts - h.points[h.vertices])))
        log(f"de (e) hull of {label}: {len(h.vertices)} vertices, {h.num_faces} faces, "
            f"{secs:.3f} s on the host; volume {vol_err:.2e}, area {area_err:.2e} off scipy "
            f"(limit {HULL_TOL:g}); OBJ re-read: faces equal {same_faces}, vertices within "
            f"{vert_err:.1e}; host of the card {card}")
        if not (vol_err <= HULL_TOL and area_err <= HULL_TOL and same_faces and vert_err <= 1e-8
                and set(h.vertices.tolist()) == set(ref.vertices.tolist())):
            raise AssertionError(f"de (e) hull of {label} disagrees with scipy or its OBJ")

    launches = {k: v for c in (dia, bem_assembly) for k, v in c.LAUNCHES.items() if v}
    log(f"de: hand-written kernel launches on path 14: {launches or 'none'} (none expected)")
    if launches:
        raise AssertionError(f"path 14 launched a hand-written kernel: {launches}")
    log(f"de: phase 20 took {time.perf_counter() - t_phase:.1f} s; card {card}")

    profiled = dataclasses.replace(cfg, maxiter=DE_PROFILE_MAXITER)

    def profile_config():
        with tempfile.TemporaryDirectory() as tmp:
            return bc.run_benchmark(profiled, tmp, device=dev)

    return {f"de {cfg.name} (recorded, maxiter {DE_PROFILE_MAXITER})": profile_config}


# ---------------------------------------------------------------------------
# Phase 21 (path 15): slice 8, the multi-GPU parallel/ package. One NCCL rank
# per card (torch.cuda.device_count() ranks), spawned once by
# parallel.launch; every rank runs every path on its own card and returns its
# launch counts, gates, walls and log lines to this process, which prints
# them and times the kernel shapes the ranks launched that no phase timed.

PAR_SWEEP_TOL = 1e-6  # (a): each rank's lanes vs the unsharded sweep of its chunk
# (a): one card's sweep of the whole band vs the ranks' lanes, and its
# iteration mean: every rank builds its own tables, and the CUDA assembly's
# index_add_ rounds in no fixed order, so other ranks' lanes may differ in
# the last bits of their operators
PAR_CROSS_TOL, PAR_CROSS_ITS = 1e-4, 0.01
PAR_BEM_CASES = (("burton_miller", 2.0, True), ("double_layer", 1.0, False))  # (b): ka, BM
PAR_BEM_TOL, PAR_ITER_TOL, PAR_RESIDUAL = 1e-4, 2, 1e-4  # (b): vs unsharded; ||Ap - b||/||b||
PAR_FEM_N, PAR_FEM_K, PAR_FEM_TOL = 15, 3.0, 1e-8  # (c): P1 box, 4096 nodes; vs direct
PAR_FEM_GMRES = dict(max_iterations=500, tolerance=1e-12, restart=50)
PAR_FMM_MATVEC_TOL = 1e-5  # (d), (e): sharded vs unsharded gather-form matvec
PAR_ROOM_TOL = 1e-4  # (f): the ELL room sweep, sharded vs unsharded (complex64)
PAR_DE_POP, PAR_DE_DIM = 1000, 10
PAR_TIMEOUT = 120  # seconds a collective may wait on the slowest rank
PAR_JOIN = 480  # seconds the ranks may take in all
PAR_ROOM_N = 5  # (f): the dry run's unit cube


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _par_walls(sharded_fn, unsharded_fn, dev, lead):
    """Median wall ms of 3 synchronised runs of each side after a warm run
    of each, the sides taken in turns (sharded, unsharded, sharded, ...) so
    that neither is always timed after the other. Sharded: the ranks start
    each run together (a barrier) and the slowest rank's median is every
    rank's; unsharded: on rank 0's card alone while the other ranks wait."""
    import torch
    import torch.distributed as dist

    def wall_ms(fn):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3

    times = dict(sharded=[], unsharded=[])
    for rep in range(4):  # the first round is the warm run
        dist.barrier()
        t = wall_ms(sharded_fn)
        if rep:
            times["sharded"].append(t)
        if lead:
            t = wall_ms(unsharded_fn)
            if rep:
                times["unsharded"].append(t)
        dist.barrier()
    t = torch.tensor([statistics.median(times["sharded"])], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    walls = dict(sharded=float(t))
    if lead:
        walls["unsharded"] = statistics.median(times["unsharded"])
    return walls


def _collective_share(fn, dev):
    """(NCCL kernels' device ms, all device ms, host ms inside the
    collective calls) of one ``fn()`` under torch.profiler, after a
    discarded warm-up step. A profile that recorded no device activity (a
    sub-millisecond step can come back empty) is taken again, up to three
    times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    for _ in range(3):
        schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
        with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                    schedule=schedule) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        spans = [(e.time_range.end - e.time_range.start, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
        if spans:
            break
    else:
        raise AssertionError("the profiler recorded no device activity in three profiles")
    host = [e.time_range.end - e.time_range.start for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("nccl:")]
    return (sum(us for us, name in spans if "nccl" in name.lower()) / 1e3,
            sum(us for us, _ in spans) / 1e3, sum(host) / 1e3)


def _collective_us(dev, group, n):
    """Wall microseconds of one all_reduce of a complex scalar and of one
    all_gather of ``n`` complex64 per rank: 100 synchronised calls each."""
    import torch

    from mathaudio_tpu_torch.parallel.mesh import all_gather_tiled, all_reduce_sum

    out = {}
    for label, fn, x in (("all_reduce", all_reduce_sum,
                          torch.ones((), dtype=torch.complex64, device=dev)),
                         ("all_gather", all_gather_tiled,
                          torch.ones(n, dtype=torch.complex64, device=dev))):
        fn(x, group)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(100):
            fn(x, group)
        _sync(dev)
        out[label] = (time.perf_counter() - t0) * 1e4
    return out


def parallel_rank(rank, world):
    """One NCCL rank of phase 21 on its card (``cuda:rank``): paths (a)-(f),
    each gated here; returns its launches, walls, collective shares and log
    lines."""
    import numpy as np
    import scipy.sparse
    import scipy.sparse.linalg
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from mathaudio_tpu_torch.bem import fmm
    from mathaudio_tpu_torch.bem.assembly import assemble_burton_miller, assemble_collocation_matrix
    from mathaudio_tpu_torch.bem.incident import plane_wave
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.bem.solver import BemProblem, BemSolver
    from mathaudio_tpu_torch.bem.types import BemSolverConfig, SolverMethod
    from mathaudio_tpu_torch.fem import dia
    from mathaudio_tpu_torch.fem.assembly import HelmholtzAssembler
    from mathaudio_tpu_torch.fem.mesh import unit_cube_tetrahedra
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel, sweep_pressure
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
    from mathaudio_tpu_torch.ops import bem_assembly
    from mathaudio_tpu_torch.parallel import (
        dryrun,
        shard_frequency_sweep,
        shard_population_eval,
        shard_room_params,
        sweep_mesh,
    )
    from mathaudio_tpu_torch.parallel.fmm_spmd import (
        shard_mlfmm_tree,
        shard_slfmm,
        sharded_mlfmm_tree_matvec_fn,
        sharded_mlfmm_tree_solve_fn,
        sharded_slfmm_matvec_fn,
        sharded_slfmm_solve_fn,
    )
    from mathaudio_tpu_torch.parallel.spmd import build_sharded_system, sharded_gmres_fn, unshard
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig, gmres, gmres_pipelined_ghysels
    from mathaudio_tpu_torch.solvers.preconditioners import AdditiveSchwarz
    from mathaudio_tpu_torch.solvers.sparse import CsrMatrix
    from mathaudio_tpu_torch.testfunctions import functions

    t_rank = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    c64, f64 = torch.complex64, torch.float64
    lines, walls, shares, launches = [], {}, {}, {}
    out = dict(lines=lines, walls=walls, shares=shares, launches=launches,
               device=torch.cuda.get_device_name(dev), backend=dist.get_backend())
    lead = rank == 0

    def note(msg):  # progress on stderr at once: a stuck rank shows where it stopped
        print(f"parallel rank {rank}/{world} at {time.perf_counter() - t_rank:.1f} s: {msg}",
              file=sys.stderr, flush=True)

    def say(msg):  # kept for the parent's summary
        lines.append(msg)
        note(msg)

    def fail(what):
        raise AssertionError(f"parallel rank {rank}/{world}: {what}")

    def timed(label, sharded_fn, unsharded_fn):
        """Walls (sharded over the world; unsharded on rank 0's card), both
        taken in turns before any profile, then the sharded run's
        collective share of device time."""
        note(f"timing {label}")
        walls[label] = _par_walls(sharded_fn, unsharded_fn, dev, lead)
        shares[label] = _collective_share(sharded_fn, dev)
        dist.barrier()

    def counted_run(label, fn):
        _sync(dev)
        dia.reset_launches()
        bem_assembly.reset_launches()
        result = fn()
        _sync(dev)
        launches[label] = dict(dia=dict(dia.LAUNCHES_BY_SHAPE),
                               bem={v: c for v, c in bem_assembly.LAUNCHES.items() if c})
        return result

    # (a) the headline sweep split by frequency lanes
    t0 = time.perf_counter()
    meshes = box_hierarchy(BENCH_N, BENCH_LEVELS)
    mg = GeometricMultigrid(meshes, robin_tags=WALLS, dtype=torch.float32, device=dev)
    nm = NodeMajorRoomSweep(RoomSweepModel(meshes[0], assembler=mg.assemblers[0], **ROOM), mg)
    params = nm.params()
    _sync(dev)
    say(f"(a) host build n={BENCH_N} on each rank: {time.perf_counter() - t0:.2f} s")
    n_freqs = BENCH_FREQS
    ks = torch.linspace(0.55, 2.2, n_freqs, dtype=torch.float32, device=dev)
    lanes = n_freqs // world
    knobs = dict(SWEEP_KNOBS, freq_chunk=min(BENCH_CHUNK, lanes))
    config = KrylovConfig(max_iterations=500, tolerance=1e-5, restart=6)
    fmesh = init_device_mesh("cuda", (world,), mesh_dim_names=("freq",))
    sharded = nm.sharded_sweep_fn(fmesh, config, **knobs)
    p, its, conv = counted_run("sweep", lambda: sharded(params, ks))
    mine = slice(rank * lanes, (rank + 1) * lanes)
    p1, its1, conv1 = nm.sweep_fn(config, **knobs)(params, ks[mine])
    p_err = float(torch.max(torch.abs(p[mine] - p1)) / torch.max(torch.abs(p1)))
    its_equal = bool(torch.equal(its[mine], its1))
    modes = {key[0] for key in launches["sweep"]["dia"]}
    say(f"(a) sharded sweep {n_freqs} x {meshes[0].num_nodes} over {world} rank(s), "
        f"{lanes} lanes each in chunks of {knobs['freq_chunk']}: converged {int(conv.sum())}/"
        f"{n_freqs}, iterations mean {float(its.float().mean()):.3f} max {int(its.max())}; "
        f"this rank's lanes vs the unsharded sweep of its chunk: max err {p_err:.3e} of max|p| "
        f"(limit {PAR_SWEEP_TOL:g}), iterations equal {its_equal}; DIA modes launched "
        f"{sorted(modes)}")
    if int(conv.sum()) != n_freqs or not p_err <= PAR_SWEEP_TOL or not its_equal:
        fail(f"(a) sharded sweep: converged {int(conv.sum())}, err {p_err:.3e}, "
             f"iterations equal {its_equal}")
    if modes != set(MODES):
        fail(f"(a) the sweep launched the DIA modes {sorted(modes)}, not {MODES}")
    if not bool(torch.isfinite(p).all()) or tuple(p.shape) != (n_freqs, 2):
        fail(f"(a) bad pressures: shape {tuple(p.shape)}")
    # one card's baseline: the whole band in the ranks' chunks (the same
    # anchors per chunk), so both sides solve the same systems
    full = nm.sweep_fn(config, **knobs)
    out["sweep_its"] = dict(sharded=float(its.float().mean()))
    if lead:
        pf, itsf, convf = full(params, ks)
        f_err = float(torch.max(torch.abs(p - pf)) / torch.max(torch.abs(pf)))
        mean_f = out["sweep_its"]["one_card"] = float(itsf.float().mean())
        d_its = abs(mean_f - out["sweep_its"]["sharded"]) / mean_f
        say(f"(a) one card's sweep of the whole band in the ranks' chunks: converged "
            f"{int(convf.sum())}/{n_freqs}, iterations mean {mean_f:.4f} (sharded "
            f"{out['sweep_its']['sharded']:.4f}; limit {PAR_CROSS_ITS:g} apart), lanes with equal "
            f"iterations {int((its == itsf).sum())}/{n_freqs}; vs the sharded lanes max err "
            f"{f_err:.3e} of max|p| (limit {PAR_CROSS_TOL:g})")
        if not (bool(convf.all()) and f_err <= PAR_CROSS_TOL and d_its <= PAR_CROSS_ITS):
            fail(f"(a) one card's sweep differs from the sharded one: err {f_err:.3e}, "
                 f"iteration means {mean_f:.4f} / {out['sweep_its']['sharded']:.4f}")
        del pf
    timed("(a) sweep", lambda: sharded(params, ks), lambda: full(params, ks))
    del p1, full
    torch.cuda.empty_cache()

    # (b) BemSolver with a device mesh: each rank assembles its rows
    dmesh = init_device_mesh("cuda", (world,), mesh_dim_names=("dof",))
    out["collective_us"] = _collective_us(dev, dmesh.get_group("dof"), 5120 // world)
    out["bem_rows"] = -(-(20 * 4 ** BEM_SUBDIV) // world)
    for variant, ka, bm in PAR_BEM_CASES:
        prob = BemProblem.rigid_sphere(ka, subdivisions=BEM_SUBDIV)
        base = dict(method=SolverMethod.GMRES, tolerance=PATH3_GMRES_TOL, burton_miller=bm)
        solver_sh = BemSolver(BemSolverConfig(**base, device_mesh=dmesh), device=dev)
        solver_1 = BemSolver(BemSolverConfig(**base), device=dev)
        sol = counted_run(variant, lambda: solver_sh.solve(prob))
        if launches[variant]["bem"].get(variant, 0) == 0:
            fail(f"(b) {variant}: the kernel was not launched: {launches[variant]}")
        info = sol.info
        if lead:
            ref = solver_1.solve(prob)
            mesh5 = prob.mesh
            k = prob.physics.wave_number
            centers = torch.tensor(mesh5.centers, dtype=torch.float32, device=dev)
            b = prob.incident.pressure(centers, k)
            if bm:
                beta = solver_1.burton_miller_beta(prob)
                a = assemble_burton_miller(mesh5, k, beta, device=dev)
                normals = torch.tensor(mesh5.normals, dtype=torch.float32, device=dev)
                b = b - beta * prob.incident.normal_derivative(centers, normals, k)
            else:
                a = assemble_collocation_matrix(mesh5, k, device=dev)
            res = float(torch.linalg.norm(a @ sol.surface_pressure - b) / torch.linalg.norm(b))
            err = float(torch.linalg.norm(sol.surface_pressure - ref.surface_pressure)
                        / torch.linalg.norm(ref.surface_pressure))
            d_it = abs(info["iterations"] - ref.info["iterations"])
            say(f"(b) BemSolver {variant} ka {ka:g} N = {mesh5.num_elements} over {world} rank(s), "
                f"{out['bem_rows']} rows each: converged {info['converged']}, {info['iterations']} "
                f"iterations (unsharded {ref.info['iterations']}), ||A p - b||/||b|| {res:.3e} "
                f"(limit {PAR_RESIDUAL:g}), vs unsharded rel {err:.3e} (limit {PAR_BEM_TOL:g}), "
                f"sharded_over {info.get('sharded_over')}, launches {launches[variant]['bem']}")
            if not (info["converged"] and res <= PAR_RESIDUAL and err <= PAR_BEM_TOL
                    and d_it <= PAR_ITER_TOL and info.get("sharded_over") == world):
                fail(f"(b) {variant}: {info}, residual {res:.3e}, err {err:.3e}")
            del a, ref
        timed(f"(b) {variant}", lambda: solver_sh.solve(prob), lambda: solver_1.solve(prob))
        torch.cuda.empty_cache()

    # (c) the halo ELL, device Schwarz and Ghysels GMRES on a FEM system
    t0 = time.perf_counter()
    asm = HelmholtzAssembler(unit_cube_tetrahedra(PAR_FEM_N), robin_tags=WALLS, dtype=f64,
                             device=dev)
    vals = asm.system_values(PAR_FEM_K, {t: -1j * PAR_FEM_K * 0.2 for t in WALLS})
    csr = CsrMatrix(asm.csr.indptr, asm.csr.indices, vals.cpu().numpy(), asm.csr.shape)
    n = csr.shape[0]
    xs = np.linspace(0.0, 1.0, n)
    rhs = np.exp(-((xs - 0.4) ** 2) / 0.02).astype(np.complex128)
    system = build_sharded_system(csr, rhs, world, schwarz_overlap=1, device=dev)
    say(f"(c) FEM system n={PAR_FEM_N}: {n} nodes, {csr.nnz} nonzeros, halo {system.ell.halo}, "
        f"Schwarz halo {system.schwarz.overlap}, block {system.schwarz.inv_blocks.shape[-1]}, "
        f"built in {time.perf_counter() - t0:.2f} s")
    x_direct = scipy.sparse.linalg.spsolve(
        scipy.sparse.csr_matrix((csr.data, csr.indices, csr.indptr), shape=csr.shape).tocsc(), rhs)
    note("(c) direct solve done")
    kcfg = KrylovConfig(**PAR_FEM_GMRES)
    ell_op = csr.to_ell().operator(device=dev)
    pre1 = AdditiveSchwarz.from_csr(csr, world, 1, device=dev)
    note("(c) unsharded ELL operator and Schwarz built")
    rhs_t = torch.tensor(rhs, device=dev)
    for label, solver in (("gmres", gmres), ("ghysels", gmres_pipelined_ghysels)):
        solve = sharded_gmres_fn(dmesh, kcfg, solver=solver)
        sol = solve(system)
        x = unshard(sol.x, n).cpu().numpy()
        err = float(np.max(np.abs(x - x_direct)) / np.max(np.abs(x_direct)))
        say(f"(c) sharded {label} + device Schwarz: converged {bool(sol.converged)}, "
            f"{int(sol.iterations)} iterations, vs scipy's direct solve {err:.3e} of max|x| "
            f"(limit {PAR_FEM_TOL:g})")
        if not (bool(sol.converged) and err <= PAR_FEM_TOL):
            fail(f"(c) {label}: converged {bool(sol.converged)}, err {err:.3e}")
        timed(f"(c) {label}", lambda: solve(system),
              lambda: solver(ell_op, rhs_t, config=kcfg, preconditioner=pre1))
    del system, ell_op, pre1, asm
    torch.cuda.empty_cache()

    # (d), (e) the cluster-sharded SLFMM and the sharded MLFMM tree
    inc = plane_wave((0.0, 0.0, 1.0))
    rng = np.random.default_rng(0)
    fmm_mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("fmm",))
    for label, subdiv, k, beta, build, gcfg, shard, mv_fn, solve_fn in (
            ("(d) slfmm", FMM_SUBDIV, FMM_K, 1j / FMM_K,
             lambda m, k, beta: fmm.build_slfmm_system(m, k, beta=beta, stability_tau=1e4,
                                                       agg_phase_f32=True, dtype=f64, device=dev),
             FMM_GMRES, shard_slfmm, sharded_slfmm_matvec_fn, sharded_slfmm_solve_fn),
            ("(e) mlfmm tree", MLFMM_SUBDIV, MLFMM_K, 0.0,
             lambda m, k, beta: fmm.build_mlfmm_tree_system(m, k, **MLFMM_BUILD, dtype=f64,
                                                            device=dev),
             MLFMM_GMRES, shard_mlfmm_tree, sharded_mlfmm_tree_matvec_fn,
             sharded_mlfmm_tree_solve_fn)):
        mesh_f = icosphere(1.0, subdiv)
        nf = mesh_f.num_elements
        t0 = time.perf_counter()
        op64 = build(mesh_f, k, beta)
        pre64 = fmm.ClusterBlockPreconditioner.from_operator(op64)
        sharded_op = shard(op64.data, world).to(c64)
        op32, pre32 = fmm.gather_form(op64.to(c64)), pre64.to(c64)
        _sync(dev)
        t_build = time.perf_counter() - t0
        x = torch.as_tensor(rng.standard_normal(nf) + 1j * rng.standard_normal(nf),
                            dtype=c64, device=dev)
        mv = mv_fn(fmm_mesh)
        y = mv(sharded_op, x)
        y1 = op32.matvec(x)
        mv_err = float(torch.linalg.norm(y - y1) / torch.linalg.norm(y1))
        rhs64 = _rigid_rhs(mesh_f, inc, k, beta, {"dtype": f64, "device": dev})
        cfg = KrylovConfig(**gcfg)
        solve = solve_fn(fmm_mesh, cfg)
        sol = solve(sharded_op, pre32, rhs64.to(c64))
        if lead:
            ref = gmres(op32, rhs64.to(c64), config=cfg, preconditioner=pre32)
            sol64 = gmres(fmm.gather_form(op64), rhs64, config=cfg, preconditioner=pre64)
            mie = _mie_surface(mesh_f, k, dev, max(60, int(2 * k) + 20),
                               float(np.linalg.norm(mesh_f.centers, axis=1).mean()))
            mie_sh, mie64 = rel_l2(sol.x, mie), rel_l2(sol64.x, mie)
            d_it = abs(int(sol.iterations) - int(ref.iterations))
            say(f"{label} N = {nf}, k = {k:g}: build + shard {t_build:.2f} s on each rank; "
                f"sharded matvec vs unsharded gather form rel {mv_err:.3e} (limit "
                f"{PAR_FMM_MATVEC_TOL:g}); sharded GMRES converged {bool(sol.converged)}, "
                f"{int(sol.iterations)} iterations (unsharded {int(ref.iterations)}), Mie rel L2 "
                f"{mie_sh:.4e} vs float64 {mie64:.4e} (diff limit {FMM_MIE_TOL:g})")
            if not (mv_err <= PAR_FMM_MATVEC_TOL and bool(sol.converged) and d_it <= PAR_ITER_TOL
                    and abs(mie_sh - mie64) <= FMM_MIE_TOL):
                fail(f"{label}: matvec {mv_err:.3e}, converged {bool(sol.converged)}, iterations "
                     f"{int(sol.iterations)} vs {int(ref.iterations)}, Mie {mie_sh:.4e} vs "
                     f"{mie64:.4e}")
            del ref, sol64
        timed(f"{label} matvec", lambda: mv(sharded_op, x), lambda: op32.matvec(x))
        timed(f"{label} solve", lambda: solve(sharded_op, pre32, rhs64.to(c64)),
              lambda: gmres(op32, rhs64.to(c64), config=cfg, preconditioner=pre32))
        del op64, pre64, sharded_op, op32, pre32
        torch.cuda.empty_cache()

    # (f) the smaller routes, then the port's dry run at n = world
    mesh_2d = sweep_mesh(world, dof_parallel=2 if world % 2 == 0 and world >= 4 else 1)
    model = RoomSweepModel(unit_cube_tetrahedra(PAR_ROOM_N), wall_tags=WALLS, absorption=0.1,
                           listening_positions=((0.25, 0.25, 0.25), (0.7, 0.6, 0.4)), device=dev)
    rcfg = KrylovConfig(max_iterations=400, tolerance=1e-5, restart=20)

    def step(prm, kk):
        return sweep_pressure(prm, kk, absorption=model.absorption, config=rcfg,
                              num_nodes=model.num_nodes, ell_width=model.ell_width)

    rks = torch.linspace(0.8, 2.5, 8 * world, dtype=torch.float32)
    rp, rits, rconv = shard_frequency_sweep(mesh_2d, step)(shard_room_params(mesh_2d,
                                                                             model.params()), rks)
    up, uits, _ = step(model.params(), rks.to(dev))
    r_err = float(torch.max(torch.abs(rp - up)) / torch.max(torch.abs(up)))
    pop = torch.as_tensor(np.random.default_rng(5).uniform(-5.12, 5.12,
                                                           (PAR_DE_POP, PAR_DE_DIM)), device=dev)
    e = shard_population_eval(mesh_2d, functions.rastrigin)(pop)
    e1 = torch.func.vmap(functions.rastrigin)(pop)
    de_err = float(torch.max(torch.abs(e - e1) / torch.clamp_min(torch.abs(e1), 1.0)))
    say(f"(f) shard_frequency_sweep + shard_room_params, {len(rks)} wavenumbers over "
        f"{tuple(mesh_2d.shape)} (freq x dof): converged {int(rconv.sum())}/{len(rks)}, vs "
        f"unsharded {r_err:.3e} of max|p| (limit {PAR_ROOM_TOL:g}), iterations equal "
        f"{bool(torch.equal(rits, uits))}; shard_population_eval rastrigin {PAR_DE_POP} x "
        f"{PAR_DE_DIM}: max diff {de_err:.3e} of max(1, |f|) (limit 1e-12)")
    if not (bool(rconv.all()) and r_err <= PAR_ROOM_TOL and de_err <= 1e-12):
        fail(f"(f): room sweep err {r_err:.3e}, DE err {de_err:.3e}")
    timed("(f) de population", lambda: shard_population_eval(mesh_2d, functions.rastrigin)(pop),
          lambda: torch.func.vmap(functions.rastrigin)(pop))
    t0 = time.perf_counter()
    r = dryrun._rank(rank, world, "cuda")
    if lead:
        say(dryrun.line(world, r) + f" ({time.perf_counter() - t0:.1f} s)")
    out["seconds"] = time.perf_counter() - t_rank
    return out


def parallel_phase(ops, dia, nm, dev, records, bem_timed):
    """Phase 21: spawn one NCCL rank per card, run ``parallel_rank`` on
    each, print what the ranks return, then hold against its twin and time
    every kernel shape the ranks launched that no phase timed (DIA
    ``records`` and the BEM shapes in ``bem_timed``, both updated).
    Returns (the sweep's DIA launches by shape, {variant: [record]})."""
    import torch

    from mathaudio_tpu_torch.bem import sweep
    from mathaudio_tpu_torch.bem.mesh import icosphere
    from mathaudio_tpu_torch.parallel.launch import launch

    t_phase = time.perf_counter()
    world = torch.cuda.device_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"parallel: {world} NCCL rank(s), one per card")
    t0 = time.perf_counter()
    outs = launch(parallel_rank, world, backend="nccl", timeout=PAR_TIMEOUT,
                  join_timeout=PAR_JOIN)
    t_ranks = time.perf_counter() - t0
    for rank, o in enumerate(outs):
        for line in (o["lines"] if rank == 0 else o["lines"][:2]):
            log(f"parallel rank {rank}/{world} ({o['backend']}, {o['device']}): {line}")
    lead = outs[0]
    us = lead["collective_us"]
    log(f"parallel: one all_reduce of a complex scalar {us['all_reduce']:.1f} us, one all_gather of "
        f"{5120 // world} complex64 per rank {us['all_gather']:.1f} us (rank 0, 100 synchronised "
        f"calls each)")
    for label, w in lead["walls"].items():
        nccl_ms, busy_ms, host_ms = lead["shares"][label]
        worst = max(o["shares"][label][0] / max(o["shares"][label][1], 1e-9) for o in outs)
        line = f"parallel {label}: sharded over {world} rank(s) {w['sharded']:.3f} ms"
        if "unsharded" in w:
            line += f", unsharded on one card {w['unsharded']:.3f} ms"
        log(f"{line} (medians of 3 after a warm run, in turns); NCCL kernels {nccl_ms:.3f} of "
            f"{busy_ms:.3f} device ms ({100 * nccl_ms / max(busy_ms, 1e-9):.1f}%, worst rank "
            f"{100 * worst:.1f}%), host time in the collective calls {host_ms:.3f} ms, in a "
            f"profiled sharded run")
    wall, its = lead["walls"]["(a) sweep"], lead["sweep_its"]
    n_nodes = nm.params().fine_tables.k.shape[1]
    log(f"parallel (a) DoF-solves/s: sharded over {world} rank(s) "
        f"{n_nodes * BENCH_FREQS / (wall['sharded'] / 1e3):.4e} (iterations mean "
        f"{its['sharded']:.3f}), one card in the ranks' chunks "
        f"{n_nodes * BENCH_FREQS / (wall['unsharded'] / 1e3):.4e} (iterations mean "
        f"{its['one_card']:.3f}) (x{wall['unsharded'] / wall['sharded']:.2f})")

    # the sweep's DIA launches (summed over ranks) and the shapes no phase timed
    by_shape = {}
    for o in outs:
        for key, count in o["launches"]["sweep"]["dia"].items():
            by_shape[key] = by_shape.get(key, 0) + count
    params = nm.params()
    by_n = {params.fine_tables.k.shape[1]: ("fine", params.offsets[0], params.fine_tables, False),
            params.levels[1].tables.k.shape[1]: ("level1", params.offsets[1],
                                                 params.levels[1].tables, True)}
    ks = torch.linspace(0.55, 2.2, BENCH_FREQS, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2121)
    for key in sorted(set(by_shape) - set(records)):
        mode, n, nf, x0 = key
        label, offs, tabs, shifted = by_n[n]
        cm, cb = _lanes(ks[:nf], shifted, torch.complex64, dev)
        x = None if x0 else _rand_complex((n, nf), torch.complex64, gen, dev)
        r = None if mode == "matvec" else _rand_complex((n, nf), torch.complex64, gen, dev)
        records[key] = stencil_record(dia, f"parallel {label}", mode, offs, tabs, cm, cb, x, r,
                                      dev)
    for key, count in sorted(by_shape.items()):
        log(f"  parallel DIA launches {key[0]}{'(x=0)' if key[3] else ''} at {key[1]} x "
            f"{key[2]}: {count} (summed over the ranks)")

    # the BEM row blocks (rows x 5120, F=1): every rank launched the same shape
    bem_records = {}
    rows = lead["bem_rows"]
    st = sweep.sweep_statics(icosphere(1.0, BEM_SUBDIV), dtype=torch.float32, device=dev)
    n = st.centers.shape[0]
    twin = twin_pairwise(ops)
    for variant, ka, _ in PAR_BEM_CASES:
        count = sum(o["launches"][variant]["bem"].get(variant, 0) for o in outs)
        shape = (variant, rows, n)
        if shape not in bem_timed:  # the first rank's block: its diagonal is the surface's own
            ks1 = torch.tensor([ka], dtype=torch.float32, device=dev)
            nx = st.normals[:rows] if variant == "burton_miller" else None
            bem_timed[shape] = bem_kernel_record(
                f"parallel (b) f32 {rows} x {n} F=1", ops, twin, variant,
                (st.centers[:rows], nx, st.qp, st.normals, st.qw, ks1), True)
        bem_records.setdefault(variant, []).append(dict(bem_timed[shape], launches=count,
                                                        path="parallel"))
        log(f"  parallel (b) {variant} launches at {rows} x {n}, F=1: {count} (summed over the "
            f"ranks)")
    log(f"parallel: ranks {t_ranks:.1f} s (spawn included; rank 0 {lead['seconds']:.1f} s), "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return by_shape, bem_records


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one run of each path (torch.profiler) and print "
                         "device time by kernel and the device's idle share")
    ap.add_argument("--ptxas", action="store_true",
                    help="also print the registers, shared memory and spills ptxas reports for "
                         "every kernel of both sources, and fail if any kernel spills")
    ap.add_argument("--only", choices=("parallel",),
                    help="run only the kernels' builds and phase 21 (path 15, the sharded "
                         "routes over every card) and print their kernels line")
    cli = ap.parse_args()
    profile = cli.profile
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from mathaudio_tpu_torch import kernels
    from mathaudio_tpu_torch.fem import dia
    from mathaudio_tpu_torch.fem.multigrid import GeometricMultigrid, box_hierarchy
    from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel
    from mathaudio_tpu_torch.models.room_sweep_nm import NodeMajorRoomSweep
    from mathaudio_tpu_torch.ops import bem_assembly
    from mathaudio_tpu_torch.solvers.krylov import KrylovConfig

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 1. build, one nvcc per source, started together
    sources = ("dia_stencil", "bem_pairwise")
    t0 = time.perf_counter()
    fresh = [not kernels.library_path(name).exists() for name in sources]
    kernels.build_all(sources)
    for name, new in zip(sources, fresh):
        kernels.load(name)
        log(f"build: {name}.cu -> {kernels.library_path(name).name} {'built' if new else 'cached'}")
    log(f"build: {len(sources)} sources in {time.perf_counter() - t0:.2f} s")
    if cli.ptxas:
        for name in sources:
            for line in kernels.ptxas_report(name):
                log(f"ptxas {name}: {line}")
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if spill and spill.groups() != ("0", "0"):
                    raise AssertionError(f"a kernel spills registers: {line}")

    # host build at the bench shape (float32) and a small float64 one
    t0 = time.perf_counter()
    meshes = box_hierarchy(BENCH_N, BENCH_LEVELS)
    mg = GeometricMultigrid(meshes, robin_tags=WALLS, dtype=torch.float32, device=dev)
    nm = NodeMajorRoomSweep(RoomSweepModel(meshes[0], assembler=mg.assemblers[0], **ROOM), mg)
    torch.cuda.synchronize()
    log(f"host build n={BENCH_N}: {meshes[0].num_nodes} nodes, {meshes[0].num_elements} tets, "
        f"levels {[m.num_nodes for m in meshes]}, {time.perf_counter() - t0:.2f} s")
    if cli.only == "parallel":
        return parallel_only(bem_assembly, dia, nm, dev, t_start)
    small = {}
    for where in (dev, torch.device("cpu")):
        sm = box_hierarchy(8, 3)
        smg = GeometricMultigrid(sm, robin_tags=WALLS, dtype=torch.float64, device=where)
        small[where.type] = NodeMajorRoomSweep(
            RoomSweepModel(sm[0], assembler=smg.assemblers[0], **ROOM), smg)
    ks = torch.linspace(0.55, 2.2, BENCH_FREQS, dtype=torch.float32, device=dev)

    # 2. kernels vs twins
    records = kernel_phase(dia, nm, dev, small["cuda"], ks)

    # 3. the main path, counted
    config = KrylovConfig(max_iterations=500, tolerance=1e-5, restart=6)
    sweep = nm.sweep_fn(config, **SWEEP_KNOBS)
    params = nm.params()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dia.reset_launches()
    bem_assembly.reset_launches()
    t0 = time.perf_counter()
    p, its, conv = sweep(params, ks)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = dict(dia.LAUNCHES)
    by_shape = dict(dia.LAUNCHES_BY_SHAPE)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    n_conv = int(conv.sum())
    its_f = its.float()
    log(f"sweep {BENCH_FREQS} x {meshes[0].num_nodes}: first run {t_first:.3f} s, "
        f"converged {n_conv}/{BENCH_FREQS}, iterations mean {float(its_f.mean()):.3f} "
        f"max {int(its.max())}, peak memory {peak_gib:.2f} GiB, launches {launches}")
    if any(launches[m] == 0 for m in MODES):
        raise AssertionError(f"a kernel was not launched on the main path: {launches}")
    for (mode, n, nf, x0), count in sorted(by_shape.items()):
        log(f"  sweep DIA launches {mode}{'(x=0)' if x0 else ''} at {n} x {nf}: {count}")
    if n_conv != BENCH_FREQS:
        raise AssertionError(f"only {n_conv}/{BENCH_FREQS} frequencies converged")
    if tuple(p.shape) != (BENCH_FREQS, 2) or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"bad pressure output: shape {tuple(p.shape)}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p2, its2, _ = sweep(params, ks)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t_sweep = statistics.median(times)
    if not torch.equal(its2, its):
        raise AssertionError("repeat sweep changed the iteration counts")
    log(f"sweep steady state: median {t_sweep * 1e3:.1f} ms of {[round(t * 1e3, 1) for t in times]} ms, "
        f"{meshes[0].num_nodes * BENCH_FREQS / t_sweep:.4e} DoF-solves/s")

    # 4a. 256-lane sub-band: kernels vs twins on the card
    sub = ks[:256].contiguous()
    p_k, its_k, conv_k = sweep(params, sub)
    kernel_stencil = dia.dia_stencil
    dia.dia_stencil = twin_stencil(dia)
    try:
        p_t, its_t, conv_t = sweep(params, sub)
    finally:
        dia.dia_stencil = kernel_stencil
    torch.cuda.synchronize()
    p_err = float(torch.max(torch.abs(p_k - p_t)) / torch.max(torch.abs(p_t)))
    it_diff = int(torch.max(torch.abs(its_k - its_t)))
    log(f"sub-band 256 kernel vs twins: pressure max err {p_err:.3e} of max|p|, "
        f"iteration diff max {it_diff}, converged {int(conv_k.sum())}/{int(conv_t.sum())}")
    if p_err > 1e-3 or it_diff > 1 or not (bool(conv_k.all()) and bool(conv_t.all())):
        raise AssertionError("sweep with kernels disagrees with the sweep with twins")

    # 4b. small float64 sweep: card (complex128 kernel) vs CPU (twins)
    small_cfg = KrylovConfig(**SMALL_KRYLOV)
    ks_small = torch.linspace(*SMALL_BAND, dtype=torch.float64)
    out = {}
    for where, snm in small.items():
        out[where] = snm.sweep_fn(small_cfg, **SMALL_KNOBS)(snm.params(), ks_small)
    (pg, ig, cg), (pc, ic, cc) = ((t.cpu() for t in out[w]) for w in ("cuda", "cpu"))
    s_err = float(torch.max(torch.abs(pg - pc)) / torch.max(torch.abs(pc)))
    log(f"small f64 sweep card vs CPU: pressure max err {s_err:.3e}, "
        f"iterations equal {bool(torch.equal(ig, ic))}, converged {int(cg.sum())}/{int(cc.sum())}")
    if s_err > 1e-9 or not torch.equal(ig, ic) or not bool(cg.all()):
        raise AssertionError("float64 sweep on the card disagrees with the CPU")

    # 4c. slice 6a: every FEM sweep option of the main path
    option_shapes, cycle_shapes, option_runs, _ = options_phase(dia, nm, dev, ks, config, p,
                                                                small, records)

    # 5-10. paths 2 and 3, the dense BEM sweep and the single-frequency engines
    bem_records, bem_runs = bem_path(dev, (dia, bem_assembly))

    # 11-12. slice 3: the biquad cascade at bench.py's shape, then the auto-EQ path
    iir_run = iir_phase(dev)
    fit_run = autoeq_phase(dev)

    # 13-14. slice 4b: the BEM applications on the card, with the oracles
    app_runs = {}
    for phase in (roomsim_phase, qa_phase):
        new_records, runs = phase(bem_assembly, dev, (dia, bem_assembly))
        app_runs.update(runs)
        for variant, recs in new_records.items():
            for r in recs:
                bem_records[variant].setdefault("other_shapes", []).append(r)
                bem_records[variant]["launches"] += r["launches"]

    # 15. slice 5a: the FMM on the card
    fmm_launches, fmm_runs, _ = fmm_phase(bem_assembly, dev, (dia, bem_assembly))
    app_runs.update(fmm_runs)
    for variant, count in fmm_launches.items():
        if variant in bem_records:
            bem_records[variant]["launches"] += count

    # 16. slice 5b: the MLFMM on the card
    mlfmm_launches, dl_record, _ = mlfmm_phase(bem_assembly, dev, (dia, bem_assembly))
    bem_records["double_layer"].setdefault("other_shapes", []).append(dl_record)
    for variant, count in mlfmm_launches.items():
        if variant in bem_records:
            bem_records[variant]["launches"] += count

    # 17. slices 6b and 6c: the general FEM problem, its solvers, the QA FEM
    # suite, and the BemSolver routes of the other Krylov solvers
    qa_fem_records, qa_fem_runs = qa_fem_phase(bem_assembly, dev, (dia, bem_assembly))
    app_runs.update(qa_fem_runs)
    for variant, recs in qa_fem_records.items():
        for r in recs:
            bem_records[variant].setdefault("other_shapes", []).append(r)
            bem_records[variant]["launches"] += r["launches"]

    # 18. slice 6c: the FEM room simulator
    fem_app_runs = roomsim_fem_phase(dev)

    # 19. slices 4c and 6c's rest: quadrilateral BEM, the near-pair upgrade,
    # the BEM inputs; every FEM element type with PML and refinement
    quad_records, quad_runs = bem_quads_phase(bem_assembly, dev, (dia, bem_assembly))
    app_runs.update(quad_runs)
    for variant, recs in quad_records.items():
        for r in recs:
            bem_records[variant].setdefault("other_shapes", []).append(r)
            bem_records[variant]["launches"] += r["launches"]
    fem_app_runs.update(fem_elements_phase(dev))

    # 20. slice 7b: the test-function registry, the four DE apps and the hull
    de_runs = de_apps_phase(dev)

    # 21. slice 8: the sharded routes, one NCCL rank per card; its sweep's
    # DIA launches stand beside the main sweep's as the "parallel" run
    bem_timed = {(v, *(int(d) for d in r["shape"].split("x"))): r
                 for v, rec in bem_records.items() for r in rec.get("other_shapes", [])
                 if r.get("nf") == 1}
    option_shapes["parallel"], par_bem = parallel_phase(bem_assembly, dia, nm, dev, records,
                                                        bem_timed)
    dia_line = dia_entries(records, by_shape, option_shapes, cycle_shapes)
    for variant, recs in par_bem.items():
        for r in recs:
            bem_records[variant].setdefault("other_shapes", []).append(r)
            bem_records[variant]["launches"] += r["launches"]

    # profiles last, once every kernel has run
    if profile:
        profile_run("fem", lambda: sweep(params, ks), "dia_stencil")
        for label, run in option_runs.items():
            profile_run(label, run, "dia_stencil")
        for label, run in bem_runs.items():
            profile_run(label, run, "bem_pairwise")
        profile_run("iir cascade", iir_run, None)
        profile_run("autoeq fit (maxiter 100)", fit_run, None)
        for label, run in app_runs.items():
            profile_run(label, run, "bem_pairwise")
        for label, run in fem_app_runs.items():
            profile_run(label, run, None)
        for label, run in de_runs.items():
            profile_run(label, run, None)

    kernels_line = {"kernels": dia_line + [
        dict(name=name, route="cuda", source=BEM_SOURCE, replaces=replaces, library_ms=None,
             **bem_records[variant])
        for variant, (name, replaces) in BEM_KERNELS.items()
    ]}
    for entry in kernels_line["kernels"]:
        if entry["launches"] < 1:
            raise AssertionError(f"kernel {entry['name']} was not launched on its path")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s "
        f"(kernel builds included{', with --profile' if profile else ''})")
    print(json.dumps(kernels_line), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def parallel_only(ops, dia, nm, dev, t_start) -> int:
    """``--only parallel``: phase 21 alone; its kernels line lists the
    kernels it launched, each at the shapes it launched them."""
    import torch

    records = {}
    by_shape, par_bem = parallel_phase(ops, dia, nm, dev, records, {})
    entries = []
    for mode in MODES:
        keys = sorted(k for k in by_shape if k[0] == mode)
        main_key = max(keys, key=lambda k: (k[1], k[2], not k[3]))
        entries.append(dict(
            name=f"dia_stencil_{mode}", route="cuda", source=KERNEL_SOURCE, replaces=TPU_KERNEL,
            launches=sum(by_shape[k] for k in keys), library_ms=None,
            **{k: v for k, v in records[main_key].items() if k != "x0"},
            other_shapes=[dict(records[k], launches=by_shape[k]) for k in keys if k != main_key],
            launches_at_shape=by_shape[main_key]))
    for variant, recs in par_bem.items():
        name, replaces = BEM_KERNELS[variant]
        entries.append(dict(name=name, route="cuda", source=BEM_SOURCE, replaces=replaces,
                            library_ms=None, **{k: v for k, v in recs[0].items() if k != "path"}))
    for entry in entries:
        if entry["launches"] < 1:
            raise AssertionError(f"kernel {entry['name']} was not launched on its path")
    log(f"chip_smoke --only parallel: passed in {time.perf_counter() - t_start:.1f} s "
        f"(kernel builds included)")
    print(json.dumps({"kernels": entries}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
