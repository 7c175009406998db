#!/usr/bin/env python3
"""Smoke run of graphite_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its numbers and its wall seconds on lines of their
own:

1. build the CUDA kernels from the checkout, one nvcc per source, all
   started together: K1 ``csrc/segsum.cu``, K2 ``csrc/pcg_dense.cu``, K3
   ``csrc/segprod.cu``, K4 / K5 ``csrc/segmv.cu``, K6 ``csrc/pcg_mf.cu``,
   the conditional graph nodes of ``jit_loop``, ``csrc/cond.cu``, K8,
   the sharded path's all-reduce over CUDA IPC, ``csrc/allreduce.cu``, and
   K7, the BAL reprojection factor's linearization and Hessian values,
   ``csrc/bal.cu``, K9, the PCG's dot, ``csrc/dot.cu``, K10, the landmark
   inverses and W = Hpl Hll^-1, and K13, w = Hll^-1 (t - sub),
   ``csrc/schur_w.cu``, K11, the SE3 pose-graph factors' linearization,
   chi2 and update, ``csrc/pose.cu``, K12, the CG step's vector work,
   ``csrc/pcg_step.cu``;
   and the host libraries (g++),
   ``native/structure.cpp`` and ``native/bal_loader.cpp``;
2. K1 vs its plain PyTorch version on the card, at the BAL Ladybug-49
   reduction shapes (seeded random inputs; each label names the plan's
   lanes per segment, ``group``): relative error <= 1e-5, two runs
   bitwise identical, and bitwise equal to the plain version on the CPU;
   K1's and ``index_add_``'s times also replayed from a CUDA graph, which
   leaves out the host's launch work (``device_only``);
3. K2 vs its plain version (``run_pcg``) on the first Schur system of the
   Ladybug-49 LM run (n = 441) and on a random SPD system (n = 1024):
   bitwise equal to the plain version on the card and on the CPU, two
   runs bitwise identical, the same number of CG steps (each label names
   the thread-block cluster's CTAs);
4. the Ladybug-49 path: synthetic (seed 0), FP32_FP32, Levenberg-Marquardt
   with PCGSchurSolver(10, 1.0, 5.0) for 10 iterations on the card and on
   the CPU (plain versions). The accept patterns must be equal, each
   iteration's chi2 within 1e-3, the final chi2 below the initial one, and
   K1 and K2 launched by the run (dense_pcg once per solve);
4a. K6 vs its plain version on the card, on the inputs of the first LM
   solve of sphere2500 (``make_sphere_se3(2500, seed=0)``, SE3,
   block-Jacobi and identity) and of the 2500-pose SE2 circle: bitwise
   equal to the plain version on the card and on the CPU, the same number
   of CG steps, two runs bitwise identical (each label names the
   cluster's CTAs); its float64 instance the same way on sphere2500's
   first FP64_FP64 solve (float64 J') and FP64_FP32 solve (float32 J'
   and inverse blocks), block-Jacobi and identity, the CPU's plain
   version held within 1e-12 (PyTorch's CPU float64 sqrt is an ulp off
   on some inputs); each with its device-only ms (20 solves replayed
   from a CUDA graph), bound and sync floor (its barriers and exchanges
   at ``kernel_sweep``'s cost each), the time before its redesign
   (``was_ms``: the float64 instance's, before its own design) and
   the instance timed (which design; registers, local memory, resident
   CTAs an SM and threads, as the card reports them);
4b. the sphere2500 path: FP32_FP32, Levenberg-Marquardt (damping 1e-4)
   with PCGSolver(50, 1e-10, 1e6, block-Jacobi) for 30 iterations on the
   card and on the CPU: accept patterns equal, chi2 within 1e-3 per
   iteration, final chi2 below the initial one, finite unit quaternions,
   K6 launched once per solve and no ``run_pcg`` host loop, the card's
   trajectory the CPU's bit for bit, K11's trial chi2 and update once an
   iteration and its linearization at the start and once an accepted
   step; ms per iteration, K6's and K11's times and launches, peak
   memory;
4c. K1 vs its plain version at every reduction site of that run (the
   factor rows of linearize, which JtPv shares, and the block-Jacobi
   blocks, per slot; seeded values): relative error <= 1e-5, two runs
   bitwise identical, bitwise equal to the CPU plain version;
4g. ``k11`` (run after phase 4c, on its problem): K11's four entries
   against their plain versions (the generic code: the jvp branch, the
   chi2 block, the scaling and b, ``apply_update``) at sphere2500's
   shapes (its first linearization point and scales; the update by a
   seeded step): bitwise equal on the card, on the CPU and replayed from
   a CUDA graph, bitwise repeatable, one launch a call; device-only ms
   (20 calls replayed from a graph) beside the bound, the plain
   version's, the host us a call and "library: none"; then the four
   float64 instances (``[f64]``) the same way on sphere2500 frozen under
   FP64_FP64, the CPU's plain version held within 1e-12 of each array's
   largest entry (CUDA's double sin, cos and atan2 are not the CPU's);
4d. sphere2500 with the K6 gate closed (``pcg_mf.J_BYTES_LIMIT = 0``),
   10 iterations on the card and on the CPU: ``run_pcg`` on
   ``hessian_matvec``, K1 launched, the same checks (bitwise, K11's
   launches);
4e. ``cond`` (run after phase 4c, on its problem): conditional regions
   (``device_loop.cond``, one conditional graph node each, built from
   ``csrc/cond.cu``: PyTorch's CUDA graphs expose none) against their
   plain version, ``if pred: body()``: an inner region holding K1, K2 and
   K6 (both cluster launches) nested in an outer one, replayed under each
   pair of predicates: bitwise the eager launches where both are true,
   untouched otherwise, each region's run count as expected; a replay
   whose outer region is skipped costs under a tenth of one that runs it;
   a loop (``device_loop.while_loop``, a "while" node) holding K1 runs
   1,500 passes in one replay, K1 launched and the loop's run count
   1,500, and no pass where its predicate starts false; the torch, CUDA
   and driver versions;
4f. ``host-setup``: Ladybug-49 and sphere2500 set up (freeze, the Hessian
   and Ladybug's Schur structure, one LM iteration, which builds the
   plans) with the host library and with every ``hostops`` entry swapped
   for its plain NumPy version, in turns (a native warm-up, then numpy,
   native, native, numpy):
   each section's seconds both ways, and every array and tensor of the
   structures, plans and freeze's host arrays equal (values and dtype);
5. the BAL Venice-1778 problem (993,923 points, 5,001,946 observations,
   dim_p 16,002) frozen on the card, its structures and one pass of the
   solve's stages (every host plan), with the host library, then again
   with the plain versions: each section's seconds both ways (and the
   builders' laps), every array equal, the host CPU, ``os.cpu_count()``,
   the library's threads and build seconds;
6. K1, K3 (by index, storing S = Hpp - the sums as ``schur_values``
   calls it, and from gathered streams), K4 and K5 vs their
   plain versions on the card at Venice-1778's own shapes (indices and
   segment plans of the frozen problem, values of its first
   linearization, or seeded where the site has none or its values are
   intermediate): relative error <= 1e-5, two runs bitwise identical,
   and bitwise equal to the plain version on the CPU. K3's label counts
   its segments by lanes; K3 also times its best library route, two
   calls (``torch.bmm`` on the gathered streams, then ``index_add_``),
   as a yardstick: no single PyTorch call computes its function. K3's
   base store (``[k3-store]``): bitwise ``product_store_plain`` of K3's
   own sums on the card, in place on S and replayed from a CUDA graph,
   one launch a call; its ms beside K3 storing the sums alone and the
   ops the store replaced (zero S, copy Hpp in, subtract). Then the
   float64 instances (``[k3-f64]``, ``[k4-f64]``, ``[k5-f64]``: the
   FP64_FP64 / FP64_BF16 Schur stage) on the same values in float64: K3
   by index storing S, K4's b_S and back-substitution, K5 (its column
   lanes capped to 128 to fit two tiles): within 1e-12 of the card's
   plain version, bitwise repeatable and bitwise the CPU's plain version,
   with the bound at the float64 rate (34 TFLOP/s) and, for K4 and K5, a
   float64 cuSPARSE SpMV. Each K3 line that times a kernel names the
   instance it times (its design, registers, local memory, resident CTAs
   an SM, threads and shared memory), K3's float64 one also its time
   before its own design;
6k. ``k7``: K7's four entries (``bal_residual``, ``bal_linearize``,
   ``bal_scale_b``, and ``bal_hessian_sum`` at each of Venice's three
   Hessian sites on its real plan) at Venice-1778's shapes (its first
   linearization point, its scales): bitwise equal to the plain version
   on the card and on the CPU, bitwise repeatable; each one's ms, its
   time before its redesign where it had one, its plain version's ms and
   its bound (bytes over 3.35 TB/s, float32 operations over 67 TFLOP/s
   and the float64 cos / sin over 34); then the float64 instances
   (``[f64]``, FP64_FP64's float64 storage and sums) on the same point
   cast to float64, bitwise their plain versions on the card and
   repeatable, every operation over 34 TFLOP/s in the bound (the Hessian
   sums' operations counted by need: 45 of Hpp's 81 entries, 6 of Hll's
   9; their "was" the previous design's time in both dtypes); each
   Hessian-sum kernel instance's registers and spills from the build
   log (none may spill); one eager ``compute_hessian_values`` launches
   three K7 sums and no K1;
6l. ``k9``: K9, the PCG's dot (``csrc/dot.cu``), vs its plain version
   ``tree_dot_plain`` at Venice's dim_p (float32 and float64) and
   sphere2500's n d (float32), seeded inputs with -0.0 entries: bitwise
   equal on the card, on the CPU and in a replayed CUDA graph, bitwise
   repeatable, one launch a call; its device-only ms (calls replayed
   from a graph) beside its time before its cluster design (one CTA of
   1,024 threads), the plain version's and ``torch.dot``'s (the library call: the
   same function in cuBLAS's order), its bound (both vectors once at 3.35
   TB/s) and the host us of a call;
6m. ``k10``: K10 (``csrc/schur_w.cu``), the landmark inverses and W =
   Hpl Hll^-1, vs its plain version (the ops ``schur_values`` ran before
   K10) at Venice's first ``schur_values`` inputs (993,923 3x3 Hll
   blocks, 4,995,188 (9, 3) Hpl blocks): bitwise equal on the card, on
   the CPU and replayed from a CUDA graph, bitwise repeatable, one launch
   a call; its ms, the plain version's (the replaced ops') and its bound
   (Hpl, Hll read once, W, Hll^-1 written once at 3.35 TB/s); then the
   same in float64 (``[k10-f64]``, K10's float64 instance);
6n. ``k12``: K12 (``csrc/pcg_step.cu``), the CG step's vector work, at
   the inputs of its first calls in Venice's first solve (recorded from
   ``PCGSchurSolver.solve`` at the start point): ``bjs_apply`` (the
   1,778 9x9 inverses, the residual normalised by its r.r), ``cg_advance``
   and ``cg_commit`` (16,002 entries each), each vs its plain version
   (the ops it replaced): bitwise equal on the card, on the CPU and
   replayed from a CUDA graph, bitwise repeatable, one launch a call;
   device-only ms (calls replayed from a graph: a call is a few us) beside
   the plain version's, the library call's (``torch.bmm`` on (1778, 9, 9)
   x (1778, 9, 1) for ``bjs_apply``; none for the others) and the bound;
6o. ``k13``: K13 (``csrc/schur_w.cu``'s ``hll_solve``), w = Hll^-1 (t -
   sub), at the same solve's two calls (b_S's, and the
   back-substitution's with K4's sums subtracted): 993,923 3x3 inverses;
   the same checks, its ms beside the plain version's (the replaced
   ``flat_block_mv`` and subtraction), ``torch.bmm`` on (993923, 3, 3) x
   (993923, 3, 1) and its bound; then the same two calls cast to float64
   (the FP64_FP64 path's dtypes, K13's ``[f64]`` instance);
7. the Venice-1778 path: 10 LM iterations of PCGSchurSolver(10, 1.0, 5.0)
   on the card (the block-sparse branch): final chi2 below the initial
   one, finite parameters, K1, K3, K4 and K5 launched, the S matvec kernel
   once per CG matvec, K12's advance and commit once per CG step and its
   ``bjs_apply`` once more per solve, K13 twice per solve; ms per
   iteration, kernel times, peak memory;
8. Venice-1778 on the CPU for 2 LM iterations, on the card problem's copy
   (``Problem.to("cpu")``: the same tensors and host structures, nothing
   frozen or built again): the accept pattern equal to the card's and
   chi2 within 1e-3 per iteration;
9. Ladybug-49 with the Venice branches forced (``dense_matvec_limit=0``,
   the Schur gates lowered), 10 iterations on the card and on the CPU:
   accept patterns equal, chi2 within 1e-3, K3, K4 and K5 launched, K12
   and K13 as in phase 7, with each kernel's launches and total ms.

The direct solvers (cuSOLVER / LAPACK Cholesky through
``torch.linalg.cholesky_ex``, batched per tree level on the multifrontal
branch; SciPy ``splu`` on the host branches). Each path checks its first
solve (damping 1e-4): ok, the float64 relative residual ||A x - b|| / ||b||
<= 1e-4 against the damped matrix A (S or H), two card runs bitwise
equal, and (up to n = 16,002) how far the card's and the CPU's float64
solutions of that system are apart; then its LM run on the card, and the
CPU's step from each of that run's states (its parameters and damping):
the same accept decision and chi2 within 1e-3 at every step
(``compare_lockstep``: independent float32 runs of a direct solver part
chaotically), the final chi2 below the initial one, finite parameters.
Each prints ms per LM iteration, the factorization's ms per call and its
bound (n^3/3 float64 operations over the float64 tensor-core peak; the
fronts' own work for the multifrontal branch), the failed solves (the
float32 S can be indefinite at small damping: ``ok=False``, a rejected
step) and peak memory:

10. ``direct-ladybug``: Ladybug-49 (Schur) with DenseCholeskySchurSolver,
    SparseDirectSchurSolver() (dense S, n = 441) and
    SparseDirectSchurSolver(on_device_dim_p=0) (host ``splu``), 10
    iterations each;
11. ``direct-full-h``: Ladybug-49 without elimination (dim_h 23,769) with
    DenseCholeskySolver and SparseDirectSolver() (its dense branch on the
    card; its host branch on the CPU), 3 iterations each (the dense
    solver's CPU steps from the first 2 states: ~20 s each);
12. ``direct-sphere2500``: SparseDirectSolver() (dense H, dim_h 14,994)
    and SparseDirectSolver(multifrontal=True), 6 iterations each (the
    CPU's steps from each state with the same branch forced: the dense
    branch's ~6 s a state); unit quaternions; the
    multifrontal plan's host seconds; K1 launched at
    every extend-add and right-hand-side site of the multifrontal
    factorization (the tree's depth, fronts and widest front printed),
    and K1 vs its plain version at the largest of each;
13. ``direct-venice`` (run after phase 7, on its problem):
    SparseDirectSchurSolver() (dense S at dim_p 16,002 on the card), 10
    iterations; phase 8 takes the CPU's step from its first 2 states;
14. ``cli``: ``graphite_tpu_torch.examples.bal.main`` for its six solvers
    at ``--synthetic ladybug --iterations 3`` and
    ``examples.pose_graph.main`` for its three at ``--poses 500
    --iterations 5``, in-process on the card: chi2 lowered.

Levenberg-Marquardt with ``jit_loop=True``: the iteration captured once
as a CUDA graph and replayed with no host read between replays (they run
under ``torch.cuda.set_sync_debug_mode("error")``). The graph holds the
JAX package's control flow as conditional regions: the step on the run
flag (nothing runs after a stop), then the accepted branch (relinearize,
refresh the solver) and the rejected one on the run flag and their side
of the step's accept flag, then the bookkeeping on the run flag; the
device-controlled PCG as one loop whose CG step runs while ``~done`` and
the step count is below ``max_iter``. Each path runs
it twice (the first call captures) and checks both runs bitwise equal to
the card's host loop from the same start (accept pattern, chi2, mu and
rho per iteration, final parameters) and each region's run count (over
both runs: the iterations, the accepted and the rejected ones); it
prints the capture seconds, ms per accepted, rejected
and after-stop replay (CUDA events) beside the host loop's, the launches
captured, the CG steps per iteration, the graph pool's memory and the
peak memory:

15. ``jit-ladybug``: Ladybug-49, PCGSchurSolver(10, 1.0, 5.0) (K1, and K2
    once per replay) and DenseCholeskySchurSolver, 10 iterations;
16. ``jit-venice`` (after phase 7, on its problem, against its run): 10
    iterations, K1, K3, K4, K5 and K9 in the graph (K5 captured once, in
    the CG step's loop body, launched once per CG step run; K9 twice in
    the step's region, three times in the CG step's body); ms per
    accepted and per rejected iteration beside the host loop's: the
    median rejected replay below the median accepted one by at least the
    relinearization's kernels; then the device kernels of a rejected and
    an accepted iteration run eagerly (``torch.profiler``), with K7 and
    K9, with the plain dots in K9's place (as before K9: fewer kernels
    with K9) and with K7's gate shut, the first two also as device ms by
    kernel name, the first also by host op and input shapes: no
    subtraction or fill over an S group (K3 stores S = Hpp - the sums)
    and, in the accepted iteration, no copy of an Hpl group or a stored
    J (the accepted branch relinearizes into the loop's state);
17. ``jit-sphere2500`` (after phase 4c, against phase 4b's run): 30
    iterations, K6 once per replay, K11's trial chi2 and update captured
    in the step's region and its linearization in the accepted branch's;
    then its first two iterations from the start run eagerly under
    ``torch.profiler``, with K11 and with K11's gates shut (the jvp branch
    of earlier PRs), by kernel name and by host op and input shapes:
    K11's kernels in the first trace only, fewer kernels with K11;
18. ``remask``: Ladybug-49 frozen with ``remaskable=True`` on the card, 10
    iterations under jit_loop; then every observation of points 0-77
    disabled (``set_factor_active(..., 0x80)``) and camera 1 fixed
    (``set_vertex_fixed``): the same cached graph (no re-capture, the mask
    tensors' ``data_ptr``s unchanged), bitwise a fresh remaskable freeze
    with the same edits, the 78 points and camera 1 bitwise at their start;
    the edits undone: bitwise the first run; ``levenberg_marquardt2`` (30
    iterations) stops at the CPU's iteration with its accept pattern, and
    each of its replays after the stop costs under 5% of its median
    accepted replay;
19. ``cli-jit``: ``examples.circle`` (float32: the free points within 1e-4
    of radius 4, as the JAX package's float32 run; points 2 and 4 at
    their start), ``examples.bal --synthetic ladybug --jit-loop --lm2``
    and ``examples.pose_graph --jit-loop``: chi2 lowered.

The precision policies (the JAX package's six: FP64_FP64, FP64_FP32,
FP64_BF16, FP32_FP32, FP32_BF16, FP32_FP16). K1 and the Schur stage's
kernels (K3, K4, K5, K10, K13) run in the dtype of their values,
float32 or float64 (float64 launches counted apart as ``[f64]``); K2
and K6 only where S or the graph is float32, K11 only in a float32
graph, K7 in either: its float32 entries in a float32 graph, its
float64 instances (``[f64]``) in a float64 one, never the other. Card-vs-CPU criteria: FP32_* bitwise (accept pattern,
chi2 per iteration, final parameters); FP64_FP64 the accept pattern and
chi2 within 1e-9 (the card's float64 cos / sin are not correctly
rounded, so not bitwise); FP64_FP32 and FP64_BF16 within 1e-3, or
``compare_lockstep`` where the runs part (a last-bit difference of the
float64 J can flip its rounding to float32 or bf16). Each prints ms per
LM iteration, peak memory and every kernel's launches:

20. ``k1-f64`` (after phase 6, on the Venice problem's plans): K1's
    float64 instance vs its plain version at Ladybug-49's sorted sites
    (seeded, the shapes of phase 2) and at Venice-1778's 5,001,946x3 ->
    993,924 point rows (sorted) and 5,001,946x9 -> 1,779 camera rows
    (permuted): bitwise equal to the CPU's plain version, two runs
    bitwise identical, within 1e-12 of the card's plain version (its
    ``index_add_`` adds in no fixed order); time, bound (bytes over 3.35
    TB/s, adds over the 34 TFLOP/s float64 rate) and float64
    ``index_add_`` time;
21. ``precision-ladybug``: Ladybug-49 under each policy, 10 iterations on
    the card and on the CPU, K2 launched where S is float32 (FP32_*,
    FP64_FP32) and never elsewhere; then FP64_FP64, FP64_BF16, FP64_FP32
    and FP32_BF16 again with phase 9's forced branches: K3, K4 and K5
    launched in the dtype of the Schur values (their ``[f64]``
    instances under FP64_FP64) and never in the other; K10 and K13 in
    the inverses' dtype and K7 in the graph's (``[f64]`` under the FP64
    policies) on every BAL run;
    then ``jit_loop`` under FP64_FP32 (forced branches: the casts at the
    K2, K4 and K5 sites allocate in the capture) and FP64_FP64, each
    bitwise the card's host loop, with capture seconds and pool memory;
22. ``precision-sphere2500``: FP32_BF16 (K6 once per solve, on the float32
    fold of the bf16 J), 30 iterations, and FP64_FP64 (K6's and K11's
    float64 instances, K6 once per solve, no float32 K6 or K11 launch),
    10 iterations; card vs CPU (FP64_FP64: the accept pattern, chi2
    within 1e-9), unit quaternions, ms per iteration and peak memory;
    FP64_FP64 also under ``jit_loop``, its replays bitwise the host loop;
23. ``precision-venice`` (after phase 8): Venice-1778 at full size
    under FP32_BF16 and FP64_FP64, 10 iterations each on the card (K1,
    K3, K4, K5 and K10 launched in the Schur values' dtype and K7 in the
    graph's: the ``[f64]`` instances under FP64_FP64, no float32 one)
    and on the CPU (the card problem's copy: FP32_BF16 1 iteration within
    1e-3, printed bitwise or not, FP64_FP64 2, the accept pattern (a rejection,
    then a step accepted on K7's float64 instances on the card) and chi2
    within 1e-9); ms per accepted
    and rejected iteration and peak memory beside phase 7's FP32_FP32
    run, the Schur kernels' launches beside FP32_FP32's, and the stored
    Jacobians' bytes; FP64_FP64 also under ``jit_loop``, its replays
    bitwise the host loop. Its Hessian and Schur structures are phase
    5's (topology only: the block offsets and factor ids are checked
    equal), not built again.

Gradient descent, Adam, covariance and the range-bearing example. Each
phase prints its numbers beside the card's name and power limit
(``nvidia-smi``):

24. ``first-order-venice`` (after phase 16, on its problem): GD (lr 0.1)
    and Adam (lr 0.3), FP32_FP32, 10 iterations each as replays of one
    captured iteration; ms per replay, the same step uncaptured on the
    card, capture seconds, graph pool and peak memory, K1's launches per
    replay and its ms per (eager) step, and whether chi2 fell (GD has no
    accept or reject: a rise is reported); then 2 iterations of their own
    capture from the same start, equal to the first 2 of the 10;
25. ``covariance-venice`` (after phase 24): ``joint_covariance``'s Schur
    path at damping 1e-2 for 4 cameras and 4 points (48 columns), stage
    by stage with CUDA events (Hessian values, ``schur_values`` (K3),
    densify, the float64 factor, b_S (K4) per column, the 48-column solve,
    back-substitution (K4) per column) and peak memory; each column's
    normwise backward error ||H_d x_j - e_j|| / (max diag(H_d) ||x_j|| +
    1), with H_d applied through ``hessian_matvec`` plus the damping
    diagonal, at most ``COV_BACKWARD_BOUND``; relative asymmetry at most
    ``COV_ASYMMETRY_BOUND``, a positive diagonal; the public call bitwise
    the staged run, with K3 once and K4 twice per column;
26. ``first-order-venice-cpu`` (after phase 8, on its CPU problem): the
    CPU's first 2 GD and Adam iterations bitwise the card's (history and
    parameters);
27. ``first-order-ladybug``: GD and Adam at Ladybug-49, FP32_FP32, 30
    iterations captured (twice: the second call only replays), bitwise the
    CPU run; the same prints as phase 24;
28. ``covariance-ladybug``: the Schur path (card vs CPU within 1e-9 of
    the largest entry: float64 factors, not bitwise) and the dense path on
    the full H (dim_h 23,769) at damping 1e-2, 4 cameras and 4 points;
    Schur vs dense on the card within kappa(S) x 4e-5 (the float32
    cancellation level of S, ROADMAP Queue C; kappa from the damped S's
    float64 eigenvalues); times, peak memory, launches;
29. ``range-bearing``: ``examples.range_bearing_slam.main`` at its default
    size (100 poses, 40 landmarks, 25 iterations: dim_p 297, K2) and at
    500 poses, 200 landmarks, 10 iterations (dim_p 1,497: a dense S with
    ``run_pcg`` on ``tree_matvec``),
    on the card and on the CPU: the same accept pattern, chi2 within
    1e-3; launches.

Factor-parallel sharding (``graphite_tpu_torch.parallel``: each rank a
slice of the factors, the cross-factor sums all-reduced in rank order, the
Schur triple products split by destination range on K3's gathered-stream
entry):

S1. ``shard-venice-w1`` (after phase 7, on its problem): ``sharded_lm`` at
    world size 1 over NCCL, 10 iterations: bitwise phase 7's host loop
    (accept pattern, chi2, final parameters), in the host loop and under
    ``jit_loop`` (its replays and regions printed as phases 15-18 print
    theirs); then phase 7's run for 3
    iterations from its parameters moved by one ulp, printed beside phase
    7's chi2 (how far a rounding-level change takes float32 Venice
    trajectories apart, the measure for S2's free-running chi2);
S2. ``shard-venice-w2`` (after phase 26): two ranks in two spawned
    processes on cuda:0 (a gloo group for the set-up; NCCL refuses two
    ranks on one card), Venice-1778 (5,001,946 observations: ``pad_factors_to=2`` adds none)
    taken frozen, host structures included, from this process, 3
    iterations, twice (the second run bitwise the first): the accept
    pattern of phase 7's first 3 iterations; rank 0 takes the unsharded
    step on the card from each state of the sharded run (the same accept
    decision, chi2 within 1e-3: independent float32 runs part, see
    PERF.md); the ranks' traces and parameters bitwise equal; K3's
    gathered-stream entry once per rank per iteration, its rtbl entry
    never, K1 at every rank-local reduction; rank 0's K3 at its own slice
    bitwise its plain version on the CPU (within 1e-5 of the card's, whose
    ``index_add_`` adds in no fixed order); ms per iteration, the
    collectives' share, each rank's device ms outside the collectives and
    its kernels' ms, each rank's peak memory. Every collective of S2-S5 on the card is a launch of K8 (the ranks'
    arenas mapped through CUDA IPC), and a third run of S2 swaps in K8's
    plain version (gloo) in the same ranks: bitwise the first; each
    rank's ms per iteration and the collectives' share on K8 and on gloo;
``k8`` (in the same ranks, after S2): K8 against its plain version at
    the sizes of S2's collectives (each distinct shape, sum or gather), in
    float32 and float64 (inputs with -0.0 entries): bitwise equal and
    bitwise repeatable; K8's ms (CUDA events around 5 calls replayed from
    one CUDA graph on both ranks), the plain version's, gloo's one call's
    and the bound ((world + 3) x the bytes of x for a sum, 2 world + 2 for
    a gather, at 3.35 TB/s); ``k8-w4``: 4 ranks on cuda:0 at small
    shapes, every rank bitwise the plain version;
S4. ``shard-venice-w2-graph`` (in the same ranks): Venice-1778 on 2 ranks
    under ``jit_loop``, PCGSchurSolver(10, 1.0, 5.0), 10 iterations: each
    rank's trace and parameters bitwise the same ranks' host loop, the
    ranks bitwise equal, no host sync in the replays (sync-debug mode
    "error"); replay ms accepted and rejected, K8's launches (top level
    and region runs), capture seconds, graph pool, peak memory per rank;
S3. ``shard-ladybug-w2`` (in the same ranks): Ladybug-49 with the Venice
    branches forced, 10 iterations on the card against the same ranks on
    the CPU: bitwise equal trajectories and parameters, K3's gathered
    entry launched; under ``jit_loop`` too, card (K8) and CPU (the plain
    version) bitwise each other and the host loops;
S5. ``shard-sphere2500-w2-graph`` (in the same ranks): sphere2500 on 2
    ranks under ``jit_loop``, PCGSolver(50, 1e-10, 1e6, block-Jacobi),
    30 iterations (K6's gate closed: the generic CG on ``hessian_matvec``,
    whose ``J^T J p`` is all-reduced in every CG step): bitwise the host
    loop; K8's runs inside the CG "while" node equal to the CG steps run.
    Two processes on one card are time-sliced, not concurrent: S2-S5's
    times measure that, not scaling.

K12 (``csrc/pcg_step.cu``) takes every CG step of ``run_pcg`` and
``run_pcg_fixed`` (K2's and K6's plain versions stay plain) and
block-Jacobi-Schur's apply; K13 (``schur_w.hll_solve``) every landmark
solve (float64 inverses counted apart, phases 20-23 check which ran):
phases 7, 9, 16 and S1-S4 check that the
advance and the commit launched once per CG step run, ``bjs_apply`` once
more per solve and K13 twice per solve (b_S and the back-substitution),
and phase 16's eager iterations make no dim_x vector inside a CG step
(``torch.cat`` calls counted by their result's size) and fill no landmark
segment (the trace's ops by input shape), and print their kernels beside
the parent's (PR 20's final run: 790 rejected, 832 accepted).

K10 (``csrc/schur_w.cu``) takes every ``schur_values`` of float32 or
float64 inverses (``[f64]`` apart, phases 20-23 check which ran): phases
4, 7, 16 and S1-S4 check that it launched once per ``schur_values`` call
(Ladybug's and Venice's one Hpl group), and phase 16's trace of the
eager iterations by host op holds none of the (4995188, 9, 3) products
it replaced.

K11 (``csrc/pose.cu``) takes every SE3 pose-graph set and SE3 vertex
update (``ops/cuda/pose.gate``, ``update_gate``), in its float64
instances (``[f64]``) those of a float64 graph: phases 4b, 4d, 17, S5,
``cli-jit`` (``examples.pose_graph --jit-loop``) and the FP32_BF16 pose
policy check that its float32 instance launched, the FP64_FP64 pose
policy that its float64 one did and the float32 one did not.

K7 (``csrc/bal.cu``) takes every BAL reprojection set of a float32 graph
and, in its float64 instances (``[f64]``), of a float64 graph
(``ops/cuda/bal.gate``): phases 4, 7, 9, 15, 16, 18, 21 and 23, 24, 25,
S2-S4 check that it launched (21 and 23 the graph dtype's instance and
never the other's) (in phase 16 the linearize and Hessian
entries inside the accepted branch's region, the trial chi2 in the
step's) and print its launches; phase 16 also counts the device kernels
of Venice's first two iterations from the start (one rejected, one
accepted) as the captured iteration's code run eagerly, each in a
``torch.profiler`` trace of its own, with K7 and K9, with the plain dots
and with K7's gate shut (the generic branch of earlier PRs).

A captured path's launches in the kernels JSON line are the launches
its replays ran: those captured outside every region times the replays,
those captured in a region times the runs of its body, read back from
the region's device counter (``remask`` sums its three graphs: the
remasked problem's, the fresh freeze's and LM2's; ``cli-jit`` counts each
CLI's capture once, since its loops are not reachable from the phase).

Prints the direct factorizations' JSON summary (``direct_factorizations``),
the kernels' JSON summary and the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``. K1's to K6's lines
also print their times before their redesign (``was_ms``, PERF.md's
kernel table). Each kernel's entry
holds its launches on every main path, its time, its plain version's
time, the library call's time where one PyTorch call computes the same
function (``index_add_`` for K1, a cuSPARSE SpMV through ``torch.mv`` on
a CSR copy of the blocks for K4 and K5) and its bound: the larger of its
bytes over the HBM rate and its float32 operations over the float32 peak
(each summed over the same shapes as the times). Any failure raises
(non-zero exit); without a card it exits 1 at once and prints no result.
"""

import concurrent.futures
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
import types
import warnings

VENICE = "venice-big"  # make_bal size name of BAL Venice-1778
DEVICE = "cuda"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def device_ms(fn, reps=20):
    """Mean device time of ``fn()`` in ms (CUDA events, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(out, ref):
    return float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): HBM3
# bandwidth and the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the float64 rate of the tensor cores (the same data sheet), which
# cuSOLVER's float64 Cholesky and cuBLAS's float64 products can use
FP64_OPS_PER_S = 67e12
# the float64 rate outside the tensor cores (the same data sheet): K1's
# float64 adds
FP64_VECTOR_OPS_PER_S = 34e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved_bytes, ops, ops_per_s=FP32_OPS_PER_S):
    """The least time the card could take for a call: (ms if only its
    bytes moved, ms if only its operations ran at ``ops_per_s``, float32
    by default). Each input is counted read once and each output written
    once."""
    return dict(bytes_ms=1e3 * moved_bytes / HBM_BYTES_PER_S,
                ops_ms=1e3 * ops / ops_per_s)


def bound_fields(b):
    """``bound_ms`` and ``bound_by`` of a ``bound`` (or a sum of them)."""
    by = "bytes" if b["bytes_ms"] >= b["ops_ms"] else "operations"
    return dict(bound_ms=max(b["bytes_ms"], b["ops_ms"]), bound_by=by)


def csr_from_blocks(blocks, brow, bcol, n_brows, n_bcols):
    """A CSR matrix of (n_brows*m, n_bcols*k) scalars in the blocks'
    dtype (float32 or float64) holding the (m, k) blocks ``blocks`` at
    block rows / columns ``brow`` / ``bcol`` (int64 tensors on the blocks'
    device). Built once per site, outside any timing: the library
    yardstick of K4 and K5 is one ``torch.mv`` on it (cuSPARSE SpMV)."""
    import torch

    nb, m, k = blocks.shape
    dev = blocks.device
    order = torch.argsort(brow * n_bcols + bcol)
    brow, bcol, blocks = brow[order], bcol[order], blocks[order]
    count = torch.bincount(brow, minlength=n_brows)
    start = torch.cumsum(count, 0) - count
    q = torch.arange(nb, device=dev) - start[brow]  # place in block row
    i = torch.arange(m, device=dev).view(1, m, 1)
    j = torch.arange(k, device=dev).view(1, 1, k)
    base = (m * k * start[brow] + q * k).view(nb, 1, 1)
    pos = (base + i * (count[brow] * k).view(nb, 1, 1) + j).reshape(-1)
    values = torch.empty(nb * m * k, dtype=blocks.dtype, device=dev)
    values[pos] = blocks.reshape(-1)
    cols = torch.empty(nb * m * k, dtype=torch.int32, device=dev)
    cols[pos] = (bcol.view(nb, 1, 1) * k + j).expand(nb, m, k).reshape(
        -1).int()
    del pos
    row_start = (m * k * start).view(-1, 1) + (
        torch.arange(m, device=dev).view(1, m) * (count * k).view(-1, 1))
    crow = torch.cat([row_start.reshape(-1),
                      torch.tensor([nb * m * k], device=dev)]).int()
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, values,
                                       (n_brows * m, n_bcols * k),
                                       check_invariants=False)


def phase_build():
    from graphite_tpu_torch.native import bal_loader, structure
    from graphite_tpu_torch.ops.cuda import (
        allreduce,
        bal,
        cond,
        dot,
        pcg_dense,
        pcg_mf,
        pcg_step,
        pose,
        schur_w,
        segmv,
        segsum,
        segsum_stream,
    )

    loaders = (segsum.load_kernel, pcg_dense.load_kernel,
               segsum_stream.load_product_kernel, segmv.load_kernel,
               pcg_mf.load_kernel, cond.load_kernel, allreduce.load_kernel,
               bal.load_kernel, dot.load_kernel, schur_w.load_kernel,
               pose.load_kernel, pcg_step.load_kernel, structure.library,
               bal_loader.library)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(loaders)) as pool:
        libs = list(pool.map(lambda load: load(), loaders))
    total = time.perf_counter() - t0
    print(f"[build] seconds={total:.3f} " + " ".join(
        f"{lib.name}={lib.build_seconds:.3f}s" for lib in libs))
    for lib in libs:
        if hasattr(lib, "instances"):  # a CUDA library: ptxas by instance
            for name, props in lib.instances():
                print(f"[build] {lib.name}: {name}: {props}")
            continue
        for line in getattr(lib, "log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {lib.name}: {line.strip()}")


# (rows, segments, width, destinations sorted, site) on the Ladybug-49 path
# (the Hessian sites: on its generic branch; K7 sums a gated set's itself)
K1_SHAPES = [
    (86_545, 1_225, 81, True, "schur product scatter (segsum)"),
    (31_843, 7_777, 3, True, "linearize b, points"),
    (31_843, 7_777, 9, True, "hessian Hll (generic branch)"),
    (31_843, 30_622, 27, True, "hessian Hpl (generic branch)"),
    (30_621, 7_776, 3, True, "landmark back-substitution"),
    (31_843, 50, 81, False, "hessian Hpp (generic branch), permuted"),
    (31_843, 50, 9, False, "linearize b, cameras, permuted"),
    (30_621, 49, 9, False, "b_schur pose rows, permuted"),
]

# K1's, K3's, K4's and K5's times before their redesign (the "was" times
# of PERF.md's kernel table; NVIDIA H100 80GB HBM3, 700 W), by (rows,
# width, permuted) or by name, printed beside this run's
WAS_MS = {
    (86_545, 81, False): "0.0370",
    (31_843, 3, False): "0.0258-0.0409", (31_843, 9, False): "0.0258-0.0409",
    (31_843, 27, False): "0.0258-0.0409", (30_621, 3, False): "0.0258-0.0409",
    (31_843, 81, True): "0.0458-0.0520", (31_843, 9, True): "0.0458-0.0520",
    (30_621, 9, True): "0.0458-0.0520",
    (2_744, 6, True): "0.0238 / 0.0272 (slot 0 / 1)",
    (2_744, 36, True): "0.0361 / 0.0233 (slot 0 / 1)",
    (5_001_946, 3, False): "0.0527", (5_001_946, 9, True): "0.4465",
    "s_matvec": "0.9215",
    "schur_values": "32.8372", "schur_values, gathered streams": "32.4457",
    "b_schur": "0.6013", "b_schur (kernel-6 form)": "0.5902",
    "back-substitution": "0.5524",
    # K2 and K6 on one CTA (PR 3's final run), before the cluster design
    "k2 ladybug": "0.3254",
    "k6 se3 bj": "5.2423", "k6 se3 identity": "4.5635",
    "k6 se2 bj": "2.2935",
    # the float64 instances of K3 and K6 before their own designs: the
    # float32 designs in double (NVIDIA H100 80GB HBM3, 700 W)
    "schur_values float64": "5.8925",
    "k6 se3 bj FP64_FP64": "1.7748", "k6 se3 identity FP64_FP64": "1.6711",
    "k6 se3 bj FP64_FP32": "1.6477", "k6 se3 identity FP64_FP32": "1.5521",
}


def was_ms(plan, width):
    return WAS_MS.get((plan.rows, width, plan.perm is not None))


def phase_k1(device):
    import numpy as np
    import torch

    from graphite_tpu_torch.kernel_sweep import graph_ms
    from graphite_tpu_torch.ops.cuda import segsum, segsum_stream

    rng = np.random.default_rng(0)
    stats = {}  # entry point -> one record per shape
    for k, ns, d, is_sorted, site in K1_SHAPES:
        seg = rng.integers(0, ns, k)
        if is_sorted:
            seg = np.sort(seg)
        plan = segsum.plan_segments(seg, ns, device, width=d)
        vals = torch.as_tensor(rng.standard_normal((k, d)).astype(np.float32),
                               device=device)
        wrapper = (segsum.sorted_segment_sum if "(segsum)" in site
                   else segsum_stream.streaming_segment_sum)
        name = ("segsum.sorted_segment_sum" if "(segsum)" in site
                else "segsum_stream.streaming_segment_sum")
        out = wrapper(vals, plan)
        again = wrapper(vals, plan)
        ref = segsum.segment_sum_plain(vals, plan)
        # the plain version on the CPU sums in the kernel's order
        ref_cpu = segsum.segment_sum_plain(
            vals.cpu(), segsum.plan_segments(seg, ns, "cpu", width=d))
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        abs_err = float((out - ref).abs().max())
        ms = device_ms(lambda: wrapper(vals, plan))
        plain_ms = device_ms(lambda: segsum.segment_sum_plain(vals, plan))
        library = k1_library(vals, torch.as_tensor(seg, device=device), ns)
        lib = device_ms(library, 10)
        # at these sizes the times above are mostly the host's launch
        # work; replayed from a CUDA graph, only the device's is left
        graph = graph_ms(lambda: wrapper(vals, plan))
        lib_graph = graph_ms(library)
        shape = f"{k}x{d}->{ns} group {plan.group}"
        print(f"[k1] {shape} {site}: rel_err={err:.3e} "
              f"max_abs_err={abs_err:.3e} bitwise_repeat="
              f"{torch.equal(out, again)} bitwise_vs_cpu_plain="
              f"{torch.equal(out.cpu(), ref_cpu)} ms={ms:.4f} "
              f"was_ms={was_ms(plan, d)} plain_ms={plain_ms:.4f} "
              f"index_add_ms={lib:.4f} device_only: ms={graph:.4f} "
              f"index_add_ms={lib_graph:.4f}")
        check(torch.equal(out, again), f"K1 not bitwise repeatable at {site}")
        check(torch.equal(out.cpu(), ref_cpu),
              f"K1 differs from the CPU plain version at {site}")
        check(err <= 1e-5, f"K1 rel err {err} > 1e-5 at {site}")
        stats.setdefault(name, []).append(dict(
            err=abs_err, ms=ms, plain_ms=plain_ms, shape=shape,
            library_ms=lib, **k1_bound(vals, plan)))
    return stats


def k1_bound(vals, plan):
    """K1 reads the values, the segment offsets and (unsorted) the sort
    permutation once, writes the sums once, and adds each value once (in
    float64 at the float64 rate)."""
    import torch

    rate = (FP64_VECTOR_OPS_PER_S if vals.dtype == torch.float64
            else FP32_OPS_PER_S)
    return bound(nbytes(vals, plan.offsets_i32, plan.perm_i32)
                 + vals.element_size() * plan.num_segments * vals.shape[1],
                 vals.numel(), rate)


def input_order_ids(plan):
    """The destination of each value row, in the values' own order."""
    import torch

    if plan.perm is None:
        return plan.seg
    ids = torch.empty_like(plan.seg)
    ids[plan.perm] = plan.seg
    return ids


def k1_library(vals, seg, num_segments):
    """The library call computing K1's sums: ``index_add_`` (float
    atomics) of the rows by their destinations ``seg`` (input order)."""
    import torch

    return lambda: torch.zeros(
        (num_segments, vals.shape[1]), dtype=vals.dtype,
        device=vals.device).index_add_(0, seg, vals)


def ladybug_problem(device, policy="FP32_FP32", pad_factors_to=1):
    """Ladybug-49 (``make_bal("ladybug", seed=0)``) under the precision
    policy named ``policy``, frozen on ``device``."""
    import torch

    import graphite_tpu_torch as gtt
    from graphite_tpu_torch.io import bal, synthetic

    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=getattr(gtt, policy))
    return g.freeze(device=torch.device(device),
                    pad_factors_to=pad_factors_to)


def first_schur_system(problem, solver, mu):
    """S, M and b_S of the first LM iteration's solve (damping ``mu``)."""
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
    )
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.preconditioners.block_jacobi_schur import (
        dense_preconditioner_matrix,
    )
    from graphite_tpu_torch.schur import (
        SchurOps,
        build_schur_structure,
        schur_values,
    )
    from graphite_tpu_torch.solvers.dense_cholesky_schur import schur_to_dense

    lin = linearize(problem, problem.params0)
    state = solver.prepare(problem, lin)
    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv = apply_damping(problem, hs, state.hvals, lin.diag, mu, False)
    sv = schur_values(problem, ss, hv)
    b_s = SchurOps(problem, ss, hv, sv).b_schur(lin.b)
    pstate = solver.preconditioner.prepare(problem, ss, sv)
    S = schur_to_dense(problem, ss, sv)
    M = dense_preconditioner_matrix(problem, ss, pstate, S.dtype)
    return S, M, b_s.to(S.dtype)


def phase_k2(device, solver, mu):
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import pcg_dense
    from graphite_tpu_torch.ops.pcg_loop import run_pcg

    S, M, b = first_schur_system(ladybug_problem(device), solver, mu)
    rng = np.random.default_rng(1)
    n = 1024
    A = rng.standard_normal((n, n))
    S2 = A @ A.T + n * np.eye(n)
    M2 = np.zeros_like(S2)
    for i in range(0, n, 9):
        M2[i:i + 9, i:i + 9] = np.linalg.inv(S2[i:i + 9, i:i + 9])
    spd = [torch.as_tensor(a.astype(np.float32), device=device)
           for a in (S2, M2, rng.standard_normal(n))]
    kw = dict(max_iter=solver.max_iter, tol=solver.tol,
              rejection_ratio=solver.rejection_ratio)
    result = None
    for label, (Sx, Mx, bx), was in (
            ("ladybug first Schur system", (S, M, b), WAS_MS["k2 ladybug"]),
            ("random SPD", spd, None)):
        x, k = pcg_dense.dense_pcg(Sx, Mx, bx, **kw)
        again, k2 = pcg_dense.dense_pcg(Sx, Mx, bx, **kw)
        x_ref, k_ref = pcg_dense.dense_pcg_plain(Sx, Mx, bx, **kw)
        x_cpu, k_cpu = pcg_dense.dense_pcg_plain(Sx.cpu(), Mx.cpu(),
                                                 bx.cpu(), **kw)
        torch.cuda.synchronize()
        err = rel_err(x, x_ref)
        abs_err = float((x - x_ref).abs().max())
        k, k2, k_ref, k_cpu = int(k), int(k2), int(k_ref), int(k_cpu)
        ms = device_ms(lambda: pcg_dense.dense_pcg(Sx, Mx, bx, **kw))
        plain_ms = device_ms(lambda: pcg_dense.dense_pcg_plain(Sx, Mx, bx,
                                                               **kw), reps=3)
        # for scale: the same loop with library matvecs and dots
        matmul_ms = device_ms(lambda: run_pcg(
            bx, lambda p: p @ Sx, lambda y: y @ Mx, solver.max_iter,
            solver.tol, solver.rejection_ratio))
        n = bx.shape[0]
        label = f"{label}, cluster of {pcg_dense.cluster_size(n)} CTAs"
        print(f"[k2] n={n} {label}: rel_err={err:.3e} "
              f"max_abs_err={abs_err:.3e} iterations={k} plain_iterations="
              f"{k_ref} cpu_iterations={k_cpu} bitwise_repeat="
              f"{torch.equal(x, again)} bitwise_vs_plain="
              f"{torch.equal(x, x_ref)} bitwise_vs_cpu_plain="
              f"{torch.equal(x.cpu(), x_cpu)} ms={ms:.4f} "
              + ("" if was is None else f"was_ms={was} ")
              + f"plain_ms={plain_ms:.4f} matmul_run_pcg_ms={matmul_ms:.4f}")
        check(torch.equal(x, again) and k == k2,
              f"K2 not bitwise repeatable ({label})")
        check(k == k_ref == k_cpu,
              f"K2 took {k} steps, plain {k_ref}, CPU {k_cpu} ({label})")
        check(torch.equal(x, x_ref), f"K2 differs from its plain version "
              f"on the card by {abs_err} ({label})")
        check(torch.equal(x.cpu(), x_cpu),
              f"K2 differs from its plain version on the CPU ({label})")
        if result is None:  # the main path's system
            # per CG step two (n, n) matvecs, three dots, a norm's
            # division and three vector updates; the start costs one
            # matvec and two dots
            ops = (k + 1) * (2 * n * n + 2 * 2 * n + n) + k * (
                2 * n * n + 2 * n + 6 * n)
            result = dict(err=abs_err, ms=ms, plain_ms=plain_ms,
                          shape=f"n={n}, {k} CG steps", library_ms=None,
                          **bound(nbytes(Sx, Mx, bx, x), ops))
    return {"pcg_dense.dense_pcg": [result]}


def run_lm(problem, solver, iterations, params=None):
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )

    return levenberg_marquardt(
        problem, solver, params,
        options=LevenbergMarquardtOptions(iterations=iterations))


def all_stats():
    """The launch counts of every kernel entry point."""
    from graphite_tpu_torch.ops.cuda import (
        allreduce,
        bal,
        dot,
        pcg_dense,
        pcg_mf,
        pcg_step,
        pose,
        schur_w,
        segmv,
        segsum,
        segsum_stream,
    )

    return [segsum.STATS, segsum_stream.STATS, segsum.STATS_F64,
            segsum_stream.STATS_F64, pcg_dense.STATS,
            segsum_stream.PRODUCT_STATS, segsum_stream.PRODUCT_RTBL_STATS,
            segsum_stream.MATVEC_TBL_STATS, segmv.STREAM_STATS,
            segmv.WTBL_STATS, segmv.SYM_STATS, pcg_mf.STATS,
            allreduce.STATS, allreduce.GATHER_STATS, bal.RESIDUAL_STATS,
            bal.LINEARIZE_STATS, bal.SCALE_B_STATS, bal.HESSIAN_SUM_STATS,
            dot.STATS, dot.STATS_F64, schur_w.STATS, pose.RESIDUAL_STATS,
            pose.LINEARIZE_STATS, pose.SCALE_B_STATS, pose.UPDATE_STATS,
            pcg_step.BJS_STATS, pcg_step.ADVANCE_STATS,
            pcg_step.COMMIT_STATS, pcg_step.BJS_STATS_F64,
            pcg_step.ADVANCE_STATS_F64, pcg_step.COMMIT_STATS_F64,
            schur_w.HLL_SOLVE_STATS, schur_w.HLL_SOLVE_STATS_F64,
            segsum_stream.PRODUCT_STATS_F64,
            segsum_stream.PRODUCT_RTBL_STATS_F64,
            segsum_stream.MATVEC_TBL_STATS_F64, segmv.STREAM_STATS_F64,
            segmv.WTBL_STATS_F64, segmv.SYM_STATS_F64, schur_w.STATS_F64,
            bal.RESIDUAL_STATS_F64, bal.LINEARIZE_STATS_F64,
            bal.SCALE_B_STATS_F64, bal.HESSIAN_SUM_STATS_F64,
            pcg_mf.STATS_F64, pose.RESIDUAL_STATS_F64,
            pose.LINEARIZE_STATS_F64, pose.SCALE_B_STATS_F64,
            pose.UPDATE_STATS_F64]


# K7's entry points (csrc/bal.cu), and their float64 graph's instances
K7_ENTRIES = ("bal.bal_residual", "bal.bal_linearize", "bal.bal_scale_b",
              "bal.bal_hessian_sum")
K7_ENTRIES_F64 = tuple(e + "[f64]" for e in K7_ENTRIES)


def check_k7(tag, launches, entries=K7_ENTRIES):
    """Print K7's launches in ``launches`` (the float64 instances' too)
    and check that each of ``entries`` launched."""
    print(f"[{tag}] K7 launches "
          f"{ {e: launches.get(e, 0) for e in K7_ENTRIES + K7_ENTRIES_F64} }")
    for e in entries:
        check(launches.get(e, 0) > 0, f"{tag}: K7's {e} never launched")


K10 = "schur_w.schur_w"  # K10's entry point (csrc/schur_w.cu)
K3_GATHERED = "segsum_stream.streaming_segment_product_sum"
K3_RTBL = "segsum_stream.streaming_segment_product_sum_rtbl"
# the Schur stage's entries that open above the size gates (K3 by index,
# K4's b_S and back-substitution, K5), each with a float64 instance
SCHUR_KERNELS = (K3_RTBL, "segmv.block_matvec_wtbl",
                 "segsum_stream.streaming_matvec_tbl",
                 "segmv.matvec_sym_stream")


def inv_f64(policy):
    """Whether a policy's Hessian and Schur values (its ``inv_dtype``) are
    float64: FP64_FP64 and FP64_BF16."""
    return policy in ("FP64_FP64", "FP64_BF16")


def schur_kernels(policy):
    """{entry: launched} of ``SCHUR_KERNELS`` on a path whose Schur sites
    are above their size gates: each in the dtype of the policy's values
    (``[f64]`` entries under FP64_FP64 and FP64_BF16) and never in the
    other."""
    f64 = inv_f64(policy)
    return {**{n + "[f64]": f64 for n in SCHUR_KERNELS},
            **{n: not f64 for n in SCHUR_KERNELS}}


def k3_calls(launches):
    """K3's launches in ``launches``, gathered-stream and by index: one
    per ``schur_values`` call on the Venice and sharded paths."""
    return launches.get(K3_GATHERED, 0) + launches.get(K3_RTBL, 0)


def check_k10(tag, launches, calls):
    """Print K10's launches in ``launches`` and check one per
    ``schur_values`` call, ``calls`` of them (the BAL paths have one Hpl
    group)."""
    n = launches.get(K10, 0)
    print(f"[{tag}] K10 launches {n} ({calls} schur_values calls)")
    check(calls > 0 and n == calls,
          f"{tag}: K10 launched {n} times in {calls} schur_values calls")


# K12's entry points (csrc/pcg_step.cu) and K13's (csrc/schur_w.cu)
K12_BJS, K12_ADVANCE, K12_COMMIT = ("pcg_step.bjs_apply",
                                    "pcg_step.cg_advance",
                                    "pcg_step.cg_commit")
K13 = "schur_w.hll_solve"


def check_k12(tag, launches, solves, steps=None):
    """Print K12's and K13's launches in ``launches`` and check them
    against ``solves`` PCG-Schur solves (and ``steps`` CG steps, where
    known): the advance and the commit once per step, ``bjs_apply`` once
    more per solve (its set-up), K13 twice per solve (b_S and the
    back-substitution: the BAL paths have one landmark type)."""
    adv, com, bjs = (launches.get(e, 0)
                     for e in (K12_ADVANCE, K12_COMMIT, K12_BJS))
    k13 = launches.get(K13, 0)
    print(f"[{tag}] K12 launches bjs_apply={bjs} cg_advance={adv} "
          f"cg_commit={com} ({solves} solves, "
          f"{'?' if steps is None else steps} CG steps); K13 launches "
          f"{k13}")
    check(solves > 0 and adv == com and bjs == adv + solves,
          f"{tag}: K12 launched {bjs} / {adv} / {com} times in {solves} "
          f"solves")
    check(steps is None or adv == steps,
          f"{tag}: K12's advance launched {adv} times in {steps} CG steps")
    check(k13 == 2 * solves,
          f"{tag}: K13 launched {k13} times in {solves} solves")


@contextlib.contextmanager
def counted_matvecs():
    """Count ``SchurOps.s_matvec`` calls (one per CG step) while open:
    yields a one-entry list."""
    from graphite_tpu_torch.schur import SchurOps

    count = [0]
    real = SchurOps.s_matvec

    def counted(self, x):
        count[0] += 1
        return real(self, x)

    SchurOps.s_matvec = counted
    try:
        yield count
    finally:
        SchurOps.s_matvec = real


def count_launches(run, record_events=True):
    """``run()`` with every launch count set to 0 just before it and read
    just after: (its result, launches and total kernel ms by entry)."""
    import torch

    stats = all_stats()
    for s in stats:
        s.reset()
        s.record_events = record_events
    try:
        out = run()
        torch.cuda.synchronize()
        launches = {s.name: s.launches for s in stats}
        kernel_ms = {s.name: s.total_ms() for s in stats}
    finally:
        for s in stats:
            s.record_events = False
            s.events.clear()
    return out, launches, kernel_ms


def compare_runs(tag, gpu, cpu, rtol=1e-3):
    """CUDA vs CPU LM trajectories over the CPU run's iterations: equal
    accept patterns, chi2 within ``rtol`` per iteration; returns whether
    they are bitwise equal."""
    n = len(cpu.history)
    acc_gpu = [h["accepted"] for h in gpu.history[:n]]
    acc_cpu = [h["accepted"] for h in cpu.history]
    chi_gpu = [h["chi2"] for h in gpu.history[:n]]
    chi_cpu = [h["chi2"] for h in cpu.history]
    print(f"[{tag}] cuda initial_chi2={gpu.initial_chi2!r} chi2={chi_gpu}")
    print(f"[{tag}] cuda accepted={acc_gpu}")
    print(f"[{tag}] cpu initial_chi2={cpu.initial_chi2!r} chi2={chi_cpu}")
    print(f"[{tag}] cpu accepted={acc_cpu}")
    rel = [abs(a - b) / abs(b) for a, b in zip(chi_gpu, chi_cpu)]
    print(f"[{tag}] max per-iteration chi2 rel diff={max(rel):.3e} "
          f"bitwise_equal_trajectory="
          f"{chi_gpu == chi_cpu and gpu.initial_chi2 == cpu.initial_chi2}")
    check(len(gpu.history) >= n, f"{tag}: iteration counts differ")
    check(acc_gpu == acc_cpu, f"{tag}: accept patterns differ")
    check(max(rel) <= rtol, f"{tag}: chi2 differs by {max(rel)} > {rtol}")
    check(abs(gpu.initial_chi2 - cpu.initial_chi2)
          <= rtol * abs(cpu.initial_chi2), f"{tag}: initial chi2 differs")
    return chi_gpu == chi_cpu and gpu.initial_chi2 == cpu.initial_chi2


def check_solution(tag, problem, result):
    import torch

    check(result.chi2 < result.initial_chi2,
          f"{tag}: final chi2 not below initial")
    for name, p in result.params.items():
        check(p.shape == problem.params0[name].shape
              and bool(torch.isfinite(p).all()),
              f"{tag}: bad parameters {name}")


def print_launches(tag, launches, kernel_ms):
    for name in launches:
        if launches[name]:
            print(f"[{tag}] kernel {name}: launches={launches[name]} "
                  f"total_ms={kernel_ms[name]:.4f}")


def phase_slice(solver, iterations):
    problem = ladybug_problem(DEVICE)
    gpu, launches, kernel_ms = count_launches(
        lambda: run_lm(problem, solver, iterations))
    t1 = time.perf_counter()
    cpu = run_lm(ladybug_problem("cpu"), solver, iterations)
    print(f"[slice] cpu run {time.perf_counter() - t1:.1f} s")
    compare_runs("slice", gpu, cpu)
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("slice", problem, gpu)

    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    host_ms = [1e3 * h["time"] for h in gpu.history[1:]]
    print(f"[slice] ms per LM iteration (median of iterations 1..): "
          f"device={statistics.median(dev_ms):.3f} "
          f"host={statistics.median(host_ms):.3f} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    print_launches("slice", launches, kernel_ms)
    check_k7("slice", launches)
    check(launches["bal.bal_residual"] == len(gpu.history),
          "K7's trial chi2 must launch once per LM iteration")
    for name in ("segsum.sorted_segment_sum",
                 "segsum_stream.streaming_segment_sum",
                 "pcg_dense.dense_pcg"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(launches["pcg_dense.dense_pcg"] == len(gpu.history),
          "dense_pcg must launch once per solve")
    check_k10("slice", launches, len(gpu.history))  # one solve an iteration
    return launches


POSES = 2500  # sphere2500's pose count


def pose_problem(device, kind="se3", policy="FP32_FP32", pad_factors_to=1):
    """The SE3 sphere2500 graph (``make_sphere_se3(2500, seed=0)``) or the
    2500-pose SE2 circle, under the policy named ``policy`` (FP32_FP32 by
    default), the first pose fixed, its factors padded to a multiple of
    ``pad_factors_to``."""
    import torch

    import graphite_tpu_torch as gtt
    from graphite_tpu_torch.io import g2o, synthetic

    ds = (synthetic.make_sphere_se3(POSES, seed=0) if kind == "se3"
          else synthetic.make_pose_graph_2d(POSES, seed=0))
    g, *_ = g2o.build_graph(ds, precision=getattr(gtt, policy))
    return g.freeze(device=torch.device(device),
                    pad_factors_to=pad_factors_to)


def pose_solver(precond="bj"):
    """The pose path's solver: PCGSolver(50, 1e-10, 1e6) with block-Jacobi
    (or identity) preconditioning."""
    from graphite_tpu_torch.preconditioners import (
        BlockJacobiPreconditioner,
        IdentityPreconditioner,
    )
    from graphite_tpu_torch.solvers import PCGSolver

    return PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()
                     if precond == "bj" else IdentityPreconditioner())


def first_k6_inputs(problem, solver, mu):
    """The arguments the first LM solve (damping ``mu``) hands K6's
    wrapper, taken from the solver's own call."""
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.solvers import pcg as pcg_solver

    seen = []
    real = pcg_solver.solve_pcg_mf

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    pcg_solver.solve_pcg_mf = capture
    try:
        lin = linearize(problem, problem.params0)
        solver.solve(problem, lin, solver.prepare(problem, lin), mu, False)
    finally:
        pcg_solver.solve_pcg_mf = real
    check(len(seen) == 1, "the pose solve did not take the K6 branch")
    return seen[0]


def k6_bound(site, jf, b, damp, minv, steps):
    """K6 reads J', the slot rows, the row CSR (offsets, each incidence's
    J' offset and residual dims), b, damp and the inverse blocks once and
    writes x once. Per CG step: J' p and J'^T v (a
    multiply-add per J' entry and incidence), damp * p, three dots, the
    norm's division, the block preconditioner and three vector updates;
    the start preconditions once and takes two dots. The float64 instance
    does them at the float64 rate."""
    import torch

    N = site.n * site.d
    moved = nbytes(jf, site.rows, site.desc, site.csr_off, site.inc_j,
                   site.inc_e, b, damp, minv) + b.element_size() * N
    jp = sum(2 * blk.F * blk.arity * blk.E * site.d for blk in site.blocks)
    jtv = 2 * site.d * int(site.inc_e.sum()) + 3 * N
    pre = N + (2 * site.d * N if minv is not None else 0)
    step = jp + jtv + 3 * 2 * N + pre + 6 * N
    return bound(moved, steps * step + pre + 2 * 2 * N,
                 FP64_VECTOR_OPS_PER_S if b.dtype == torch.float64
                 else FP32_OPS_PER_S)


# K6's cases: (kind, preconditioner, policy); the float64 instance on
# sphere2500's first FP64_FP64 solve (float64 J') and FP64_FP32 solve
# (float32 J' and inverse blocks)
K6_CASES = (("se3", "bj", "FP32_FP32"), ("se3", "identity", "FP32_FP32"),
            ("se2", "bj", "FP32_FP32"), ("se3", "bj", "FP64_FP64"),
            ("se3", "identity", "FP64_FP64"), ("se3", "bj", "FP64_FP32"),
            ("se3", "identity", "FP64_FP32"))


def phase_k6():
    """K6 vs its plain version on the first LM solve of sphere2500 (SE3,
    block-Jacobi and identity) and of the 2500-pose SE2 circle; its
    float64 instance on sphere2500's first FP64_FP64 and FP64_FP32
    solves. Beside each time: the device-only ms (20 solves replayed from
    a CUDA graph), the bound and the sync floor (the solve's cluster
    barriers and exchanges at ``kernel_sweep``'s measured cost each)."""
    import torch

    from graphite_tpu_torch.kernel_sweep import (
        graph_ms,
        sync_costs,
        sync_floor_ms,
    )
    from graphite_tpu_torch.ops.cuda import pcg_mf

    costs = sync_costs(torch.device(DEVICE))
    records, problems = {}, {}
    for kind, precond, policy in K6_CASES:
        if (kind, policy) not in problems:
            problems.clear()
            problems[kind, policy] = pose_problem(DEVICE, kind, policy)
        (site, jf, b, damp, minv), kw = first_k6_inputs(
            problems[kind, policy], pose_solver(precond), 1e-4)
        args = (site, jf, b, damp, minv)
        f64 = b.dtype == torch.float64
        x, k = pcg_mf.solve_pcg_mf(*args, **kw)
        again, k2 = pcg_mf.solve_pcg_mf(*args, **kw)
        ref, k_ref = pcg_mf.solve_pcg_mf_plain(*args, **kw)
        x_cpu, k_cpu = pcg_mf.solve_pcg_mf_plain(
            on_cpu(site), jf.cpu(), b.cpu(), damp.cpu(),
            None if minv is None else minv.cpu(), **kw)
        torch.cuda.synchronize()
        k, k2, k_ref, k_cpu = int(k), int(k2), int(k_ref), int(k_cpu)
        err = rel_err(x, ref)
        abs_err = float((x - ref).abs().max())
        cpu_err = rel_err(x.cpu(), x_cpu)
        ms = device_ms(lambda: pcg_mf.solve_pcg_mf(*args, **kw))
        only_ms = graph_ms(lambda: pcg_mf.solve_pcg_mf(*args, **kw))
        plain_ms = device_ms(lambda: pcg_mf.solve_pcg_mf_plain(*args, **kw),
                             reps=3)
        work = k6_bound(site, jf, b, damp, minv, k)
        rule = pcg_mf.cluster_size(site.n * site.d)
        design64 = f64 and pcg_mf.takes_design64(site)
        inst = pcg_mf.instance(f64, jf.dtype,
                               None if minv is None else minv.dtype,
                               design64, site.d)
        # per solve: the set-up and r.z barriers, one r.z barrier a step
        # and the last; the first r.r exchange, then p.Hp and r.r each step
        floor = sync_floor_ms(costs, inst["threads"], rule, k + 3,
                              2 * k + 1)
        label = (f"{kind} {policy} n={site.n} d={site.d} "
                 f"F={[blk.F for blk in site.blocks]} {precond}, J' "
                 f"{str(jf.dtype)[6:]}, inverses "
                 f"{'none' if minv is None else str(minv.dtype)[6:]}, {k} "
                 f"CG steps, cluster of {rule} CTAs, the "
                 f"{'float64' if design64 else 'float32'} design (instance "
                 f"{inst})")
        was = WAS_MS[f"k6 {kind} {precond}" + (f" {policy}" if f64 else "")]
        print(f"[k6] {label}: rel_err={err:.3e} max_abs_err={abs_err:.3e} "
              f"iterations={k} plain_iterations={k_ref} cpu_iterations="
              f"{k_cpu} bitwise_repeat={torch.equal(x, again)} "
              f"bitwise_vs_plain={torch.equal(x, ref)} "
              f"bitwise_vs_cpu_plain={torch.equal(x.cpu(), x_cpu)} "
              f"rel_err_vs_cpu_plain={cpu_err:.3e} "
              f"ms={ms:.4f} device_only_ms={only_ms:.4f} was_ms={was} "
              f"plain_ms={plain_ms:.4f} sync_floor_ms={floor:.4f} "
              f"bound={bound_fields(work)} ({card_label()})")
        check(torch.equal(x, again) and k == k2,
              f"K6 not bitwise repeatable ({label})")
        check(k == k_ref == k_cpu > 0,
              f"K6 took {k} steps, plain {k_ref}, CPU {k_cpu} ({label})")
        check(torch.equal(x, ref), f"K6 differs from its plain version on "
              f"the card by {abs_err} ({label})")
        # float64: PyTorch's CPU float64 sqrt is an ulp off on some inputs
        # (its CUDA sqrt and the kernel's are IEEE), so the CPU's plain
        # version is held within 1e-12, not bitwise
        check(cpu_err <= 1e-12 if f64 else torch.equal(x.cpu(), x_cpu),
              f"K6 differs from its plain version on the CPU by {cpu_err} "
              f"({label})")
        name = "pcg_mf.solve_pcg_mf" + ("[f64]" if f64 else "")
        records.setdefault(name, []).append(dict(
            err=abs_err, ms=ms, plain_ms=plain_ms, shape=label,
            library_ms=None, **work))
    return records


def phase_cond(pose):
    """Conditional regions (``device_loop.cond``: a conditional graph node
    per region, ``csrc/cond.cu``) against their plain version, ``if
    pred: body()``: an outer region and an inner one holding K1 (Ladybug's
    31,843x9 sorted site, seeded), K2 (n = 441, a cluster launch) and K6
    (sphere2500's first solve, a cluster launch), replayed under each pair
    of predicates: bitwise the eager launches where both are true,
    untouched otherwise, each region's run count read back; then a replay
    whose outer region is skipped against one that runs it; then a loop
    (``device_loop.while_loop``) of 1,500 passes, each launching K1,
    against the same 1,500 adds run eagerly."""
    import numpy as np
    import torch

    from graphite_tpu_torch.ops import device_loop
    from graphite_tpu_torch.ops.cuda import pcg_dense, pcg_mf, segsum

    dev = torch.device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=driver_version",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"[cond] torch={torch.__version__} cuda={torch.version.cuda} "
          f"driver={smi.stdout.strip()} conditional nodes: "
          f"graphite_tpu_torch/csrc/cond.cu (torch.cuda.CUDAGraph has "
          f"begin_capture_to_if_node: "
          f"{hasattr(torch.cuda.CUDAGraph, 'begin_capture_to_if_node')})")
    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(0, 7_777, 31_843))
    vals = torch.as_tensor(rng.standard_normal((31_843, 9)).astype(
        np.float32), device=dev)
    plan = segsum.plan_segments(seg, 7_777, dev, width=9)
    n = 441
    a = rng.standard_normal((n, n))
    s_mat = a @ a.T + n * np.eye(n)
    m_mat = np.zeros_like(s_mat)
    for i in range(0, n, 9):
        m_mat[i:i + 9, i:i + 9] = np.linalg.inv(s_mat[i:i + 9, i:i + 9])
    k2_args = [torch.as_tensor(x.astype(np.float32), device=dev)
               for x in (s_mat, m_mat, rng.standard_normal(n))]
    k6_args, k6_kw = first_k6_inputs(pose, pose_solver("bj"), 1e-4)

    def launch():
        return (segsum.sorted_segment_sum(vals, plan),
                pcg_dense.dense_pcg(*k2_args, max_iter=10, tol=1.0,
                                    rejection_ratio=5.0)[0],
                pcg_mf.solve_pcg_mf(*k6_args, **k6_kw)[0])

    refs = launch()
    outs = [torch.zeros_like(r) for r in refs]
    p_out = torch.ones((), dtype=torch.bool, device=dev)
    p_in = torch.ones((), dtype=torch.bool, device=dev)

    def inner():
        for o, r in zip(outs, launch()):
            o.copy_(r)

    cap = device_loop.Capture(dev)
    cap.record(lambda: device_loop.cond(p_out, lambda: device_loop.cond(
        p_in, inner, "kernels"), "outer"), 2)
    for a_val, b_val in ((True, True), (True, False), (False, True)):
        p_out.fill_(a_val)
        p_in.fill_(b_val)
        for o in outs:
            o.zero_()
        before = cap.region_runs()
        cap.replay()
        torch.cuda.synchronize()
        after = cap.region_runs()
        ran = a_val and b_val
        same = [torch.equal(o, r) if ran else bool((o == 0).all())
                for o, r in zip(outs, refs)]
        runs = {k: after[k] - before.get(k, 0) for k in after}
        print(f"[cond] outer={a_val} inner={b_val}: K1, K2, K6 "
              f"{'bitwise their eager launches' if ran else 'untouched'}="
              f"{same} region runs={runs}")
        check(all(same), f"cond: a region's outputs are wrong at "
              f"outer={a_val} inner={b_val}")
        check(runs == {"outer": int(a_val), "kernels": int(ran)},
              f"cond: region runs {runs} at outer={a_val} inner={b_val}")
    p_in.fill_(True)
    p_out.fill_(True)
    taken = device_ms(cap.replay)
    p_out.fill_(False)
    skipped = device_ms(cap.replay)
    print(f"[cond] replay ms: regions run {taken:.4f}, outer region skipped "
          f"{skipped:.4f} ({card_label()})")
    check(skipped < 0.1 * taken, "cond: a skipped region is not cheap")

    # a loop, past any count of unrolled regions
    acc = torch.zeros_like(refs[0])
    k = torch.zeros((), dtype=torch.int64, device=dev)
    limit = torch.full((), 1500, dtype=torch.int64, device=dev)

    def body():
        acc.add_(segsum.sorted_segment_sum(vals, plan))
        k.add_(1)

    loop = device_loop.Capture(dev)
    loop.record(lambda: device_loop.while_loop(lambda: k < limit, body,
                                               "count"), 1)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    loop.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    passes = int(k)
    launched = loop.launches(1)["segsum.sorted_segment_sum"]
    ref = torch.zeros_like(acc)
    for _ in range(1500):  # the plain version: the same adds, eagerly
        ref.add_(refs[0])
    again = device_ms(loop.replay)  # k == limit: no pass
    same = torch.equal(acc, ref)
    print(f"[cond] loop: {passes} passes of K1 in one replay ({ms:.4f} ms; "
          f"{again:.4f} with none), K1 launched {launched}, loop runs "
          f"{loop.region_runs()}, the sum bitwise 1,500 eager adds={same}")
    check(passes == 1500 and int(k) == 1500
          and loop.region_runs() == {"count": 1500} and launched == 1500,
          "cond: the loop did not run 1,500 passes")
    check(same, "cond: the loop's sum of K1 differs from the eager adds")

    # gt_cond_set alone: regions whose predicate is false, in one graph
    # (each a gt_cond_set launch and a skipped conditional node), against
    # as many one-element kernels in one graph: the launch latency inside
    # a graph, gt_cond_set's bound
    n_set = 1000
    never = torch.zeros((), dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    sets = device_loop.Capture(dev)
    sets.record(lambda: [device_loop.cond(never, lambda: count.add_(1),
                                          "never") for _ in range(n_set)],
                n_set)
    set_ms = device_ms(sets.replay, 10) / n_set
    tiny = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(tiny):
        for _ in range(n_set):
            count.add_(1)
    latency_ms = device_ms(tiny.replay, 10) / n_set
    print(f"[cond] gt_cond_set alone: {set_ms:.5f} ms a region ({n_set} "
          f"regions skipped in one graph, 10 replays); launch latency "
          f"{latency_ms:.5f} ms a kernel ({n_set} one-element kernels in "
          f"one graph) ({card_label()})")
    check(sets.region_runs() == {"never": 0},
          "cond: a region with a false predicate ran")


def check_quaternions(tag, result):
    import torch

    q = result.params["se3_pose"][:, 3:]
    norm_err = float((q.double().norm(dim=1) - 1.0).abs().max())
    print(f"[{tag}] max | |q| - 1 | = {norm_err:.3e}")
    check(bool(torch.isfinite(q).all()) and norm_err <= 1e-5,
          f"{tag}: quaternions not finite and unit")


def phase_pose(iterations):
    """sphere2500 through LM + PCGSolver on the card and on the CPU."""
    import torch

    from graphite_tpu_torch.solvers import pcg as pcg_solver

    solver = pose_solver()
    problem = pose_problem(DEVICE)
    loops = [0]
    real = pcg_solver.pcg

    def counted(*args, **kwargs):
        loops[0] += 1
        return real(*args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    pcg_solver.pcg = counted
    try:
        gpu, launches, kernel_ms = count_launches(
            lambda: run_lm(problem, solver, iterations))
    finally:
        pcg_solver.pcg = real
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    cpu = run_lm(pose_problem("cpu"), solver, iterations)
    print(f"[sphere2500] cpu run {time.perf_counter() - t1:.1f} s")
    check(compare_runs("sphere2500", gpu, cpu),
          "sphere2500: the card's trajectory is not the CPU's bit for bit")
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("sphere2500", problem, gpu)
    check_quaternions("sphere2500", gpu)
    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    host_ms = [1e3 * h["time"] for h in gpu.history[1:]]
    print(f"[sphere2500] dim_h={problem.dim_h} ms per LM iteration (median "
          f"of iterations 1..): device={statistics.median(dev_ms):.3f} "
          f"host={statistics.median(host_ms):.3f} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    print(f"[sphere2500] peak device memory max_memory_allocated="
          f"{peak / 2**30:.4f} GiB; run_pcg host loops={loops[0]}")
    print_launches("sphere2500", launches, kernel_ms)
    check(launches["pcg_mf.solve_pcg_mf"] == len(gpu.history),
          "K6 must launch once per solve")
    check(loops[0] == 0, "run_pcg ran on the K6 branch")
    check(launches["segsum_stream.streaming_segment_sum"] > 0,
          "K1 never launched on the pose path")
    check_k11_counts("sphere2500", launches, gpu)
    return launches, problem, gpu


def phase_pose_generic(iterations):
    """sphere2500 with the K6 gate closed (``J_BYTES_LIMIT = 0``): run_pcg
    on hessian_matvec, JtPv reducing through K1; CUDA vs CPU."""
    from graphite_tpu_torch.ops.cuda import pcg_mf

    solver = pose_solver()
    gate = pcg_mf.J_BYTES_LIMIT
    pcg_mf.J_BYTES_LIMIT = 0
    try:
        problem = pose_problem(DEVICE)
        gpu, launches, _ = count_launches(
            lambda: run_lm(problem, solver, iterations), record_events=False)
        cpu = run_lm(pose_problem("cpu"), solver, iterations)
    finally:
        pcg_mf.J_BYTES_LIMIT = gate
    check(compare_runs("sphere2500-generic", gpu, cpu),
          "sphere2500-generic: the card's trajectory is not the CPU's bit "
          "for bit")
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("sphere2500-generic", problem, gpu)
    dev_ms = [h["device_ms"] for h in gpu.history[1:]]
    print(f"[sphere2500-generic] ms per LM iteration (median of iterations "
          f"1..): device={statistics.median(dev_ms):.3f}")
    print(f"[sphere2500-generic] launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(launches["pcg_mf.solve_pcg_mf"] == 0, "K6 launched, gate closed")
    check(launches["segsum_stream.streaming_segment_sum"] > 0,
          "K1 never launched on the generic pose branch")
    check_k11_counts("sphere2500-generic", launches, gpu)
    return launches


# ---- host set-up: the native host library against its plain versions ----

SETUP_SECTIONS = ("freeze", "hessian_structure", "schur_structure",
                  "first_pass_with_plans")


@contextlib.contextmanager
def plain_hostops():
    """Every ``hostops`` entry swapped for its plain NumPy version while
    the block runs: the structure builders and the plans then use NumPy
    alone, as the port did before its host library."""
    from graphite_tpu_torch import hostops

    saved = {name: getattr(hostops, name) for name in hostops.PLAIN_VERSIONS}
    try:
        for name, fn in hostops.PLAIN_VERSIONS.items():
            setattr(hostops, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(hostops, name, fn)


def host_label():
    """The host CPU's model name, ``os.cpu_count()``, the CPUs this process
    may use (the host library's thread count) and the host libraries'
    build seconds."""
    import os
    import platform

    from graphite_tpu_torch import native
    from graphite_tpu_torch.native import structure

    lscpu = subprocess.run(["lscpu"], capture_output=True, text=True,
                           timeout=60).stdout
    model = [line.split(":", 1)[1].strip() for line in lscpu.splitlines()
             if line.startswith("Model name:")]
    model = f"{model[0] if model else 'unknown'} ({platform.machine()})"
    builds = {name: round(lib.build_seconds, 3)
              for name, lib in sorted(native._LOADED.items())}
    return (f"cpu={model!r} os.cpu_count()={os.cpu_count()} "
            f"threads={structure.default_threads()} "
            f"host_library_build_seconds={builds}")


def same_tree(tag, a, b, path=""):
    """Raise unless ``a`` and ``b`` hold equal arrays and tensors (values,
    dtype, shape), keys and scalars; returns the arrays compared."""
    import dataclasses

    import numpy as np
    import torch

    where = f"{tag}: {path or '.'}"
    if isinstance(a, torch.Tensor):
        check(isinstance(b, torch.Tensor) and a.dtype == b.dtype
              and a.shape == b.shape and torch.equal(a, b),
              f"{where} tensors differ")
        return 1
    if isinstance(a, np.ndarray):
        check(isinstance(b, np.ndarray) and a.dtype == b.dtype
              and a.shape == b.shape and np.array_equal(a, b),
              f"{where} arrays differ")
        return 1
    if isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b),
              f"{where} keys differ")
        return sum(same_tree(tag, a[k], b[k], f"{path}.{k}") for k in a)
    if isinstance(a, (list, tuple)):
        check(type(a) is type(b) and len(a) == len(b),
              f"{where} lengths differ")
        return sum(same_tree(tag, x, y, f"{path}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b)))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        check(type(a) is type(b), f"{where} types differ")
        return sum(same_tree(tag, getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
                   for f in dataclasses.fields(a))
    check(type(a) is type(b) and a == b, f"{where} {a!r} != {b!r}")
    return 0


def setup_run(graph, size, schur):
    """``setup_profile.timed_setup`` on the card: (problem, the first
    pass's result, seconds by section, the builders' laps)."""
    from graphite_tpu_torch.setup_profile import timed_setup

    problem, out, secs = timed_setup(graph, size, schur, device=DEVICE)
    laps = {name: [(label, round(sec, 4)) for label, sec in v]
            for name, v in problem._cache["setup_laps"].items()}
    return problem, out, secs, laps


def setup_check(tag, graph, size, schur, order):
    """The set-up of ``graph`` with the native host library and with the
    plain versions (``plain_hostops``), in ``order`` ("native" /
    "numpy" runs on the same host and card, e.g. numpy, native, native,
    numpy; "warmup" is a native run left out of the times): every array
    and tensor of each other run's structures, plans and host arrays
    equal to the first native run's. Returns the first native run's
    (problem, pass result) and {section: (native seconds, numpy
    seconds)}, each the mean over its runs."""
    import torch

    runs = {"native": [], "numpy": [], "warmup": []}
    first = None
    for kind in order:
        if kind == "numpy":
            with plain_hostops():
                problem, out, secs, laps = setup_run(graph, size, schur)
        else:
            problem, out, secs, laps = setup_run(graph, size, schur)
        runs[kind].append(secs)
        print(f"[{tag}] {kind} run: seconds "
              f"{ {k: round(v, 4) for k, v in secs.items()} } laps {laps}")
        if first is None and kind != "numpy":
            first = (problem, out)
            continue
        if first is not None:
            ref = first[0]
            n = same_tree(tag, {k: v for k, v in ref._cache.items()
                                if k != "setup_laps"},
                          {k: v for k, v in problem._cache.items()
                           if k != "setup_laps"}, "_cache")
            n += same_tree(tag, (ref.host, ref.block_offsets,
                                 ref.block_dims),
                           (problem.host, problem.block_offsets,
                            problem.block_dims), "host")
            print(f"[{tag}] {kind} run: structures, plans and host arrays "
                  f"equal to the first native run's ({n} arrays)")
        del problem, out
        torch.cuda.empty_cache()
    check(first is not None and runs["numpy"], f"{tag}: no runs to compare")
    table = {}
    for section in SETUP_SECTIONS + ("total",):
        if section not in runs["native"][0]:
            continue
        nat = statistics.mean(r[section] for r in runs["native"])
        num = statistics.mean(r[section] for r in runs["numpy"])
        table[section] = (round(nat, 4), round(num, 4))
        print(f"[{tag}] {section}: numpy {num:.4f} s, native {nat:.4f} s, "
              f"ratio {num / max(nat, 1e-9):.2f}")
    print(f"[{tag}] host {host_label()} card {card_label()}")
    return first[0], first[1], table


def phase_host_setup():
    """Ladybug-49 and sphere2500 set up with the native host library and
    with its plain versions (a native warm-up, then numpy, native,
    native, numpy), every array equal; the set-up runs to the first LM
    iteration's plans."""
    from graphite_tpu_torch.setup_profile import make_graph

    tables = {}
    for size, name in (("ladybug", "ladybug-49"),
                       ("sphere2500", "sphere2500")):
        g, schur = make_graph(size)
        *_, tables[name] = setup_check(
            f"setup-{size}", g, size, schur,
            ("warmup", "numpy", "native", "native", "numpy"))
    return tables


def phase_venice_setup():
    """BAL Venice-1778 frozen on the card, its structures and one pass of
    the solve's stages (which builds every host plan), with the native
    host library, then again with its plain versions: every array
    equal."""
    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, synthetic
    from graphite_tpu_torch.perf import SectionTimer

    timer = SectionTimer("venice")
    ds = synthetic.make_bal(VENICE, seed=0)
    timer.lap("make_bal")
    g, *_ = bal.build_graph(ds, precision=FP32_FP32)
    timer.lap("build_graph")
    problem, (lin, hv, sv, ops), table = setup_check(
        "setup-venice", g, VENICE, True, ("native", "numpy"))
    del g
    ss = problem._cache["schur_structure"]

    sizes = (ds.cameras.shape[0], ds.points.shape[0],
             ds.observations.shape[0])
    print(f"[venice] cameras, points, observations={sizes} "
          f"dim_h={problem.dim_h} dim_p={ss.dim_p} "
          f"s_blocks={ss.s_sizes} "
          f"products={[(g['dims'], g['dst'].shape[0]) for g in ss.products]} "
          f"hpl_blocks={ {k: v.shape[0] for k, v in ss.hpl_pose.items()} }")
    secs = {name: round(sec, 3) for name, sec in timer.laps}
    secs.update({name: nat for name, (nat, _) in table.items()
                 if name != "total"})
    print(f"[venice] host set-up seconds {secs} "
          f"total={sum(secs.values()):.1f}")
    check(sizes == synthetic.BAL_SIZES[VENICE], f"Venice sizes {sizes}")
    check(ss.dim_p == 9 * sizes[0], f"dim_p {ss.dim_p}")
    return ds, problem, lin, hv, sv, ops, table


def measure(tag, label, kernel, plain, cpu_plain, reps, plain_reps, work,
            library=None, was=None, tol=1e-5, instance=None):
    """A kernel vs its plain version on the card (and on the CPU) at one
    shape, ``work`` its ``bound``, ``library`` (or None) the one PyTorch
    call computing the same function, ``was`` (or None) its time before
    its redesign, ``tol`` the relative error allowed against the plain
    version on the card, ``instance`` (or None) what the card reports of
    the kernel instance timed; returns its numbers."""
    import torch

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    out, again, ref = tup(kernel()), tup(kernel()), tup(plain())
    torch.cuda.synchronize()
    err = max(rel_err(o, r) for o, r in zip(out, ref))
    abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
    repeat = all(torch.equal(o, a) for o, a in zip(out, again))
    del again, ref
    cpu_ref = tup(cpu_plain())
    vs_cpu = all(torch.equal(o.cpu(), c) for o, c in zip(out, cpu_ref))
    del out, cpu_ref
    ms = device_ms(kernel, reps)
    plain_ms = device_ms(plain, plain_reps)
    lib_ms = None if library is None else device_ms(library, reps)
    print(f"[{tag}] {label}: rel_err={err:.3e} max_abs_err={abs_err:.3e} "
          f"bitwise_repeat={repeat} bitwise_vs_cpu_plain={vs_cpu} "
          f"ms={ms:.4f} "
          + ("" if was is None else f"was_ms={was} ")
          + f"plain_ms={plain_ms:.4f} library_ms={lib_ms} "
          f"bound_ms={bound_fields(work)}"
          + ("" if instance is None else f" instance={instance}"))
    check(repeat, f"{tag} not bitwise repeatable at {label}")
    check(vs_cpu, f"{tag} differs from the CPU plain version at {label}")
    check(err <= tol, f"{tag} rel err {err} > {tol} at {label}")
    return dict(err=abs_err, ms=ms, plain_ms=plain_ms, shape=label,
                library_ms=lib_ms, **work)


def on_cpu(obj):
    """A copy of a plan or site dataclass with its tensors on the CPU."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).cpu()
        for f in dataclasses.fields(obj)
        if torch.is_tensor(getattr(obj, f.name))})


def k1_sites(problem, path):
    """(label, plan, width) of every K1 reduction a path ran on
    ``problem``, from its cached segment plans: the factor rows of
    ``linearize`` (and of ``JtPv``, which shares their plans), the Hessian
    value groups of the sets K7 does not take and the block-Jacobi
    blocks."""
    from graphite_tpu_torch.hessian import build_hessian_structure
    from graphite_tpu_torch.ops.cuda import bal

    sites = []
    for tag, plan in problem._cache["segment_plans"].items():
        if tag[0] in ("rows", "bj_blocks"):
            _, fname, s = tag
            vt = problem.factor_meta[fname].ftype.vertex_types[s]
            label, d = ((f"linearize rows of {vt.name}", vt.dim)
                        if tag[0] == "rows" else
                        (f"block-Jacobi blocks of {vt.name}", vt.dim ** 2))
            if problem.factor_meta[fname].ftype.arity > 1:
                label += f" slot {s}"
        elif tag[0] in ("hess_d", "hess_t"):
            cm = build_hessian_structure(problem).contribs[tag[1]]
            if bal.gate(problem, cm.fname) is not None:
                continue  # K7 sums this site itself
            key = cm.direct_group if tag[0] == "hess_d" else cm.trans_group
            label, d = f"hessian group {key}", key[0] * key[1]
        else:  # the Schur sites below their gates: not on these paths
            continue
        label += ", permuted" if plan.perm is not None else ""
        sites.append((f"{path} {plan.rows}x{d}->{plan.num_segments} group "
                      f"{plan.group} {label}", plan, d))
    return sites


def phase_k1_sites(problem, path, seed):
    """K1 vs its plain version at every reduction site of ``path`` on
    ``problem`` (seeded values)."""
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import segsum_stream
    from graphite_tpu_torch.ops.cuda.segsum import segment_sum_plain

    rng = np.random.default_rng(seed)
    records = []
    for label, plan, d in k1_sites(problem, path):
        vals = torch.as_tensor(
            rng.standard_normal((plan.rows, d)).astype(np.float32),
            device=problem.device)
        cvals, cplan = vals.cpu(), on_cpu(plan)
        records.append(measure(
            "k1", label,
            lambda: segsum_stream.streaming_segment_sum(vals, plan),
            lambda: segment_sum_plain(vals, plan),
            lambda: segment_sum_plain(cvals, cplan), 10, 3,
            k1_bound(vals, plan),
            k1_library(vals, input_order_ids(plan), plan.num_segments),
            was_ms(plan, d)))
        del vals, cvals, cplan
    check(records, f"no K1 site on the {path} path")
    return {"segsum_stream.streaming_segment_sum": records}


def product_lanes_label(plan):
    """How many segments of a K3 plan take each number of lanes, as
    {lanes: segments}."""
    return "{" + ", ".join(f"{g}: {segs.shape[0]}"
                           for g, _, segs in plan.buckets) + "}"


def phase_venice_kernels(problem, lin, hv, sv, ops):
    """K1, K3, K4 and K5 vs their plain versions at Venice-1778's
    shapes."""
    import numpy as np
    import torch

    from graphite_tpu_torch import schur
    from graphite_tpu_torch.ops.cuda import segmv, segsum_stream
    from graphite_tpu_torch.ops.cuda.segsum import plan_segments
    from graphite_tpu_torch.ops.streamreduce import (
        matvec_plan,
        product_plan,
        take_rows,
    )

    ss = ops.ss
    rng = np.random.default_rng(2)
    # K1: every row reduction of linearize and the Hessian values
    results = phase_k1_sites(problem, "Venice", 3)

    def add(name, r):
        results.setdefault(name, []).append(r)

    def cpu(*ts):
        return [None if t is None else t.cpu() for t in ts]

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=problem.device)

    def spmv(csr, x):
        return lambda: torch.mv(csr, x.reshape(-1))

    # K3: the Schur triple products, W and Hpl read by index, and S = Hpp
    # - their sums written by K3's store, as schur_values calls it
    (pg,) = ss.products
    dpa, dl, dpb = pg["dims"]
    ns = ss.s_sizes[pg["dst_key"]]
    W = schur.landmark_w(problem, ss, hv)[1][pg["left_key"]]
    R = hv[pg["right_key"]]
    plan = product_plan(problem, ("prod_k3", 0), pg["dst"], ns)
    li = problem.index32(("prod_l", 0), pg["left"])
    ri = problem.index32(("prod_r", 0), pg["right"])
    base, bidx = schur.hpp_base(problem, ss, hv, pg["dst_key"])
    cW, cR, cli, cri, cbase, cbidx = cpu(W, R, li, ri, base, bidx)
    cplan = segsum_stream.plan_products(pg["dst"], ns, "cpu")
    label = (f"{plan.rows}x({dpa},{dl},{dpb})->{ns}, segments by lanes "
             f"{product_lanes_label(plan)} schur_values")
    n_hpp = int((bidx >= 0).sum())
    # K3 reads W, Hpl, both index streams, the base index and the Hpp
    # blocks it copies once, writes S once; each product is dpa*dl*dpb
    # multiply-adds
    work = bound(nbytes(W, R, li, ri, plan.segments.offsets_i32, bidx)
                 + 4 * (n_hpp + ns) * dpa * dpb,
                 2 * plan.rows * dpa * dl * dpb)

    def k3_store():
        return segsum_stream.streaming_segment_product_sum_rtbl(
            W, R, plan, dpa, dl, dpb, li, ri, base=base, base_idx=bidx)

    add("segsum_stream.streaming_segment_product_sum_rtbl", measure(
        "k3", label + ", S = Hpp - the sums stored", k3_store,
        lambda: segsum_stream.product_store_plain(
            segsum_stream.segment_product_sum_plain(
                W, R, plan, dpa, dl, dpb, li, ri), base, bidx),
        lambda: segsum_stream.product_store_plain(
            segsum_stream.segment_product_sum_plain(
                cW, cR, cplan, dpa, dl, dpb, cli, cri), cbase, cbidx),
        5, 2, work, was=WAS_MS["schur_values"],
        instance=segsum_stream.product_instance(torch.float32, dpa, dl,
                                                dpb)))
    # K3's float64 instance (the schur_values of FP64_FP64 and FP64_BF16)
    # on the same values in float64: the same plan, the store from the
    # float64 Hpp blocks; its multiply-adds at the float64 rate
    W64, R64, base64 = W.double(), R.double(), base.double()
    cW64, cR64, cbase64 = cW.double(), cR.double(), cbase.double()
    del cW, cR, cbase
    work64 = bound(nbytes(W64, R64, li, ri, plan.segments.offsets_i32, bidx)
                   + 8 * (n_hpp + ns) * dpa * dpb,
                   2 * plan.rows * dpa * dl * dpb, FP64_VECTOR_OPS_PER_S)
    add(K3_RTBL + "[f64]", measure(
        "k3-f64", label + ", S = Hpp - the sums stored, float64",
        lambda: segsum_stream.streaming_segment_product_sum_rtbl(
            W64, R64, plan, dpa, dl, dpb, li, ri, base=base64,
            base_idx=bidx),
        lambda: segsum_stream.product_store_plain(
            segsum_stream.segment_product_sum_plain(
                W64, R64, plan, dpa, dl, dpb, li, ri), base64, bidx),
        lambda: segsum_stream.product_store_plain(
            segsum_stream.segment_product_sum_plain(
                cW64, cR64, cplan, dpa, dl, dpb, cli, cri), cbase64, cbidx),
        5, 2, work64, was=WAS_MS["schur_values float64"], tol=1e-12,
        instance=segsum_stream.product_instance(torch.float64, dpa, dl,
                                                dpb)))
    del W64, R64, base64, cW64, cR64, cbase64, cbidx
    torch.cuda.empty_cache()
    k3_store_bits(k3_store, W, R, plan, (dpa, dl, dpb), li, ri, base, bidx,
                  work)
    # the same products from gathered streams (no path calls this entry):
    # K3 reads both streams once, writes S once
    Wg, Rg = W.index_select(0, li.long()), R.index_select(0, ri.long())
    del W, R
    cWg, cRg = cpu(Wg, Rg)
    work = bound(nbytes(Wg, Rg, plan.segments.offsets_i32)
                 + 4 * ns * dpa * dpb, 2 * plan.rows * dpa * dl * dpb)
    add("segsum_stream.streaming_segment_product_sum", measure(
        "k3", label + ", gathered streams",
        lambda: segsum_stream.streaming_segment_product_sum(
            Wg, Rg, plan, dpa, dl, dpb),
        lambda: segsum_stream.segment_product_sum_plain(
            Wg, Rg, plan, dpa, dl, dpb),
        lambda: segsum_stream.segment_product_sum_plain(
            cWg, cRg, cplan, dpa, dl, dpb), 5, 2, work,
        was=WAS_MS["schur_values, gathered streams"],
        instance=segsum_stream.product_instance(torch.float32, dpa, dl,
                                                dpb)))
    del cWg, cRg, cli, cri
    # no single PyTorch call computes K3's function; its best library
    # route is two calls on the gathered streams: the per-row products
    # (torch.bmm, a (rows, dpa*dpb) buffer), then index_add_ into S
    seg = plan.segments.seg
    two_calls = device_ms(lambda: torch.zeros(
        (ns, dpa * dpb), device=problem.device).index_add_(0, seg, torch.bmm(
            Wg.view(-1, dpa, dl), Rg.view(-1, dpb, dl).transpose(1, 2)).view(
                -1, dpa * dpb)), 3)
    print(f"[k3] {label}: library yardstick, two calls (torch.bmm on the "
          f"gathered streams, then index_add_): ms={two_calls:.4f}")
    del Wg, Rg
    torch.cuda.empty_cache()

    # K4: b_schur, its kernel-6 form, the back-substitution
    key = ss.hpl_keys[0]
    dp, dl = key
    ((pt, lt, sub, prow, lrow),) = ops.hpl_partitions(key)
    A = take_rows(problem, ("bschur", key, pt, lt, "sub"), ops.hpl(key), sub)
    n_pt, n_lt = problem.seg_rows[pt], problem.seg_rows[lt]
    w = ops._hll_solve_rows({lt: problem.rows_view(lin.b, lt)})[lt]
    plan_b = matvec_plan(problem, ("bschur", key, pt, lt), prow, n_pt)
    lid = problem.index32(("bschur", key, pt, lt, "lid"), lrow)
    cplan_b = plan_segments(prow, n_pt, "cpu")
    cA, cw, clid = cpu(A, w, lid)
    label = (f"{A.shape[0]}x({dp},{dl})->{n_pt}, w[{n_lt}] by index, "
             f"group {plan_b.group}, tiles of "
             f"{segmv.k4_tile_blocks(dp, dl)} b_schur")
    rows_k4 = A.shape[0]
    blocks = A.view(rows_k4, dp, dl)

    def k4_work(x, xi, mplan, out_rows, out_dim, a=A):
        """K4 reads the blocks ``a``, x, its index and the plan once,
        writes the sums once (in a's dtype); each block is dp*dl
        multiply-adds, at the float64 rate for float64 blocks."""
        return bound(nbytes(a, x, xi, mplan.offsets_i32, mplan.perm_i32)
                     + a.element_size() * out_rows * out_dim,
                     2 * rows_k4 * dp * dl,
                     FP64_VECTOR_OPS_PER_S if a.dtype == torch.float64
                     else FP32_OPS_PER_S)

    csr = csr_from_blocks(blocks, dev(prow), dev(lrow), n_pt, n_lt)
    add("segmv.block_matvec_wtbl", measure(
        "k4", label,
        lambda: segmv.block_matvec_wtbl(A, w, plan_b, lid, dp, dl),
        lambda: segmv.segmv_plain(A, w, lid, plan_b, dp, dl),
        lambda: segmv.segmv_plain(cA, cw, clid, cplan_b, dp, dl), 10, 3,
        k4_work(w, lid, plan_b, n_pt, dp), spmv(csr, w), WAS_MS["b_schur"]))
    wg = w.index_select(0, lid)
    cwg = wg.cpu()
    csr = csr_from_blocks(blocks, dev(prow),
                          torch.arange(rows_k4, device=problem.device),
                          n_pt, rows_k4)
    add("segmv.block_matvec_stream", measure(
        "k4", label.replace("by index", "gathered") + " (kernel-6 form)",
        lambda: segmv.block_matvec_stream(A, wg, plan_b, dp, dl),
        lambda: segmv.segmv_plain(A, wg, None, plan_b, dp, dl),
        lambda: segmv.segmv_plain(cA, cwg, None, cplan_b, dp, dl), 10, 3,
        k4_work(wg, None, plan_b, n_pt, dp), spmv(csr, wg),
        WAS_MS["b_schur (kernel-6 form)"]))
    x = torch.as_tensor(rng.standard_normal((n_pt, dp)).astype(np.float32),
                        device=problem.device)
    plan_l = matvec_plan(problem, ("lu", key, pt, lt), lrow, n_lt)
    pidx = problem.index32(("lu", key, pt, lt, "pidx"), prow)
    cplan_l = plan_segments(lrow, n_lt, "cpu")
    cx, cpidx = cpu(x, pidx)
    csr = csr_from_blocks(blocks.transpose(1, 2), dev(lrow), dev(prow),
                          n_lt, n_pt)
    add("segsum_stream.streaming_matvec_tbl", measure(
        "k4", f"{A.shape[0]}x({dp},{dl})^T->{n_lt}, x[{n_pt}] by index, "
        f"group {plan_l.group} back-substitution",
        lambda: segsum_stream.streaming_matvec_tbl(A, x, pidx, plan_l, dp,
                                                   dl, transpose=True),
        lambda: segmv.segmv_plain(A, x, pidx, plan_l, dp, dl, True),
        lambda: segmv.segmv_plain(cA, cx, cpidx, cplan_l, dp, dl, True),
        10, 3, k4_work(x, pidx, plan_l, n_lt, dl), spmv(csr, x),
        WAS_MS["back-substitution"]))
    del wg, cwg, csr
    # K4's float64 instance at b_S's and the back-substitution's shapes
    # (tiles of k4_tile_blocks(dp, dl, 8) on a 2-block grid); the library
    # yardstick a float64 cuSPARSE SpMV
    A64, w64, x64 = A.double(), w.double(), x.double()
    cA64, cw64, cx64 = cA.double(), cw.double(), cx.double()
    del A, cA, w, cw, x, cx
    blocks64 = A64.view(rows_k4, dp, dl)
    csr = csr_from_blocks(blocks64, dev(prow), dev(lrow), n_pt, n_lt)
    add("segmv.block_matvec_wtbl[f64]", measure(
        "k4-f64", f"{rows_k4}x({dp},{dl})->{n_pt}, w[{n_lt}] by index, "
        f"group {plan_b.group}, tiles of {segmv.k4_tile_blocks(dp, dl, 8)} "
        f"b_schur, float64",
        lambda: segmv.block_matvec_wtbl(A64, w64, plan_b, lid, dp, dl),
        lambda: segmv.segmv_plain(A64, w64, lid, plan_b, dp, dl),
        lambda: segmv.segmv_plain(cA64, cw64, clid, cplan_b, dp, dl), 10, 3,
        k4_work(w64, lid, plan_b, n_pt, dp, A64), spmv(csr, w64),
        tol=1e-12))
    csr = csr_from_blocks(blocks64.transpose(1, 2), dev(lrow), dev(prow),
                          n_lt, n_pt)
    add("segsum_stream.streaming_matvec_tbl[f64]", measure(
        "k4-f64", f"{rows_k4}x({dp},{dl})^T->{n_lt}, x[{n_pt}] by index, "
        f"group {plan_l.group} back-substitution, float64",
        lambda: segsum_stream.streaming_matvec_tbl(A64, x64, pidx, plan_l,
                                                   dp, dl, transpose=True),
        lambda: segmv.segmv_plain(A64, x64, pidx, plan_l, dp, dl, True),
        lambda: segmv.segmv_plain(cA64, cx64, cpidx, cplan_l, dp, dl, True),
        10, 3, k4_work(x64, pidx, plan_l, n_lt, dl, A64), spmv(csr, x64),
        tol=1e-12))
    del A64, cA64, w64, cw64, x64, cx64, blocks64, blocks, csr

    # K5: the PCG's S matvec
    skey = (dp, dp)
    ((rt, ct, sub, rrow, crow, off),) = ops.s_sites(skey)
    splan, cid, rxi = ops.sym_site(skey, rt, ct)
    S = take_rows(problem, ("smv", skey, rt, ct, "ysub"), sv.s_vals[skey],
                  sub)
    xv = torch.as_tensor(rng.standard_normal(ss.dim_p).astype(np.float32),
                         device=problem.device)
    xc, xr = problem.rows_view(xv, ct), problem.rows_view(xv, rt)
    cplan_s = segmv.plan_matvec_sym(rrow, crow, problem.seg_rows[rt],
                                    problem.seg_rows[ct], "cpu", dp)
    cS, cxc, cxr, ccid, crxi = cpu(S, xc, xr, cid, rxi)
    n_r, n_c = problem.seg_rows[rt], problem.seg_rows[ct]
    # K5 reads S, both x tables, both indices and both plans once, writes
    # both halves once; every block once forward, the off-diagonal ones
    # once transposed
    work = bound(
        nbytes(S, xc, xr, cid, rxi, splan.rows.offsets_i32,
               splan.rows.perm_i32, splan.cols.offsets_i32,
               splan.cols.perm_i32) + 4 * dp * (n_r + n_c),
        2 * dp * dp * (S.shape[0] + off.size))
    # library: one SpMV of the whole symmetric S (both halves summed,
    # which is what s_matvec makes of K5's two outputs)
    check(rt == ct, "K5's site is not on the diagonal of S")
    S3, offt = S.view(-1, dp, dp), dev(off)
    csr = csr_from_blocks(
        torch.cat([S3, S3.index_select(0, offt).transpose(1, 2)]),
        dev(np.concatenate([rrow, crow[off]])),
        dev(np.concatenate([crow, rrow[off]])), n_r, n_c)
    del S3, offt
    check(splan.cols.perm is None, "K5's column plan is not in stored order")
    add("segmv.matvec_sym_stream", measure(
        "k5", f"{S.shape[0]}x({dp},{dp})->{n_r}, "
        f"{off.size} off-diagonal, one read of S, groups "
        f"{splan.rows.group} (rows, K1) / {splan.cols.group} (columns) "
        f"s_matvec",
        lambda: segmv.matvec_sym_stream(S, xc, xr, cid, rxi, splan, dp, dp),
        lambda: segmv.matvec_sym_plain(S, xc, xr, cid, rxi, splan, dp, dp),
        lambda: segmv.matvec_sym_plain(cS, cxc, cxr, ccid, crxi, cplan_s,
                                       dp, dp), 20, 5, work, spmv(csr, xc),
        WAS_MS["s_matvec"]))
    del csr
    # K5's float64 instance on the same S in float64: its column plan's
    # lanes capped so that two tiles fit shared memory (sym_group_cap)
    S64, xc64, xr64 = S.double(), xc.double(), xr.double()
    cS64, cxc64, cxr64 = cS.double(), cxc.double(), cxr.double()
    del S, cS
    splan64, cplan64 = (segmv.plan_matvec_sym(
        rrow, crow, n_r, n_c, d, dp, k=dp, elem_bytes=8)
        for d in (problem.device, "cpu"))
    work64 = bound(
        nbytes(S64, xc64, xr64, cid, rxi, splan64.rows.offsets_i32,
               splan64.rows.perm_i32, splan64.cols.offsets_i32,
               splan64.cols.perm_i32) + 8 * dp * (n_r + n_c),
        2 * dp * dp * (S64.shape[0] + off.size), FP64_VECTOR_OPS_PER_S)
    S3, offt = S64.view(-1, dp, dp), dev(off)
    csr = csr_from_blocks(
        torch.cat([S3, S3.index_select(0, offt).transpose(1, 2)]),
        dev(np.concatenate([rrow, crow[off]])),
        dev(np.concatenate([crow, rrow[off]])), n_r, n_c)
    del S3, offt
    add("segmv.matvec_sym_stream[f64]", measure(
        "k5-f64", f"{S64.shape[0]}x({dp},{dp})->{n_r}, {off.size} "
        f"off-diagonal, one read of S, groups {splan64.rows.group} (rows, "
        f"K1) / {splan64.cols.group} (columns) s_matvec, float64",
        lambda: segmv.matvec_sym_stream(S64, xc64, xr64, cid, rxi, splan64,
                                        dp, dp),
        lambda: segmv.matvec_sym_plain(S64, xc64, xr64, cid, rxi, splan64,
                                       dp, dp),
        lambda: segmv.matvec_sym_plain(cS64, cxc64, cxr64, ccid, crxi,
                                       cplan64, dp, dp), 20, 5, work64,
        spmv(csr, xc64), tol=1e-12))
    del S64, cS64, csr
    torch.cuda.empty_cache()
    return results


def k3_store_bits(k3_store, W, R, plan, dims, li, ri, base, bidx, work):
    """K3's base store at Venice's first ``schur_values`` inputs: bitwise
    its plain version (``product_store_plain``) of K3's own sums on the
    card, in place on S (a later product group's form), and replayed
    from a CUDA graph; one launch a call. Its ms beside K3 storing the
    sums alone (3.4619 when K3 was redesigned) and the ops the store
    replaced (zero S, copy Hpp in, subtract), all in this run."""
    import torch

    from graphite_tpu_torch.ops.cuda import segsum_stream

    def k3_sums():
        return segsum_stream.streaming_segment_product_sum_rtbl(
            W, R, plan, *dims, li, ri)

    def bits(t):
        return t.view(torch.int32)

    stats = segsum_stream.PRODUCT_RTBL_STATS
    before = stats.launches
    out = k3_store()
    launches = stats.launches - before
    sums = k3_sums()
    ref = segsum_stream.product_store_plain(sums, base, bidx)
    s = ref.clone()
    in_place = segsum_stream.streaming_segment_product_sum_rtbl(
        W, R, plan, *dims, li, ri, base=s)
    ref_in_place = segsum_stream.product_store_plain(sums, ref.clone(), None)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = k3_store()
    graph.replay()
    torch.cuda.synchronize()
    ok = dict(vs_plain=torch.equal(bits(out), bits(ref)),
              in_place=(in_place.data_ptr() == s.data_ptr()
                        and torch.equal(bits(in_place), bits(ref_in_place))),
              in_graph=torch.equal(bits(captured), bits(ref)))
    del out, s, in_place, ref_in_place, captured, graph
    rows = torch.nonzero(bidx >= 0).reshape(-1)
    h_rows = bidx.index_select(0, rows).long()

    def replaced():  # schur_values' ops before the store moved into K3
        z = torch.zeros_like(sums)
        z.index_copy_(0, rows, base.index_select(0, h_rows))
        return z - sums

    check(torch.equal(bits(replaced()), bits(ref)),
          "k3: the plain store is not the replaced ops' bits")
    del ref
    torch.cuda.empty_cache()
    ms = device_ms(k3_store, 5)
    sums_ms = device_ms(k3_sums, 5)
    replaced_ms = device_ms(replaced, 5)
    print(f"[k3-store] S = Hpp - sums in K3's store, Venice schur_values: "
          f"bitwise {ok} launches a call={launches} ms={ms:.4f} K3 storing "
          f"the sums alone ms={sums_ms:.4f} (at its redesign: 3.4619) the "
          f"replaced ops (zero S, copy Hpp in, subtract) ms={replaced_ms:.4f} "
          f"bound_ms={bound_fields(work)} ({card_label()})")
    for what, good in ok.items():
        check(good, f"k3: the base store is not bitwise ({what})")
    check(launches == 1, f"k3: the base store launched {launches} times")


# float32 operations per factor of K7's entries, as written in
# csrc/bal.cu (the bound's operation side; the float64 cos / sin apart):
# the residual and loss ~60, the Jacobian ~300 more with the masks and the
# diagonal; the scaling, casts and b 72. The Hessian sum: 5 per distinct
# entry of a factor's product (two products, a sum, the dL product, the
# add into its lane; K7_SUM_OPS), counted per site by need: a symmetric
# site's d (d + 1) / 2 entries (45 of Hpp's 81, 6 of Hll's 9), each
# other site's d_s d_t (k7_sum_entries)
K7_OPS = {"bal.bal_residual": 60, "bal.bal_linearize": 400,
          "bal.bal_scale_b": 72}
K7_SUM_OPS = 5


def k7_sum_entries(s, t):
    d_s, d_t = (9, 3)[s], (9, 3)[t]
    return d_s * (d_s + 1) // 2 if s == t else d_s * d_t


# float64 operations per factor: a sqrt and a cos / sin pair (~40 each in
# CUDA's libdevice) per Rodrigues form, one form in the residual, two in
# linearize (the residual's and the Jacobian's)
K7_F64_OPS = {"bal.bal_residual": 120, "bal.bal_linearize": 240,
              "bal.bal_scale_b": 0}
# each entry's time before its redesign (PERF.md, NVIDIA H100 80GB HBM3,
# 700.00 W): bal_linearize one thread per factor writing its own rows;
# bal_scale_b one thread per output element; the Hessian sums on their
# second design (K1's lane CTA with each round's rows staged, a thread a
# (block, column) at one lane; PERF.md's K7 rows, float32 and float64)
K7_WAS_MS = {"bal.bal_linearize": "1.6638", "bal.bal_scale_b": "0.9924",
             "bal.bal_hessian_sum (9, 9)": "0.6633",
             "bal.bal_hessian_sum (9, 3)": "0.5716",
             "bal.bal_hessian_sum (3, 3)": "0.1171",
             "bal.bal_hessian_sum[f64] (9, 9)": "0.9292",
             "bal.bal_hessian_sum[f64] (9, 3)": "1.0751",
             "bal.bal_hessian_sum[f64] (3, 3)": "0.2357"}


def k7_sum_sites(problem):
    """(label, (s, t), transposed, group key, plan) of every Hessian site of
    Venice's K7 set, on the plans ``compute_hessian_values`` caches."""
    from graphite_tpu_torch.hessian import build_hessian_structure
    from graphite_tpu_torch.ops.streamreduce import segment_plan

    hs = build_hessian_structure(problem)
    sites = []
    for ci, cm in enumerate(hs.contribs):
        for tag, key, idx, tr in (
                (("hess_d", ci), cm.direct_group, cm.direct_idx, False),
                (("hess_t", ci), cm.trans_group, cm.trans_idx, True)):
            if idx is None:
                continue
            plan = segment_plan(problem, tag, idx, hs.group_sizes[key] + 1,
                                key[0] * key[1])
            sites.append((f"{key}", (cm.s, cm.t), tr, key, plan))
    return sites


def phase_k7(problem, lin):
    """K7's entries vs their plain versions at Venice-1778's shapes: the
    first linearization point, its scales and loss; the Hessian sum at
    each of Venice's three sites on its real plan, as the group's first
    writer; bitwise equal on the card and on the CPU, bitwise repeatable.
    Then the float64 instances (``[f64]``, FP64_FP64: float64 storage and
    sums) on the same point cast to float64, each bitwise its plain
    version on the card (the card's float64 cos / sin are CUDA's, not the
    CPU library's: the CPU is held to them by phase 23) and repeatable.
    Then the launches of one eager ``compute_hessian_values``: one K7 sum
    a site, no K1."""
    import torch

    from graphite_tpu_torch import Precision
    from graphite_tpu_torch.hessian import (
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu_torch.ops.cuda import bal

    (name,) = problem.factor_meta
    loss = bal.gate(problem, name)
    check(loss is not None, "k7: Venice does not pass K7's gate")
    fa = problem.data.factors[name]
    F = fa.ids[0].shape[0]

    def inputs(dev, dt=torch.float32):
        """Each entry's arguments on ``dev``, the graph's values in ``dt``
        (float64: FP64_FP64, float64 storage too); the later entries take
        the plain versions' outputs of the earlier ones."""
        def cast(t):
            return t.to(dev, dt) if t.is_floating_point() else t.to(dev)

        p = problem.params0
        a = tuple(cast(t) for t in (p["bal_camera"], p["bal_point"],
                                    *fa.ids, fa.obs))
        fm, sm, lp = (cast(t) for t in (fa.factor_mask, fa.slot_mask,
                                        fa.loss_params))
        sc = tuple(cast(problem.rows_view_padded(lin.scales, v))
                   for v in ("bal_camera", "bal_point"))
        lin_args = (*a, sm, fm, lp, loss)
        r, jc, jp, _, dL, _, _ = bal.bal_linearize_plain(*lin_args)
        storage = (problem.precision.solver_dtype if dt == torch.float32
                   else dt)
        sb_args = (jc, jp, r, dL, *sc, *(t.to(dev) for t in fa.rows),
                   storage)
        js = bal.bal_scale_b_plain(*sb_args)
        return {"bal.bal_residual": (*a, fm, lp, loss),
                "bal.bal_linearize": lin_args, "bal.bal_scale_b": sb_args,
                "sum": (js[0], js[1], dL)}

    def bits(t):
        return t.contiguous().view(
            {8: torch.int64, 4: torch.int32, 2: torch.int16}[
                t.element_size()])

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    def run(entry, label, kernel, plain, cpu_plain, work, was=None):
        """``kernel()`` vs ``plain()`` and ``cpu_plain()`` (None: not
        held to the CPU): bitwise, repeatable, timed; returns its
        record."""
        out, again = tup(kernel()), tup(kernel())
        ref = tup(plain())
        ref_cpu = None if cpu_plain is None else tup(cpu_plain())
        torch.cuda.synchronize()
        vs_plain = all(torch.equal(bits(o), bits(r))
                       for o, r in zip(out, ref))
        repeat = all(torch.equal(bits(o), bits(a))
                     for o, a in zip(out, again))
        vs_cpu = ref_cpu is None or all(
            torch.equal(bits(o.cpu()), bits(c)) for o, c in zip(out, ref_cpu))
        err = max(float((o.double() - r.double()).abs().max())
                  for o, r in zip(out, ref))
        label += " -> " + ", ".join(
            "x".join(map(str, t.shape)) + " " + str(t.dtype)[6:] for t in out)
        held = ref_cpu is not None
        del out, again, ref, ref_cpu
        ms = device_ms(kernel, 10)
        plain_ms = device_ms(plain, 3)
        print(f"[k7] {entry} {label}: bitwise_vs_plain={vs_plain} "
              f"bitwise_repeat={repeat} bitwise_vs_cpu_plain="
              f"{vs_cpu if held else 'not held'} "
              f"max_abs_err={err:.3e} ms={ms:.4f} "
              + ("" if was is None else f"was_ms={was} ")
              + f"plain_ms={plain_ms:.4f} bound_ms={bound_fields(work)} "
              f"({card_label()})")
        check(vs_plain, f"k7: {entry} {label} differs from its plain version")
        check(repeat, f"k7: {entry} {label} not bitwise repeatable")
        check(vs_cpu, f"k7: {entry} {label} differs from the CPU plain "
              "version")
        return dict(err=err, ms=ms, plain_ms=plain_ms, shape=label,
                    library_ms=None, **work)

    # the Hessian sum's instances as ptxas built them: registers, spills
    sums = set()
    for kernel, props in bal.load_kernel().instances():
        found = re.search(r"hsum_\w+<[^>]*>", kernel)
        if found:
            print(f"[k7] ptxas {found.group(0)}: {props}")
            check(all(re.search(rf"(?<!\d)0 bytes spill {kind}", props)
                      for kind in ("stores", "loads")),
                  f"k7: {found.group(0)} spills registers: {props}")
            # kWhole (MODE 0, "(int)0" as cu++filt prints it): the sums'
            if re.search(r", (\(int\))?0>$", found.group(0)):
                sums.add(found.group(0))
    # each (graph, storage) instance at its four sites on both kernels
    want = 8 * sum(len(s) for _, s in bal.GRAPH_INSTANCES.values())
    check(len(sums) == want, f"k7: the build log shows {len(sums)} "
          f"Hessian-sum kernel instances, not {want}: their spills unread")
    fns = {"bal.bal_residual": (bal.bal_residual, bal.bal_residual_plain),
           "bal.bal_linearize": (bal.bal_linearize, bal.bal_linearize_plain),
           "bal.bal_scale_b": (bal.bal_scale_b, bal.bal_scale_b_plain)}
    sites = k7_sum_sites(problem)
    results = {}
    for dt, tag in ((torch.float32, ""), (torch.float64, "[f64]")):
        f64 = dt == torch.float64
        card = inputs(problem.device, dt)
        host = None if f64 else inputs("cpu")
        for entry, (kernel, plain) in fns.items():
            ins = card[entry]
            outs = tup(plain(*ins))
            moved = nbytes(*(t for t in ins if torch.is_tensor(t)), *outs)
            del outs
            if f64:  # every operation in float64
                work = bound(moved, (K7_OPS[entry] + K7_F64_OPS[entry]) * F,
                             FP64_VECTOR_OPS_PER_S)
            else:
                work = bound(moved, K7_OPS[entry] * F)
                work["ops_ms"] += (1e3 * K7_F64_OPS[entry] * F
                                   / FP64_VECTOR_OPS_PER_S)
            results[entry + tag] = [run(
                entry + tag, f"F={F} ({F % 128} factors in the tail CTA)",
                lambda k=kernel, i=ins: k(*i), lambda p=plain, i=ins: p(*i),
                None if f64 else lambda p=plain, i=host[entry]: p(*i), work,
                K7_WAS_MS.get(entry + tag))]

        # the Hessian sum at each site, into a new (empty) group each call
        entry = "bal.bal_hessian_sum"
        jc, jp, dL = card["sum"]
        results[entry + tag] = []
        for label, (s, t), tr, key, plan in sites:
            width = key[0] * key[1]

            def call(fn, ins, p, dev, _s=s, _t=t, _tr=tr, _w=width):
                out = torch.empty((p.num_segments, _w), device=dev,
                                  dtype=Precision(ins[2].dtype,
                                                  ins[0].dtype).inv_dtype)
                return fn(*ins, p, _s, _t, _tr, out, False)

            used = ((jc,) if (s, t) == (0, 0) else (jp,) if s == 1
                    else (jc, jp))
            work = bound(
                nbytes(*used, dL, plan.perm_i32, plan.offsets_i32)
                + dL.element_size() * plan.num_segments * width,
                K7_SUM_OPS * k7_sum_entries(s, t) * plan.rows,
                FP64_VECTOR_OPS_PER_S if f64 else FP32_OPS_PER_S)
            results[entry + tag].append(run(
                entry + tag, f"{key} site, slots {(s, t)}, {plan.rows} rows "
                f"-> {plan.num_segments} blocks, group {plan.group}"
                + (", permuted" if plan.perm is not None else ", sorted")
                + (", transposed" if tr else ""),
                lambda p=plan: call(bal.bal_hessian_sum, card["sum"], p,
                                    problem.device),
                lambda p=plan: call(bal.bal_hessian_sum_plain, card["sum"],
                                    p, problem.device),
                None if f64 else lambda p=on_cpu(plan): call(
                    bal.bal_hessian_sum_plain, host["sum"], p, "cpu"),
                work, K7_WAS_MS.get(f"{entry}{tag} {label}")))
        del card, host
        torch.cuda.empty_cache()

    hs = build_hessian_structure(problem)
    _, launches, _ = count_launches(
        lambda: compute_hessian_values(problem, hs, lin), record_events=False)
    k1 = launches["segsum_stream.streaming_segment_sum"]
    print(f"[k7] one eager compute_hessian_values at Venice: K7 sums "
          f"{launches[entry]} (one a site), K1 {k1} (before the "
          f"fused sums: the row entry 1, K1 3)")
    check(launches[entry] == 3 and k1 == 0,
          "k7: Venice's Hessian values must be three K7 sums and no K1")
    return results


# float32 and float64 operations per factor (per vertex for the update)
# that K11's entries need (the bound's operation side), counted from
# csrc/se3_dual.cuh and csrc/pose.cu for an se3_between factor (a prior
# needs fewer), each value once however many threads compute it. A
# float64 sqrt, sin, cos or atan2 counts ~40 operations (CUDA's libdevice).
# - se3_residual: the residual (~240 float32 operations; sqrt twice,
#   atan2, cos, sin), P r, chi2 and the loss (~90).
# - se3_linearize: the primal once: both retractions at delta = 0 (~126
#   and 6 functions each), the residual, P r and the loss (~580 and 17
#   functions). The forward-mode tangent of each operation once per
#   direction that reaches it: a slot's retraction along its own 6
#   directions (~194 each), the first pose's inverse along the same 6
#   (~60), the rest of the residual along all 12 (~295): ~6,230, and ~180
#   float64 operations for the functions' tangents. P J and the diagonal
#   (~500 a slot) and the masks (72). In all ~7,880 float32 and ~860
#   float64 operations.
# - se3_scale_b: P r, dL P r, the scaled J and b's rows (~280).
# - se3_update: the scaled step, se3_exp, the composition and the
#   normalization (~132 and 6 functions).
K11_OPS = {"pose.se3_residual": 330, "pose.se3_linearize": 7880,
           "pose.se3_scale_b": 280, "pose.se3_update": 132}
K11_F64_OPS = {"pose.se3_residual": 5 * 40,
               "pose.se3_linearize": 17 * 40 + 180,
               "pose.se3_scale_b": 0, "pose.se3_update": 6 * 40}
K11_ENTRIES = tuple(K11_OPS)
K11_ENTRIES_F64 = tuple(e + "[f64]" for e in K11_ENTRIES)


def check_k11(tag, launches, entries=K11_ENTRIES):
    """Print K11's launches in ``launches`` (the float64 instances' too)
    and check that each of ``entries`` launched."""
    counts = {e: launches.get(e, 0) for e in K11_ENTRIES + K11_ENTRIES_F64}
    print(f"[{tag}] K11 launches {counts}")
    for e in entries:
        check(counts[e] > 0, f"{tag}: K11's {e} never launched")


def check_k11_counts(tag, launches, result, entries=K11_ENTRIES):
    """``check_k11``, and K11's launches in a host-loop LM run of one
    factor set: a trial chi2 and an update an iteration, a linearization
    (both passes) at the start and after each accepted step (``entries``:
    the graph dtype's instance)."""
    check_k11(tag, launches, entries)
    n = len(result.history)
    residual, linearize, scale_b, update = (launches[e] for e in entries)
    check(residual == update == n
          and linearize == scale_b == result.accepted_steps + 1,
          f"{tag}: K11 launches {launches} in {n} iterations")


def phase_k11(problem):
    """K11's entries vs their plain versions at sphere2500's shapes (the
    first linearization point of phase 4b's problem, its scales; the
    update by a seeded step): bitwise equal on the card and on the CPU,
    bitwise repeatable, and the same bits replayed from a CUDA graph.
    Then the float64 instances (``[f64]``) the same way on sphere2500
    frozen under FP64_FP64, the CPU's plain version held within 1e-12
    (CUDA's double sin, cos and atan2 are not the CPU's). Timed
    device-only (20 calls replayed from one graph: a call is a few us,
    less than the host's launch work) against the bound, the plain
    version's time (the generic code, the jvp branch for the
    linearization) and its host us a call; no single PyTorch call
    computes any entry (library: none)."""
    results = k11_entries(problem, "")
    problem64 = pose_problem(DEVICE, policy="FP64_FP64")
    results.update(k11_entries(problem64, "[f64]"))
    return results


def k11_entries(problem, suffix):
    """``phase_k11`` on one problem: the entries of its graph dtype's
    instance (``suffix``: "" or "[f64]")."""
    import numpy as np
    import torch

    from graphite_tpu_torch.kernel_sweep import graph_ms, host_us
    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.ops.cuda import pose

    (name,) = problem.factor_meta
    loss = pose.gate(problem, name)
    check(loss is not None, "k11: sphere2500 does not pass K11's gate")
    lin = linearize(problem, problem.params0)
    fa = problem.data.factors[name]
    va = problem.data.vertices["se3_pose"]
    F, V = fa.ids[0].shape[0], va.active.shape[0]
    step = np.random.default_rng(11).standard_normal(problem.dim_x)
    f64 = problem.precision.graph_dtype == torch.float64

    def inputs(dev):
        """Each entry's arguments on ``dev``; the second pass takes the
        plain linearization's outputs."""
        p = problem.params0["se3_pose"].to(dev)
        ids = tuple(t.to(dev) for t in fa.ids)
        obs, prec, fm, sm, lp = (t.to(dev) for t in (
            fa.obs, fa.precision, fa.factor_mask, fa.slot_mask,
            fa.loss_params))
        lin_args = (p, ids, obs, prec, sm, fm, lp, loss)
        r, J, _, dL, _ = pose.se3_linearize_plain(*lin_args)
        sc = tuple(problem.rows_view_padded(lin.scales, "se3_pose").to(dev)
                   for _ in ids)
        dx = torch.as_tensor(step, dtype=problem.precision.graph_dtype,
                             device=dev)
        return {"pose.se3_residual": (p, ids, obs, prec, fm, lp, loss),
                "pose.se3_linearize": lin_args,
                "pose.se3_scale_b": (J, r, dL, prec, sc,
                                     tuple(t.to(dev) for t in fa.rows),
                                     problem.precision.solver_dtype),
                "pose.se3_update": (p, dx, lin.scales.to(dev),
                                    problem.seg_start["se3_pose"],
                                    problem.seg_rows["se3_pose"],
                                    va.active_row.to(dev),
                                    va.active.to(dev))}

    def flat(x):
        """The tensors of ``x``, nested tuples walked in order."""
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, (tuple, list)):
            return [t for y in x for t in flat(y)]
        return []

    def bits(t):
        return t.contiguous().view(
            {8: torch.int64, 4: torch.int32, 2: torch.int16}[
                t.element_size()])

    def same(a, b):
        return all(torch.equal(bits(x), bits(y))
                   for x, y in zip(flat(a), flat(b), strict=True))

    def near(a, b, tol=1e-12):
        """Each array within ``tol`` of its largest entry (and of 1)."""
        return all(float((x.double() - y.double()).abs().max())
                   <= tol * max(float(y.double().abs().max()), 1.0)
                   for x, y in zip(flat(a), flat(b), strict=True))

    card, host = inputs(problem.device), inputs("cpu")
    fns = {"pose.se3_residual": (pose.se3_residual, pose.se3_residual_plain),
           "pose.se3_linearize": (pose.se3_linearize,
                                  pose.se3_linearize_plain),
           "pose.se3_scale_b": (pose.se3_scale_b, pose.se3_scale_b_plain),
           "pose.se3_update": (pose.se3_update, pose.se3_update_plain)}
    results = {}
    for entry, (kernel, plain) in fns.items():
        ins, cins = card[entry], host[entry]
        stats = next(s for s in all_stats() if s.name == entry + suffix)
        before = stats.launches
        out, again = kernel(*ins), kernel(*ins)
        launches = stats.launches - before
        ref, ref_cpu = plain(*ins), plain(*cins)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kernel(*ins)
        graph.replay()
        torch.cuda.synchronize()
        out_cpu = [t.cpu() for t in flat(out)]
        ok = dict(vs_plain=same(out, ref), repeat=same(out, again),
                  vs_cpu_plain=(near(out_cpu, ref_cpu) if f64
                                else same(out_cpu, ref_cpu)),
                  in_graph=same(captured, ref))
        err = max(float((o.double() - r.double()).abs().max())
                  for o, r in zip(flat(out), flat(ref)))
        n = V if entry == "pose.se3_update" else F
        moved = nbytes(*flat(ins), *flat(out))
        if f64:  # every operation at the float64 rate
            work = bound(moved, (K11_OPS[entry] + K11_F64_OPS[entry]) * n,
                         FP64_VECTOR_OPS_PER_S)
        else:
            work = bound(moved, K11_OPS[entry] * n)
            work["ops_ms"] += (1e3 * K11_F64_OPS[entry] * n
                               / FP64_VECTOR_OPS_PER_S)
        label = (f"F={F} se3_between" if n == F else f"V={V} se3_pose") + \
            " -> " + ", ".join("x".join(map(str, t.shape)) + " "
                               + str(t.dtype)[6:] for t in flat(out))
        del out, again, ref, ref_cpu, graph, captured, out_cpu
        ms = graph_ms(lambda k=kernel, i=ins: k(*i), 20)
        plain_ms = graph_ms(lambda p=plain, i=ins: p(*i), 3)
        us = dict(k11=host_us(lambda k=kernel, i=ins: k(*i), 100, 3))
        if not f64:  # the float64 plain version's is not measured
            us["plain"] = host_us(lambda p=plain, i=ins: p(*i), 5, 3)
        print(f"[k11] {entry}{suffix} {label}: bitwise {ok} launches a "
              f"call={launches / 2:g} max_abs_err={err:.3e} device-only "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library: none bound_ms="
              f"{bound_fields(work)} host us a call {us} ({card_label()})")
        for what, good in ok.items():
            check(good, f"k11: {entry}{suffix} not " + (
                "within 1e-12" if f64 and what == "vs_cpu_plain"
                else "bitwise") + f" ({what})")
        check(launches == 2, f"k11: {entry}{suffix} launched {launches} "
              "times in two calls")
        results[entry + suffix] = [dict(err=err, ms=ms, plain_ms=plain_ms,
                                        shape=label, library_ms=None,
                                        **work)]
    return results


def phase_k9(sizes):
    """K9, the PCG's dot, vs its plain version ``tree_dot_plain`` at the
    main paths' lengths ``sizes`` ((label, n, dtype): Venice's dim_p in
    float32 and float64, sphere2500's n d in float32), on seeded inputs
    with -0.0 entries: bitwise equal on the card, on the CPU and in a
    replayed CUDA graph, bitwise repeatable, one launch a call. Timed
    device-only (calls replayed from a CUDA graph: a call is a few us, less
    than the host's launch work) against its bound (both vectors read once
    at the HBM rate), the plain version's and the library call's,
    ``torch.dot`` (the same function, summed in cuBLAS's order); the host
    us of a call too."""
    import numpy as np
    import torch

    from graphite_tpu_torch.kernel_sweep import graph_ms, host_us
    from graphite_tpu_torch.ops.cuda import dot
    from graphite_tpu_torch.ops.pcg_loop import tree_dot_plain

    def bits(t):
        return int(t.view({4: torch.int32, 8: torch.int64}[
            t.element_size()]))

    records = {}  # entry point -> one record per shape
    for label, n, dtype in sizes:
        rng = np.random.default_rng(n)
        host = [torch.tensor(rng.standard_normal(n)
                             * 10.0 ** rng.integers(-3, 4, n), dtype=dtype)
                for _ in range(2)]
        host[0][::7] = -0.0
        u, v = (t.to(DEVICE) for t in host)
        stats = dot.STATS_F64 if dtype == torch.float64 else dot.STATS
        before = stats.launches
        out, again = dot.tree_dot(u, v), dot.tree_dot(u, v)
        launches = stats.launches - before
        ref, ref_cpu = tree_dot_plain(u, v), tree_dot_plain(*host)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = dot.tree_dot(u, v)
        graph.replay()
        torch.cuda.synchronize()
        ok = dict(vs_plain=bits(out) == bits(ref),
                  repeat=bits(again) == bits(out),
                  vs_cpu_plain=bits(out.cpu()) == bits(ref_cpu),
                  in_graph=bits(captured) == bits(ref))
        library = float(torch.dot(u, v))
        err = abs(float(out) - float(ref))
        ms = graph_ms(lambda: dot.tree_dot(u, v), 200)
        plain_ms = graph_ms(lambda: tree_dot_plain(u, v), 50)
        library_ms = graph_ms(lambda: torch.dot(u, v), 200)
        host = dict(k9=host_us(lambda: dot.tree_dot(u, v)),
                    plain=host_us(lambda: tree_dot_plain(u, v)))
        f64 = dtype == torch.float64
        work = bound(2 * n * u.element_size() + u.element_size(), 2 * n,
                     FP64_VECTOR_OPS_PER_S if f64 else FP32_OPS_PER_S)
        shape = f"{label} n={n} {str(dtype)[6:]}"
        print(f"[k9] {shape}: bitwise {ok} launches a call="
              f"{launches / 2:g} max_abs_err={err:.3e} (torch.dot differs "
              f"by {abs(library - float(ref)):.3e}) cluster of "
              f"{dot.cluster_size(n)} CTAs device-only ms={ms:.5f} was_ms="
              f"{K9_WAS_MS.get((n, str(dtype)[6:]))} (one CTA) "
              f"plain_ms={plain_ms:.5f} library_ms (torch.dot)="
              f"{library_ms:.5f} bound_ms={bound_fields(work)} host us a "
              f"call {host} ({card_label()})")
        for what, good in ok.items():
            check(good, f"k9: {shape} not bitwise ({what})")
        check(launches == 2, f"k9: {shape} launched {launches} times in "
              "two calls")
        records.setdefault(stats.name, []).append(dict(
            err=err, ms=ms, plain_ms=plain_ms, shape=shape,
            library_ms=library_ms, **work))
        del graph, captured
    return records


# K9's device-only ms before its cluster design (one CTA of 1,024 threads;
# PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W), by shape
K9_WAS_MS = {(16_002, "float32"): "0.00489", (16_002, "float64"): "0.00796",
             (14_994, "float32"): "0.00496"}


def phase_k10(problem, ss, hv):
    """K10 vs its plain version at Venice's first ``schur_values`` inputs
    (the damped Hessian values at its first linearization point: the Hll
    rows, the (9, 3) Hpl group, its plan), in float32 and, as K10's
    float64 instance (FP64_FP64, FP64_BF16), in float64: bitwise equal on
    the card, on the CPU and replayed from a CUDA graph, bitwise
    repeatable, one launch a call. Its ms beside the plain version's (the
    ops ``schur_values`` ran before K10) and its bound: Hpl and Hll read
    once, W and Hll^-1 written once, at 3.35 TB/s; the operations at 67
    (float32) or 34 (float64) TFLOP/s."""
    import torch

    from graphite_tpu_torch import schur
    from graphite_tpu_torch.ops.cuda import schur_w
    from graphite_tpu_torch.ops.streamreduce import take_rows

    (key,) = ss.hpl_keys
    dp, dl = key
    hll32 = take_rows(problem, ("lm_h_idx", dl), hv[(dl, dl)],
                      ss.lm_h_idx[dl])
    hpl32 = take_rows(problem, ("hpl_h", key), hv[key], ss.hpl_h_idx[key])
    plan = schur._w_plan(problem, ss, key)
    out_records = {}
    for dtype, entry, stats, tag in (
            (torch.float32, K10, schur_w.STATS, "k10"),
            (torch.float64, K10 + "[f64]", schur_w.STATS_F64, "k10-f64")):
        hll, hpl = hll32.to(dtype), hpl32.to(dtype)
        cpu_args = (hll.cpu(), hpl.cpu(), on_cpu(plan), dp, dl)

        def kernel():
            return schur_w.schur_w(hll, hpl, plan, dp, dl)

        def plain():
            inv = schur_w.hll_inverse_plain(hll, dl)
            return inv, schur_w.hpl_w_plain(hpl, inv, plan, dp, dl)

        def bits(t):
            return t.view(torch.int32 if t.element_size() == 4
                          else torch.int64)

        before = stats.launches
        out, again = kernel(), kernel()
        launches = stats.launches - before
        ref = plain()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = kernel()
        graph.replay()
        torch.cuda.synchronize()
        ok = dict(vs_plain=all(torch.equal(bits(o), bits(r))
                               for o, r in zip(out, ref)),
                  repeat=all(torch.equal(bits(o), bits(a))
                             for o, a in zip(out, again)),
                  in_graph=all(torch.equal(bits(c), bits(r))
                               for c, r in zip(captured, ref)))
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        del again, ref, captured, graph
        cpu = schur_w.schur_w(*cpu_args)
        ok["vs_cpu_plain"] = all(torch.equal(bits(o.cpu()), bits(c))
                                 for o, c in zip(out, cpu))
        del cpu, cpu_args
        L, K = hll.shape[0], hpl.shape[0]
        # a 3x3 inverse: 9 cofactors of 3 operations, the determinant's 5,
        # one division and 9 products; a W entry dl products and dl - 1
        # adds
        ops = {1: 1, 2: 12, 3: 42}[dl] * L + dp * dl * (2 * dl - 1) * K
        work = bound(nbytes(hll, hpl, *out), ops,
                     FP64_VECTOR_OPS_PER_S if dtype == torch.float64
                     else FP32_OPS_PER_S)
        del out
        torch.cuda.empty_cache()
        ms = device_ms(kernel, 20)
        plain_ms = device_ms(plain, 5)
        shape = (f"{L} ({dl},{dl}) Hll + {K} ({dp},{dl}) Hpl -> Hll^-1, W, "
                 f"Venice schur_values, {str(dtype).split('.')[-1]}")
        print(f"[{tag}] {shape}: bitwise {ok} launches a call="
              f"{launches / 2:g} max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms (the replaced ops)={plain_ms:.4f} library_ms=None "
              f"bound_ms={bound_fields(work)} bytes="
              f"{nbytes(hll, hpl) * 2} ({card_label()})")
        for what, good in ok.items():
            check(good, f"{tag}: not bitwise ({what})")
        check(launches == 2, f"{tag}: launched {launches} times in two "
              "calls")
        out_records[entry] = [dict(err=err, ms=ms, plain_ms=plain_ms,
                                   shape=shape, library_ms=None, **work)]
        del hll, hpl
    return out_records


def record_venice_solve(problem, lin, solver):
    """Venice's first solve (``PCGSchurSolver.solve`` at the start point,
    at the LM's initial damping) with K12's and K13's calls recorded:
    each call's arguments cloned before it runs. Returns {entry: [the
    arguments of its calls]} (the first three calls of each)."""
    import torch

    from graphite_tpu_torch.ops.cuda import pcg_step, schur_w
    from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions

    def clone(a):
        if torch.is_tensor(a):
            return a.clone()
        if isinstance(a, dict):
            return {k: clone(v) for k, v in a.items()}
        return a

    calls, saved = {}, []
    for module, name in ((pcg_step, "bjs_apply"), (pcg_step, "cg_advance"),
                         (pcg_step, "cg_commit"), (schur_w, "hll_solve")):
        real = getattr(module, name)

        def wrapped(*args, _real=real, _name=name):
            made = calls.setdefault(_name, [])
            if len(made) < 3:
                made.append(tuple(clone(a) for a in args))
            return _real(*args)

        saved.append((module, name, real))
        setattr(module, name, wrapped)
    try:
        mu = torch.full((), LevenbergMarquardtOptions().initial_damping,
                        dtype=problem.precision.graph_dtype,
                        device=problem.device)
        solver.solve(problem, lin, solver.prepare(problem, lin), mu, False)
        torch.cuda.synchronize()
    finally:
        for module, name, real in saved:
            setattr(module, name, real)
    return calls


def on_cpu_args(args):
    """A call's arguments with every tensor (and dict of tensors) on the
    CPU."""
    import torch

    out = []
    for a in args:
        if torch.is_tensor(a):
            a = a.cpu()
        elif isinstance(a, dict):
            a = {k: v.cpu() for k, v in a.items()}
        out.append(a)
    return tuple(out)


def nan_equal_bits(a, b):
    """Bitwise equal, NaNs compared by place (their payload is the
    device's)."""
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    view = {4: torch.int32, 8: torch.int64}[a.element_size()]
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(view)[~nan], b.view(view)[~nan]))


def phase_k12(calls):
    """K12's three entries vs their plain versions at the inputs of their
    first calls in Venice's first solve (``record_venice_solve``; the
    commit's in-place state cloned for every run): bitwise equal on the
    card, on the CPU and replayed from a CUDA graph, bitwise repeatable,
    one launch a call. Device-only ms (calls replayed from a graph)
    beside the plain version's and the library call's, ``torch.bmm`` of
    the (1778, 9, 9) inverses and the normalised residual for
    ``bjs_apply`` (the same product in cuBLAS's order; none computes the
    other two), and the bound (bytes once at 3.35 TB/s, float32
    operations at 67 TFLOP/s)."""
    import torch

    from graphite_tpu_torch.kernel_sweep import graph_ms, host_us
    from graphite_tpu_torch.ops import pcg_loop
    from graphite_tpu_torch.ops.cuda import pcg_step

    bjs_args = calls["bjs_apply"][1]  # the first CG step's
    r, rr, inv, segs = bjs_args
    (name, _, n_rows, d), = segs.segments
    adv = calls["cg_advance"][0]
    com = calls["cg_commit"][0]
    n = adv[0].shape[0]

    def fresh(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    # the commit and the advance write into their arguments: each run on
    # a fresh copy
    entries = {
        K12_BJS: (lambda a: pcg_step.bjs_apply(*a),
                  lambda a: pcg_step.bjs_apply_plain(*a), bjs_args,
                  lambda out, a: (out,)),
        K12_ADVANCE: (lambda a: pcg_step.cg_advance(*a),
                      lambda a: pcg_step.cg_advance_plain(*a), adv,
                      lambda out, a: (a[6], a[7])),
        K12_COMMIT: (lambda a: pcg_step.cg_commit(*a),
                     lambda a: pcg_step.cg_commit_plain(*a), com,
                     lambda out, a: (a[0], a[1], a[2], a[3], a[7], a[9],
                                     a[10], a[11], a[12])),
    }
    stats = {K12_BJS: pcg_step.BJS_STATS, K12_ADVANCE: pcg_step.ADVANCE_STATS,
             K12_COMMIT: pcg_step.COMMIT_STATS}
    rejected = bool(((com[8].abs() > com[13] * com[9])
                     | torch.isnan(com[8])).item())
    e = r.element_size()
    work = {
        # r, rr and the inverses read, z written; a division a y entry,
        # d products and d - 1 sums an output, one sqrt
        K12_BJS: bound(nbytes(r, rr, *inv.values()) + n * e,
                       n * (1 + 2 * d - 1) + 1),
        # x, r, p, v read, x_new, r_new written; 4 operations an entry
        K12_ADVANCE: bound(6 * n * e + 2 * e, 4 * n + 1),
        # accepted: p, z_new, x_new, r_new read, p, x, r, z written, two
        # operations an entry; rejected: the scalars only (rz, rz_new,
        # rz_min, rz written, k, done, the ticket read and written)
        K12_COMMIT: bound((0 if rejected else 8 * n * e) + 4 * e + 17,
                          0 if rejected else 2 * n),
    }
    labels = {
        K12_BJS: f"{n_rows} ({d},{d}) inverses, r ({r.shape[0]},) "
                 f"normalised, Venice's first CG step",
        K12_ADVANCE: f"({n},) x 4 -> x_new, r_new, Venice's first CG step",
        K12_COMMIT: f"({n},) x 7, the first CG step "
                    f"({'rejected' if rejected else 'accepted'})",
    }
    inv9 = inv[name].view(n_rows, d, d)
    y9 = pcg_loop.normalize(r, rr).view(n_rows, d, 1)
    library = {K12_BJS: lambda: torch.bmm(inv9, y9)}
    records = {}
    for entry, (kernel, plain, args, outs) in entries.items():
        st = stats[entry]
        before = st.launches
        a1, a2, a3 = fresh(args), fresh(args), fresh(args)
        o1 = outs(kernel(a1), a1)
        o2 = outs(kernel(a2), a2)
        launches = st.launches - before
        o3 = outs(plain(a3), a3)
        c = on_cpu_args(fresh(args))
        o4 = outs(kernel(c), c)  # the wrapper's CPU path: the plain version
        a5 = fresh(args)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            o5 = outs(kernel(a5), a5)
        for t, s in zip(a5, args):
            if torch.is_tensor(t):
                t.copy_(s)
        graph.replay()
        torch.cuda.synchronize()
        ok = dict(vs_plain=all(map(nan_equal_bits, o1, o3)),
                  repeat=all(map(nan_equal_bits, o1, o2)),
                  vs_cpu_plain=all(map(nan_equal_bits, o1, o4)),
                  in_graph=all(map(nan_equal_bits, o5, o3)))
        err = max(float((a.double() - b.double()).abs().nan_to_num().max())
                  for a, b in zip(o1, o3) if a.is_floating_point())
        del graph
        timed_args = fresh(args)
        ms = graph_ms(lambda: kernel(timed_args), 200)
        plain_ms = graph_ms(lambda: plain(timed_args), 20)
        lib = library.get(entry)
        library_ms = None if lib is None else graph_ms(lib, 200)
        host = host_us(lambda: kernel(timed_args))
        print(f"[k12] {entry} {labels[entry]}: bitwise {ok} launches a "
              f"call={launches / 2:g} max_abs_err={err:.3e} device-only "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms"
              f"{' (torch.bmm)' if lib else ''}={library_ms} "
              f"bound_ms={bound_fields(work[entry])} host us a call "
              f"{host:.1f} ({card_label()})")
        for what, good in ok.items():
            check(good, f"k12: {entry} not bitwise ({what})")
        check(launches == 2, f"k12: {entry} launched {launches} times in "
              "two calls")
        records[entry] = [dict(err=err, ms=ms, plain_ms=plain_ms,
                               shape=labels[entry], library_ms=library_ms,
                               **work[entry])]
    return records


def phase_k13(calls):
    """K13 vs its plain version at both calls of Venice's first solve
    (``record_venice_solve``: b_S's w = Hll^-1 b_l, and the
    back-substitution's with K4's sums subtracted): bitwise equal on the
    card, on the CPU and replayed from a CUDA graph, bitwise repeatable,
    one launch a call; its ms beside the plain version's (the
    ``flat_block_mv`` and subtraction it replaced), ``torch.bmm`` of the
    inverses and the rows, and its bound. Then the same calls in float64
    (inverses and rows cast: the FP64_FP64 path's dtypes at Venice's
    shapes)."""
    import torch

    from graphite_tpu_torch.ops.cuda import schur_w

    def f64(args):
        return tuple(a.double() if torch.is_tensor(a)
                     and a.is_floating_point() else a for a in args)

    records = {K13: [], K13 + "[f64]": []}
    for args, site in [(a, s) for a, s in zip(
            calls["hll_solve"][:2], ("b_S", "back-substitution"))] + [
            (f64(a), s + ", float64") for a, s in zip(
                calls["hll_solve"][:2], ("b_S", "back-substitution"))]:
        inv, gidx, t, sub = args
        n, d = t.shape
        stats = (schur_w.HLL_SOLVE_STATS_F64 if inv.dtype == torch.float64
                 else schur_w.HLL_SOLVE_STATS)
        before = stats.launches
        out, again = schur_w.hll_solve(*args), schur_w.hll_solve(*args)
        launches = stats.launches - before
        ref = schur_w.hll_solve_plain(*args)
        cpu = schur_w.hll_solve(*on_cpu_args(args))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = schur_w.hll_solve(*args)
        graph.replay()
        torch.cuda.synchronize()
        ok = dict(vs_plain=nan_equal_bits(out, ref),
                  repeat=nan_equal_bits(out, again),
                  vs_cpu_plain=nan_equal_bits(out, cpu),
                  in_graph=nan_equal_bits(captured, ref))
        err = float((out - ref).abs().max())
        del again, cpu, captured, graph
        rows = inv[:n] if gidx is None else inv.index_select(0, gidx)
        y = (t if sub is None else t - sub).to(inv.dtype)
        a3, y3 = rows.view(n, d, d), y.reshape(n, d, 1)
        # the inverse rows, t, sub and gidx read, w written; d products
        # and d - 1 sums an output, d subtractions a row
        work = bound(n * d * d * inv.element_size()
                     + nbytes(gidx, t, sub, out),
                     n * d * (2 * d - 1) + (0 if sub is None else n * d),
                     FP64_VECTOR_OPS_PER_S if inv.dtype == torch.float64
                     else FP32_OPS_PER_S)
        ms = device_ms(lambda: schur_w.hll_solve(*args), 20)
        plain_ms = device_ms(lambda: schur_w.hll_solve_plain(*args), 10)
        library_ms = device_ms(lambda: torch.bmm(a3, y3), 20)
        label = (f"{n} ({d},{d}) inverses x ({n},{d}) rows"
                 + ("" if sub is None else " - sub")
                 + (", identity rows" if gidx is None else ", gathered")
                 + f", Venice {site}")
        print(f"[k13] {label}: bitwise {ok} launches a call="
              f"{launches / 2:g} max_abs_err={err:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms (torch.bmm)="
              f"{library_ms:.4f} bound_ms={bound_fields(work)} "
              f"({card_label()})")
        for what, good in ok.items():
            check(good, f"k13: {site} not bitwise ({what})")
        check(launches == 2, f"k13: launched {launches} times in two calls")
        records[stats.name].append(dict(
            err=err, ms=ms, plain_ms=plain_ms, shape=label,
            library_ms=library_ms, **work))
        del out, ref, rows, y, a3, y3, args, inv, t, sub
    return records


def merge_measured(*parts):
    """Every phase's records of each entry point, in phase order."""
    out = {}
    for part in parts:
        for name, records in part.items():
            out.setdefault(name, []).extend(records)
    return out


def phase_venice_slice(problem, solver, iterations):
    import torch

    torch.cuda.reset_peak_memory_stats()
    with counted_matvecs() as matvecs:
        gpu, launches, kernel_ms = count_launches(
            lambda: run_lm(problem, solver, iterations))
    peak = torch.cuda.max_memory_allocated()
    check_solution("venice", problem, gpu)
    hist = gpu.history
    print(f"[venice] cuda initial_chi2={gpu.initial_chi2!r} "
          f"chi2={[h['chi2'] for h in hist]}")
    print(f"[venice] cuda accepted={[h['accepted'] for h in hist]}")
    dev_ms = [h["device_ms"] for h in hist]
    acc = [h["device_ms"] for h in hist[1:] if h["accepted"]]
    rej = [h["device_ms"] for h in hist[1:] if not h["accepted"]]
    print(f"[venice] ms per LM iteration (median of iterations 1..): "
          f"device={statistics.median(dev_ms[1:]):.3f} "
          f"accepted={statistics.median(acc) if acc else None} "
          f"rejected={statistics.median(rej) if rej else None} "
          f"all_device={[round(m, 3) for m in dev_ms]}")
    print(f"[venice] peak device memory max_memory_allocated="
          f"{peak / 2**30:.3f} GiB; CG matvecs={matvecs[0]}")
    print_launches("venice", launches, kernel_ms)
    check_k7("venice", launches)
    check_k10("venice", launches, len(hist))  # one solve an iteration
    check_k12("venice", launches, len(hist), matvecs[0])
    k3 = (launches["segsum_stream.streaming_segment_product_sum_rtbl"]
          + launches["segsum_stream.streaming_segment_product_sum"])
    check(k3 > 0, "K3 never launched on the Venice path")
    for name in ("segsum_stream.streaming_segment_sum",
                 "segmv.block_matvec_wtbl",
                 "segsum_stream.streaming_matvec_tbl",
                 "segmv.matvec_sym_stream"):
        check(launches[name] > 0, f"{name} never launched on the Venice path")
    check(launches["segmv.matvec_sym_stream"] == matvecs[0],
          "matvec_sym_stream must launch once per CG matvec")
    # the kernels of one relinearization (the accepted branch's K7 entries
    # and linearize's K1 row sums), device ms from their launch events
    branch = ("bal.bal_linearize", "bal.bal_scale_b", "bal.bal_hessian_sum",
              "segsum_stream.streaming_segment_sum")
    branch_ms = (sum(kernel_ms[k] for k in branch)
                 / launches["bal.bal_linearize"])
    print(f"[venice] the kernels of one relinearization {branch}: "
          f"{branch_ms:.4f} ms")
    return gpu, launches, peak, branch_ms


def phase_venice_cpu(problem, gpu, solver, iterations, direct_gpu,
                     direct_steps):
    """On ``problem``, the card problem's copy on the CPU (``Problem.to``:
    the same tensors and host structures, no freeze or structure built
    again): PCG-Schur for ``iterations``; then the sparse direct Schur
    solver's (dense S) first ``direct_steps`` steps from the card direct
    run's states (``compare_lockstep``)."""
    from graphite_tpu_torch.solvers import SparseDirectSchurSolver

    cpu = run_lm(problem, solver, iterations)
    compare_runs("venice-cpu", gpu, cpu)
    direct_run, states = direct_gpu
    compare_lockstep("direct-venice-cpu", direct_run, states[:direct_steps],
                     problem, SparseDirectSchurSolver())


def phase_forced(iterations):
    """Ladybug-49 with every Venice branch forced, CUDA vs CPU."""
    from graphite_tpu_torch import schur
    from graphite_tpu_torch.solvers import PCGSchurSolver

    solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    gates = schur.CHUNK_THRESHOLD, schur._smv_chunk_rows
    schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = 0, (lambda rb: 0)
    try:
        problem = ladybug_problem(DEVICE)
        with counted_matvecs() as matvecs:
            gpu, launches, kernel_ms = count_launches(
                lambda: run_lm(problem, solver, iterations))
        cpu = run_lm(ladybug_problem("cpu"), solver, iterations)
    finally:
        schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = gates
    compare_runs("forced", gpu, cpu)
    check(len(gpu.history) == len(cpu.history), "iteration counts differ")
    check_solution("forced", problem, gpu)
    print_launches("forced", launches, kernel_ms)
    check_k7("forced", launches)
    for name in ("segsum_stream.streaming_segment_product_sum_rtbl",
                 "segmv.block_matvec_wtbl",
                 "segsum_stream.streaming_matvec_tbl",
                 "segmv.matvec_sym_stream"):
        check(launches[name] > 0, f"{name} never launched (forced)")
    check_k12("forced", launches, len(gpu.history), matvecs[0])


class Recorded:
    """A solver that keeps, for each solve, its ``ok`` and the state the
    LM loop solved from (parameters and damping, device copies): read
    after the run, so the run has no extra sync."""

    def __init__(self, solver):
        self.solver = solver
        self.oks = []
        self.states = []

    def prepare(self, *args, **kwargs):
        return self.solver.prepare(*args, **kwargs)

    def solve(self, problem, lin, state, damping, use_identity, params=None):
        self.states.append(({k: v.clone() for k, v in params.items()},
                            damping.clone()))
        delta, ok = self.solver.solve(problem, lin, state, damping,
                                      use_identity, params=params)
        self.oks.append(ok)
        return delta, ok

    def failed(self):
        return sum(not bool(ok) for ok in self.oks)


def compare_lockstep(tag, gpu, states, cpu_problem, solver):
    """The CPU's LM step from each state of the card run (its parameters,
    damping and chi2; ``lm_step``) against the card's step: the same
    accept decision, chi2 within 1e-3 of the card's.

    A direct solver's float32 trajectory is chaotic: S (or H) is
    ill-conditioned and carries float32 cancellation error, so one step
    component whose float32 rounding differs between the two devices
    (cuSOLVER's and LAPACK's float64 solutions are not bitwise equal:
    ``first_direct_solve`` prints by how much) parts two independent runs
    by ~1e-3 in chi2 within a few iterations (PERF.md §6). Compared from
    the same state, each step stands on its own."""
    import torch

    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.optimizers.lm import lm_step

    t1 = time.perf_counter()
    counted = Recorded(solver)
    gdt = cpu_problem.precision.graph_dtype
    dev = cpu_problem.device
    steps = []
    for (params, mu), h in zip(states, gpu.history):
        params = {k: v.to(dev) for k, v in params.items()}
        chi2 = torch.tensor(h["chi2_before"], dtype=gdt, device=dev)
        lin = linearize(cpu_problem, params)
        accept, _, new_chi2, _ = lm_step(
            cpu_problem, counted, lin, counted.prepare(cpu_problem, lin,
                                                       params),
            params, mu.to(dev), chi2, False)
        steps.append((accept, float(new_chi2 if accept else chi2)))
    n = len(steps)
    acc_gpu = [h["accepted"] for h in gpu.history[:n]]
    chi_gpu = [h["chi2"] for h in gpu.history[:n]]
    acc_cpu = [a for a, _ in steps]
    chi_cpu = [c for _, c in steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(chi_gpu, chi_cpu)]
    print(f"[{tag}] {dev.type} steps from the run's states: "
          f"{time.perf_counter() - t1:.1f} s, failed_solves="
          f"{counted.failed()}")
    print(f"[{tag}] run chi2={chi_gpu} accepted={acc_gpu}")
    print(f"[{tag}] {dev.type} steps chi2={chi_cpu} accepted={acc_cpu}")
    print(f"[{tag}] max per-step chi2 rel diff={max(rel):.3e} "
          f"bitwise_equal_steps={chi_gpu == chi_cpu}")
    check(acc_gpu == acc_cpu, f"{tag}: accept decisions differ")
    check(max(rel) <= 1e-3, f"{tag}: chi2 differs by {max(rel)} > 1e-3")


def direct_system(problem, solver, lin, state, mu):
    """The damped matrix that ``solver`` factors on the first solve
    (damping ``mu``) and its right-hand side: (A, b), in the solver's
    dtype."""
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
        dense_hessian_matrix,
    )
    from graphite_tpu_torch.solvers import dense_cholesky as dc
    from graphite_tpu_torch.solvers import dense_cholesky_schur as dcs

    if isinstance(state, dcs.SchurSolverState):
        ops, b_s = dcs.schur_system(problem, lin, state, mu, False)
        return dcs.schur_to_dense(problem, ops.ss, ops.sv), b_s
    b = lin.b[: problem.dim_h]
    if isinstance(solver, dc.DenseCholeskySolver):
        return dc.damp_hessian(state.H, mu, False), b
    hs = build_hessian_structure(problem)
    hv = apply_damping(problem, hs, state.hvals, lin.diag, mu, False)
    return dense_hessian_matrix(problem, hs, hv), b


def nd_work(plan):
    """The float64 operations of one multifrontal factorization, front by
    front at its real size (s own and b boundary columns): s^3/3
    (Cholesky), s^2 b (triangular solve) and s b^2 (Schur update)."""
    ops = 0
    for lv in plan.levels:
        s = (lv["own_g"] < plan.dim_h).sum(axis=1)
        b = (lv["bd_g"] < plan.dim_h).sum(axis=1)
        ops += int((s ** 3 / 3 + s * s * b + s * b * b).sum())
    return ops


# largest system that first_direct_solve also solves on the CPU
CPU_SOLVE_MAX = 16_002


def first_direct_solve(tag, problem, solver, mu=1e-4):
    """The first LM solve of ``solver`` on the card: two runs bitwise
    equal, ok, the float64 relative residual ||A x - b|| / ||b|| <= 1e-4
    (A the damped matrix), and the factorization's ms per call beside its
    bound (n^3/3 float64 operations over the float64 tensor-core peak;
    the fronts' for the multifrontal branch). Up to ``CPU_SOLVE_MAX`` it
    also solves the same system on the CPU and prints how far the two
    float64 solutions are apart. Returns its numbers."""
    import torch

    from graphite_tpu_torch.linearize import linearize
    from graphite_tpu_torch.ops import nd_multifrontal as nd
    from graphite_tpu_torch.solvers.dense_cholesky import cholesky_solve

    lin = linearize(problem, problem.params0)
    state = solver.prepare(problem, lin)
    delta, ok = solver.solve(problem, lin, state, mu, False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again, ok2 = solver.solve(problem, lin, state, mu, False)
    torch.cuda.synchronize()
    solve_ms = 1e3 * (time.perf_counter() - t0)
    A, b = direct_system(problem, solver, lin, state, mu)
    n = b.shape[0]
    A64 = A.double()
    x = delta[:n].double()
    b64 = b.double()
    resid = float((A64 @ x - b64).norm() / b64.norm())
    del A64
    repeat = torch.equal(delta, again) and bool(ok) == bool(ok2)
    plan = problem._cache.get("nd_plan")
    if n > getattr(solver, "on_device_dim_p", n):
        # the host branch: S copied to the host and solved by splu
        ms = solve_ms
        ops = None  # a sparse LU on the host: no device bound
        what = (f"host splu n={n} (the whole solve, S's CSC values copied "
                f"to the host; host clock)")
    elif plan is not None and getattr(solver, "multifrontal", None):
        from graphite_tpu_torch.hessian import (
            apply_damping,
            build_hessian_structure,
        )

        hv = apply_damping(problem, build_hessian_structure(problem),
                           state.hvals, lin.diag, mu, False)
        ms = device_ms(lambda: nd.nd_factor(problem, plan, hv), 5)
        ops = nd_work(plan)
        what = (f"multifrontal: {len(plan.levels)} levels (one batched "
                f"cholesky_ex, solve_triangular and bmm each), "
                f"{plan.n_nodes} fronts, widest front "
                f"{max(lv['W'] for lv in plan.levels)}")
    else:
        A64 = A.double()
        ms = device_ms(lambda: torch.linalg.cholesky_ex(A64), 5)
        ops = n ** 3 / 3
        what = f"float64 cholesky_ex n={n}"
        if n <= CPU_SOLVE_MAX:
            # the same system solved by LAPACK on the CPU
            x_gpu, _ = cholesky_solve(A, b)
            x_cpu, _ = cholesky_solve(A.cpu(), b.cpu())
            x_gpu = x_gpu.cpu()
            diff = float((x_gpu - x_cpu).abs().max() / x_cpu.abs().max())
            flips = int((x_gpu.float() != x_cpu.float()).sum())
            what += (f", cuda vs cpu float64 solution rel diff={diff:.3e}, "
                     f"float32 components differing={flips} of {n}")
            del x_gpu, x_cpu
        if n <= 2048:
            # what a float32 factor would give: the condition number, and
            # the card's and the CPU's float32 solutions
            ev = torch.linalg.eigvalsh(A64)
            x32 = [torch.cholesky_solve(b.float().cpu().unsqueeze(1),
                                        torch.linalg.cholesky(a.float()).cpu()
                                        ).squeeze(1)
                   for a in (A, A.cpu())]
            what += (f", condition number={float(ev.max() / ev.min()):.3e}, "
                     f"float32 factors: cuda vs cpu solution rel diff="
                     f"{float((x32[0] - x32[1]).abs().max() / x32[1].abs().max()):.3e}")
        del A64
    bound_ms = None if ops is None else 1e3 * ops / FP64_OPS_PER_S
    print(f"[{tag}] first solve: ok={bool(ok)} rel_residual={resid:.3e} "
          f"bitwise_repeat={repeat} factorization {what}: ms={ms:.4f} "
          f"bound_ms={bound_ms}")
    check(bool(ok), f"{tag}: the first solve failed")
    check(resid <= 1e-4, f"{tag}: residual {resid} > 1e-4")
    check(repeat, f"{tag}: two card solves differ")
    del A, b, delta, again
    torch.cuda.empty_cache()
    return dict(n=n, ms=ms, bound_ms=bound_ms, what=what)


def direct_path(tag, solver, make_problem, iterations, cpu=None,
                cpu_solver=None, quaternions=False):
    """One direct solver's first solve (``first_direct_solve``) and LM run
    on the card (launches counted, failed solves, ms per iteration, peak
    memory) on the problem ``make_problem`` (or makes), and, given
    ``cpu`` (a function making the CPU problem), the CPU's step from each
    of the card run's states with ``cpu_solver`` (default the same
    solver; ``compare_lockstep``). Returns (card result, launches, the
    first solve's numbers, the recorded states)."""
    import torch

    problem = make_problem() if callable(make_problem) else make_problem
    first = first_direct_solve(tag, problem, solver)
    torch.cuda.reset_peak_memory_stats()
    counted = Recorded(solver)
    gpu, launches, kernel_ms = count_launches(
        lambda: run_lm(problem, counted, iterations), record_events=False)
    peak = torch.cuda.max_memory_allocated()
    dev_ms = [h["device_ms"] for h in gpu.history]
    print(f"[{tag}] dim_h={problem.dim_h} ms per LM iteration (median of "
          f"iterations 1..): device="
          f"{statistics.median(dev_ms[1:] or dev_ms):.3f} all_device="
          f"{[round(m, 3) for m in dev_ms]} failed_solves="
          f"{counted.failed()} peak device memory max_memory_allocated="
          f"{peak / 2**30:.4f} GiB")
    print(f"[{tag}] launches { {k: v for k, v in launches.items() if v} }")
    check_solution(tag, problem, gpu)
    if quaternions:
        check_quaternions(tag, gpu)
    check(len(counted.states) == len(gpu.history),
          f"{tag}: a solve was not recorded")
    if cpu is not None:
        compare_lockstep(tag, gpu, counted.states, cpu(),
                         cpu_solver or solver)
    del problem
    torch.cuda.empty_cache()
    first.update(ms_per_iteration=statistics.median(dev_ms[1:] or dev_ms),
                 failed=counted.failed(), peak_gib=peak / 2**30)
    return gpu, launches, first, counted.states


def add_launches(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n
    return total


def phase_direct_ladybug(iterations):
    """Ladybug-49 (Schur) with the dense Cholesky on S, the sparse direct
    Schur solver on the card (dense S, n = 441) and on its host branch
    (``splu``), each on the card and on the CPU."""
    from graphite_tpu_torch.solvers import (
        DenseCholeskySchurSolver,
        SparseDirectSchurSolver,
    )

    total, firsts = {}, {}
    for label, solver in (
            ("dense-schur", DenseCholeskySchurSolver()),
            ("sparse-schur", SparseDirectSchurSolver()),
            ("sparse-schur-host", SparseDirectSchurSolver(on_device_dim_p=0))):
        tag = f"direct-ladybug {label}"
        _, launches, first, _ = direct_path(
            tag, solver, lambda: ladybug_problem(DEVICE), iterations,
            cpu=lambda: ladybug_problem("cpu"))
        check(launches["segsum_stream.streaming_segment_sum"] > 0,
              f"{tag}: K1 never launched")
        add_launches(total, launches)
        firsts[label] = first
    return total, firsts


def ladybug_full_problem(device):
    """Ladybug-49 without point elimination: the full H (dim_h 23,769)."""
    import torch

    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, synthetic

    g, *_ = bal.build_graph(synthetic.make_bal("ladybug", seed=0),
                            precision=FP32_FP32, eliminate_points=False)
    return g.freeze(device=torch.device(device))


def phase_direct_full_h(iterations):
    """Ladybug-49's full H with the dense Cholesky and the sparse direct
    solver (its dense branch on the card at this size; on the CPU its
    default, the host ``splu``)."""
    from graphite_tpu_torch.solvers import (
        DenseCholeskySolver,
        SparseDirectSolver,
    )

    total, firsts = {}, {}
    for label, solver in (("dense", DenseCholeskySolver()),
                          ("sparse", SparseDirectSolver())):
        tag = f"direct-full-h {label}"
        _, launches, first, _ = direct_path(
            tag, solver, lambda: ladybug_full_problem(DEVICE), iterations,
            cpu=lambda: ladybug_full_problem("cpu"))
        check(launches["segsum_stream.streaming_segment_sum"] > 0,
              f"{tag}: K1 never launched")
        add_launches(total, launches)
        firsts[label] = first
    return total, firsts


def phase_direct_sphere(iterations):
    """sphere2500 with the sparse direct solver: its dense branch
    (dim_h 14,994) and the multifrontal one, on the card and on the CPU
    with the same branch forced. K1 must run at every extend-add and
    right-hand-side site of the multifrontal factorization."""
    import torch

    from graphite_tpu_torch.hessian import build_hessian_structure
    from graphite_tpu_torch.ops import nd_multifrontal as nd
    from graphite_tpu_torch.ops.cuda import segsum_stream
    from graphite_tpu_torch.solvers import SparseDirectSolver

    total, firsts = {}, {}
    _, launches, firsts["dense"], _ = direct_path(
        "direct-sphere2500 dense", SparseDirectSolver(),
        lambda: pose_problem(DEVICE), iterations,
        cpu=lambda: pose_problem("cpu"),
        cpu_solver=SparseDirectSolver(on_device=True), quaternions=True)
    add_launches(total, launches)

    sums = dict(calls=0, k1=0)
    real = nd.add_sums

    def counted(target, values, site):
        before = segsum_stream.STATS.launches
        out = real(target, values, site)
        if target.device.type == "cuda":  # not the CPU's steps
            sums["calls"] += 1
            sums["k1"] += segsum_stream.STATS.launches - before
        return out

    nd.add_sums = counted
    solver = SparseDirectSolver(multifrontal=True)
    problem = pose_problem(DEVICE)
    t0 = time.perf_counter()
    problem._cache["nd_plan"] = nd.build_nd_plan(
        problem, build_hessian_structure(problem))
    plan_s = time.perf_counter() - t0
    try:
        _, launches, firsts["multifrontal"], _ = direct_path(
            "direct-sphere2500 multifrontal", solver, problem, iterations,
            cpu=lambda: pose_problem("cpu"), quaternions=True)
    finally:
        nd.add_sums = real
    plan = problem._cache["nd_plan"]
    print(f"[direct-sphere2500 multifrontal] tree depth="
          f"{len(plan.levels)} fronts={plan.n_nodes} widest front="
          f"{max(lv['W'] for lv in plan.levels)} host plan seconds="
          f"{plan_s:.3f}; add_sums calls on the card="
          f"{sums['calls']} K1 launches at the ND sites={sums['k1']}")
    check(sums["k1"] > 0 and sums["k1"] == sums["calls"],
          "K1 did not launch at every ND extend-add / right-hand-side site")
    add_launches(total, launches)
    records = phase_nd_k1_sites(plan)
    del problem
    torch.cuda.empty_cache()
    return total, firsts, records


def phase_nd_k1_sites(plan):
    """K1 vs its plain version at the largest extend-add and the largest
    right-hand-side site of the multifrontal plan (seeded values)."""
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import segsum_stream
    from graphite_tpu_torch.ops.cuda.segsum import segment_sum_plain

    sites = [(kind, li, getattr(st, kind)) for li, st in enumerate(plan.sites)
             for kind in ("ea", "rhs") if getattr(st, kind) is not None]
    rng = np.random.default_rng(5)
    records = []
    for kind in ("ea", "rhs"):
        _, li, site = max((s for s in sites if s[0] == kind),
                          key=lambda s: s[2].plan.rows)
        sp = site.plan
        vals = torch.as_tensor(rng.standard_normal((sp.rows, 1)).astype(
            np.float32), device=DEVICE)
        cvals, cplan = vals.cpu(), on_cpu(sp)
        label = (f"sphere2500 multifrontal {sp.rows}x1->{sp.num_segments} "
                 f"group {sp.group} "
                 + ("extend-add" if kind == "ea" else "right-hand side")
                 + f", level {li}" + (", permuted" if sp.perm is not None
                                      else ""))
        records.append(measure(
            "k1", label,
            lambda: segsum_stream.streaming_segment_sum(vals, sp),
            lambda: segment_sum_plain(vals, sp),
            lambda: segment_sum_plain(cvals, cplan), 10, 3,
            k1_bound(vals, sp),
            k1_library(vals, input_order_ids(sp), sp.num_segments)))
    return {"segsum_stream.streaming_segment_sum": records}


def phase_direct_venice(problem, iterations):
    """Venice-1778 with the sparse direct Schur solver: dense S at dim_p
    16,002, factored on the card."""
    from graphite_tpu_torch.solvers import SparseDirectSchurSolver

    gpu, launches, first, states = direct_path(
        "direct-venice", SparseDirectSchurSolver(), problem, iterations)
    for name in ("segsum_stream.streaming_segment_sum",
                 "segsum_stream.streaming_segment_product_sum_rtbl",
                 "segmv.block_matvec_wtbl",
                 "segsum_stream.streaming_matvec_tbl"):
        check(launches[name] > 0, f"{name} never launched (direct-venice)")
    return (gpu, states), launches, first


def phase_cli():
    """Both CLIs in-process on the card: the six BAL solvers at Ladybug-49
    (3 iterations) and the three pose-graph solvers at 500 poses (5)."""
    from graphite_tpu_torch.examples import bal as bal_cli
    from graphite_tpu_torch.examples import pose_graph as pose_cli

    def run():
        out = {}
        for solver in bal_cli.SOLVERS:
            out[f"bal {solver}"] = bal_cli.main(
                ["--synthetic", "ladybug", "--iterations", "3", "--solver",
                 solver])
        for solver in pose_cli.SOLVERS:
            out[f"pose_graph {solver}"] = pose_cli.main(
                ["--poses", "500", "--iterations", "5", "--solver", solver])
        return out

    results, launches, _ = count_launches(run, record_events=False)
    for name, res in results.items():
        print(f"[cli] {name}: chi2 {res.initial_chi2!r} -> {res.chi2!r} "
              f"accepted={[h['accepted'] for h in res.history]}")
        check(res.chi2 < res.initial_chi2, f"cli {name}: chi2 not lowered")
    check(launches["segsum_stream.streaming_segment_sum"] > 0,
          "K1 never launched by the CLIs")
    return launches



# ---- jit_loop: the LM iteration captured as a CUDA graph ----------------

def same_bits(tag, a, b):
    """Bitwise the same LM run: accept pattern, chi2 and mu per iteration,
    final chi2 and parameters."""
    import torch

    for key in ("accepted", "chi2", "mu", "rho"):
        check([h[key] for h in a.history] == [h[key] for h in b.history],
              f"{tag}: {key} per iteration differs")
    check((a.chi2, a.initial_chi2, a.iterations, a.accepted_steps)
          == (b.chi2, b.initial_chi2, b.iterations, b.accepted_steps),
          f"{tag}: final state differs")
    for name, p in b.params.items():
        check(torch.equal(a.params[name], p), f"{tag}: params {name} differ")


def graph_launches(loop):
    """A captured path's launches by entry point over the loop's replays:
    the top level's on every replay, a conditional region's on each run of
    its body (the regions' run counts read back once)."""
    return loop.capture.launches(loop.replays)


def replay_split(loop, result):
    """The last run's replay ms: (accepted, rejected, after the stop)."""
    ms = loop.replay_ms
    return ([m for m, h in zip(ms, result.history) if h["accepted"]],
            [m for m, h in zip(ms, result.history) if not h["accepted"]],
            ms[result.iterations:])


def region_launches(capture):
    """Each kernel wrapper's launches captured in each region (those of
    the regions nested in it apart), summed by region name."""
    out = {}
    for region in capture.regions:
        into = out.setdefault(region.name, {})
        for name, n in region.launches.items():
            if name != "cond.set_conditional":
                into[name] = into.get(name, 0) + n
    return out


def median_or_none(values):
    return round(statistics.median(values), 4) if values else None


def print_replays(tag, loop, result, runs_iterations, runs_accepted):
    """Accepted, rejected and after-stop replay ms of the last run, the
    regions' run counts over the loop's life (checked against the runs'
    ``runs_iterations`` iterations and ``runs_accepted`` accepted steps),
    the CG steps per iteration, the graph pool and peak memory."""
    import torch

    acc, rej, after = replay_split(loop, result)
    runs = loop.capture.region_runs()
    cg = runs.get("cg_step")
    per_it = None if cg is None else round(cg / max(runs_iterations, 1), 3)
    print(f"[{tag}] replay ms ({card_label()}): accepted median="
          f"{median_or_none(acc)} (n={len(acc)}) rejected median="
          f"{median_or_none(rej)} (n={len(rej)}) after the stop "
          f"{[round(m, 4) for m in after]}; region runs over the loop's "
          f"life {runs}; CG steps per iteration={per_it} (of "
          f"{getattr(loop.solver, 'max_iter', None)}); graph pool="
          f"{loop.pool_bytes / 2**20:.1f} MiB max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(runs.get("lm_run") == runs.get("lm_iteration")
          == runs.get("lm_update") == runs_iterations,
          f"{tag}: the iteration, step and update regions ran {runs}, not "
          f"{runs_iterations} times")
    check(runs.get("lm_accept") == runs_accepted
          and runs.get("lm_reject") == runs_iterations - runs_accepted,
          f"{tag}: the accept / reject regions ran {runs}")
    return acc, rej, after


def run_graph(tag, problem, solver, iterations, host, lm=None):
    """``jit_loop`` on the card, twice (the first call captures, the
    second only replays), each bitwise equal to ``host`` (the card's host
    loop from the same start). Prints the capture seconds, ms per
    iteration of the graph (per replay, CUDA events: accepted, rejected,
    after the stop) and of the host loop, the launches captured, the
    regions' run counts, the CG steps per iteration and the graph pool's
    memory. Returns (the second run, the cached loop, launches of both
    runs)."""
    import torch

    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu_torch.optimizers.lm import cached_device_loop

    lm = lm or levenberg_marquardt
    opts = LevenbergMarquardtOptions(iterations=iterations, jit_loop=True)
    t0 = time.perf_counter()
    first = lm(problem, solver, options=opts)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = lm(problem, solver, options=opts)
    t_second = time.perf_counter() - t0
    loop = cached_device_loop(problem, solver, opts)
    check(loop is not None and loop.capture is not None,
          f"{tag}: no captured graph")
    same_bits(f"{tag} (capturing call)", first, host)
    same_bits(tag, out, host)
    host_ms = [h["device_ms"] for h in host.history[1:]]
    host_wall = [1e3 * h["time"] for h in host.history[1:]]
    print(f"[{tag}] bitwise_equal_to_host_loop=True iterations={iterations} "
          f"accepted={[h['accepted'] for h in out.history]}")
    print(f"[{tag}] capture seconds={loop.capture_seconds:.3f} (first call "
          f"{t_first:.3f} s incl. warm-up, init and replays; second call "
          f"{t_second:.3f} s) graph pieces={len(loop.capture.pieces)} "
          f"host syncs per replay={loop.capture.host_calls} conditional "
          f"regions={len(loop.capture.regions)}")
    print(f"[{tag}] ms per LM iteration: graph device="
          f"{statistics.mean(loop.replay_ms[:out.iterations]):.4f} (per "
          f"replay {[round(m, 4) for m in loop.replay_ms]}) host loop median "
          f"device={statistics.median(host_ms):.4f} "
          f"host wall={statistics.median(host_wall):.4f}")
    print(f"[{tag}] launches captured (a replay runs at most these)="
          f"{dict(loop.capture_launches)}; by region: top level "
          f"{loop.capture.top_launches}, "
          f"{region_launches(loop.capture)}")
    print_replays(tag, loop, out, first.iterations + out.iterations,
                  first.accepted_steps + out.accepted_steps)
    return out, loop, graph_launches(loop)


def phase_jit_ladybug(iterations):
    """Ladybug-49 under jit_loop: PCG-Schur (K1, K2) and dense Schur."""
    from graphite_tpu_torch.solvers import (
        DenseCholeskySchurSolver,
        PCGSchurSolver,
    )

    problem = ladybug_problem(DEVICE)
    total = {}
    for name, solver in (("pcg-schur", PCGSchurSolver(10, 1.0, 5.0)),
                         ("dense-schur", DenseCholeskySchurSolver())):
        host = run_lm(problem, solver, iterations)
        _, loop, launches = run_graph(f"jit-ladybug {name}", problem, solver,
                                      iterations, host)
        check(loop.capture.host_calls == 0, "a host sync in the graph")
        for key in ("segsum.sorted_segment_sum",
                    "segsum_stream.streaming_segment_sum"):
            check(loop.capture_launches.get(key, 0) > 0,
                  f"{key} not in the graph")
        if name == "pcg-schur":
            check(loop.capture_launches.get("pcg_dense.dense_pcg") == 1,
                  "K2 must launch once per replay")
        check_k7(f"jit-ladybug {name}", launches)
        add_launches(total, launches)
    return total


def phase_jit_venice(problem, solver, iterations, host, branch_ms):
    """Venice-1778 under jit_loop vs phase 7's host loop; ``branch_ms``:
    the device ms of the kernels of one relinearization (phase 7)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    out, loop, launches = run_graph("jit-venice", problem, solver,
                                    iterations, host)
    acc, rej, _ = replay_split(loop, out)
    h_acc = [h["device_ms"] for h in host.history[1:] if h["accepted"]]
    h_rej = [h["device_ms"] for h in host.history[1:] if not h["accepted"]]
    print(f"[jit-venice] ms per accepted / rejected iteration: graph "
          f"{median_or_none(acc)} / {median_or_none(rej)}; host loop "
          f"{median_or_none(h_acc)} / {median_or_none(h_rej)} "
          f"({card_label()})")
    # a rejected replay skips the accepted branch: at least its K7 and K1
    # kernels
    check(acc and rej and statistics.median(rej)
          <= statistics.median(acc) - branch_ms,
          f"jit-venice: the median rejected replay is not below the median "
          f"accepted one by the relinearization's kernels ({branch_ms:.4f} "
          f"ms)")
    # a reject skips the relinearization: K7's linearize entries and its
    # three Hessian sums (one a site) sit in the accepted branch's region
    # with linearize's four K1 row sums (diagonal and b, cameras and
    # points) and no other K1 launch; the trial chi2 sits in the step's
    regions = region_launches(loop.capture)
    check_k7("jit-venice", launches)
    for region, want in (
            ("lm_accept", {"bal.bal_linearize": 1, "bal.bal_scale_b": 1,
                           "bal.bal_hessian_sum": 3,
                           "segsum_stream.streaming_segment_sum": 4}),
            ("lm_iteration", {"bal.bal_residual": 1})):
        check(all(regions[region].get(e) == n for e, n in want.items()),
              f"jit-venice: {region} does not launch {want}: "
              f"{regions[region]}")
    # K9: the solve's two set-up dots (b's norm and r.z) in the step's
    # region, three (p.v, the norm of r_new, r_new.z_new) in the CG step's
    # body
    check(regions["lm_iteration"].get(K10) == 1,
          f"jit-venice: K10 is not captured once in the step's region: "
          f"{regions}")
    check_k10("jit-venice", launches,
              loop.capture.region_runs()["lm_iteration"])
    check(regions["lm_iteration"].get("dot.tree_dot") == 2
          and regions["cg_step"].get("dot.tree_dot") == 3,
          f"jit-venice: K9 is not launched twice in the step and three "
          f"times in the CG step: {regions}")
    runs = loop.capture.region_runs()
    check(graph_launches(loop)["dot.tree_dot"]
          == 2 * runs["lm_iteration"] + 3 * runs["cg_step"],
          "jit-venice: K9's launches are not the regions' runs")
    # K12: bjs_apply once in the step's region (the solve's set-up), the
    # advance, bjs_apply and commit once in the CG step's body; K13 twice
    # in the step's region (b_S and the back-substitution)
    check(regions["lm_iteration"].get(K12_BJS) == 1
          and regions["lm_iteration"].get(K13) == 2
          and all(regions["cg_step"].get(e) == 1
                  for e in (K12_BJS, K12_ADVANCE, K12_COMMIT)),
          f"jit-venice: K12 / K13 are not captured once in the CG step and "
          f"once / twice in the step's region: {regions}")
    check_k12("jit-venice", launches, runs["lm_iteration"], runs["cg_step"])
    for key in ("segsum_stream.streaming_segment_sum",
                "segsum_stream.streaming_segment_product_sum_rtbl",
                "segsum_stream.streaming_matvec_tbl",
                "segmv.block_matvec_wtbl", "segmv.matvec_sym_stream",
                "dot.tree_dot"):
        check(loop.capture_launches.get(key, 0) > 0,
              f"{key} not in the Venice graph")
    check(loop.capture_launches["segmv.matvec_sym_stream"] == 1,
          "K5 must be captured once, in the CG step's loop body")
    check(graph_launches(loop)["segmv.matvec_sym_stream"]
          == loop.capture.region_runs()["cg_step"],
          "K5 must launch once per CG step run")
    drop_loop(problem, loop)  # phase 13 needs the memory
    replay_kernels(problem, solver)
    return launches


def kernel_key(name):
    """A device kernel's name, short: no "void ", argument list or
    namespace prefixes, at most 120 characters."""
    key = name[5:] if name.startswith("void ") else name
    if key.endswith(")"):
        depth = 0
        for i in range(len(key) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(key[i], 0)
            if depth == 0:
                key = key[:i]
                break
    for prefix in ("at::native::", "(anonymous namespace)::", "at::"):
        key = key.replace(prefix, "")
    return key.strip()[:120]


def device_kernels(fn):
    """The device kernels ``fn()`` runs (copies and sets left out), the
    device (calls, ms) of every device activity by ``kernel_key`` (copies
    and sets included) and by the host op that launched it with its input
    shapes (the op's self device time), from a ``torch.profiler`` trace,
    ``fn``'s result, and the launches the port's wrappers counted in
    ``fn`` (each one a kernel that a whole trace holds); None kernels
    when the trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphite_tpu_torch.ops.cuda import launches

    torch.cuda.synchronize()  # no earlier work in the trace
    before = launches.snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    counted = sum(n - before.get(name, 0)
                  for name, n in launches.snapshot().items())
    events = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(not ev.name.startswith(("Memcpy", "Memset"))
                  for ev in events)
    by_name = {}
    for ev in events:
        calls, ms = by_name.get(kernel_key(ev.name), (0, 0.0))
        by_name[kernel_key(ev.name)] = (
            calls + 1, ms + ev.time_range.elapsed_us() / 1e3)
    by_op = {f"{a.key} {a.input_shapes}": (a.count,
                                            a.self_device_time_total / 1e3)
             for a in prof.key_averages(group_by_input_shape=True)
             if a.device_type == torch.autograd.DeviceType.CPU
             and a.self_device_time_total > 0}
    return (kernels if events else None), by_name, by_op, out, counted


def count_step_kernels(problem, solver, attempts=3):
    """The device kernels of Venice's first two LM iterations from the
    start, as the captured iteration's code run eagerly (its regions as
    host branches: a profiler trace of a replay misses kernels inside the
    conditional nodes), each in a ``torch.profiler`` trace of its own:
    [(accepted, kernels, device (calls, ms) by kernel name, by host op
    and input shapes, CG steps)]. A trace that holds fewer device kernels
    than the port's wrappers counted in its iteration lost activities in
    the profiler: both iterations are traced again from the start, at
    most ``attempts`` times, and the last traces go to the caller's
    checks."""
    from graphite_tpu_torch.ops import device_loop
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
    )
    from graphite_tpu_torch.optimizers.lm import cached_device_loop

    opts = LevenbergMarquardtOptions(iterations=2, jit_loop=True)
    levenberg_marquardt(problem, solver, options=opts)
    loop = cached_device_loop(problem, solver, opts)
    for attempt in range(1, attempts + 1):
        loop._start(problem.params0, opts.initial_damping)
        out, short = [], []
        for _ in range(2):
            with (device_loop.enabled(), counted_matvecs() as steps,
                  dim_x_vectors(problem) as dim_x):
                kernels, by_name, by_op, _, counted = device_kernels(
                    loop._step)
            out.append((bool(loop.accepted), kernels, by_name, by_op,
                        steps[0], dim_x))
            if kernels is None or kernels < counted:
                short.append((kernels, counted))
        if not short:
            return out
        print(f"[trace] attempt {attempt} of {attempts}: a trace holds "
              f"fewer device kernels than the wrappers counted in its "
              f"iteration (kernels, counted) {short}")
    return out


@contextlib.contextmanager
def dim_x_vectors(problem):
    """Count the ``torch.cat`` calls that make a dim_x vector while open:
    all of them and those inside a CG step (the body of
    ``device_loop.while_loop``). Yields {"iteration": n, "cg_step": n}."""
    import torch

    from graphite_tpu_torch.ops import device_loop

    count = {"iteration": 0, "cg_step": 0}
    inside = [False]
    real_cat, real_loop = torch.cat, device_loop.while_loop

    def cat(*args, **kwargs):
        out = real_cat(*args, **kwargs)
        if out.dim() == 1 and out.shape[0] == problem.dim_x:
            count["iteration"] += 1
            count["cg_step"] += inside[0]
        return out

    def while_loop(pred_fn, body, name="loop"):
        def counted():
            inside[0] = True
            try:
                body()
            finally:
                inside[0] = False

        return real_loop(pred_fn, counted, name)

    torch.cat, device_loop.while_loop = cat, while_loop
    try:
        yield count
    finally:
        torch.cat, device_loop.while_loop = real_cat, real_loop


def print_breakdown(tag, by_name, top=16, by="name", phase="jit-venice"):
    """One iteration's device ms by kernel name (or host op), largest
    first: the ``top`` names and the rest summed."""
    total = sum(ms for _, ms in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    rest = rows[top:]
    print(f"[{phase}] {tag}: device ms {total:.4f} in "
          f"{sum(c for c, _ in by_name.values())} activities; by {by} "
          f"(calls, ms): " + "; ".join(
              f"{name} ({calls}, {ms:.4f})" for name, (calls, ms) in rows[:top])
          + f"; {len(rest)} other names "
          f"({sum(c for _, (c, _) in rest)}, "
          f"{sum(m for _, (_, m) in rest):.4f})")


def stale_shapes(problem):
    """The shapes, as a trace prints them, of each S group (K3 stores S
    = Hpp - the sums: no subtraction or fill there) and of each Hpl
    group and stored J (the accepted branch relinearizes in place: no
    copy of them)."""
    from graphite_tpu_torch import hessian, schur

    ss = schur.build_schur_structure(problem)
    hs = hessian.build_hessian_structure(problem)
    s_shapes = [f"[{ss.s_sizes[k]}, {k[0] * k[1]}]" for k in ss.s_keys]
    copies = [f"[{hs.group_sizes[k] + 1}, {k[0] * k[1]}]"
              for k in ss.hpl_keys]
    for name, fm in problem.factor_meta.items():
        F = problem.data.factors[name].ids[0].shape[0]
        E = fm.ftype.residual_dim
        copies += [f"[{F}, {E * vt.dim}]" for vt in fm.ftype.vertex_types]
    return s_shapes, copies


# the device kernels of Venice's rejected and accepted eager iteration in
# the parent's phase 16 (PR 20's final run, NVIDIA H100 80GB HBM3, 700 W)
PARENT_KERNELS = {False: 790, True: 832}


def landmark_fills(problem, by_op):
    """The fills of a landmark segment (the zeros a dim_x vector built
    from pose rows takes) in a trace's ops by host op and input shapes:
    (calls, ms) by op."""
    lm = [f"[{problem.seg_rows[t] * problem.vertex_meta[t].vtype.dim}]"
          for t in problem.segment_order
          if problem.seg_start[t] >= problem.elimination_col]
    return {op: v for op, v in by_op.items()
            if op.startswith(("aten::fill_", "aten::zero_"))
            and any(sh in op for sh in lm)}


def replay_kernels(problem, solver):
    """Venice's kernels per iteration with K7 and K9, with the plain dots
    (``tree_dot_plain`` for K9, as before K9) and with K7's gate shut (the
    generic branch); the first two also by kernel name, device ms of a
    rejected and an accepted iteration. Each graph is dropped after its
    count."""
    from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions
    from graphite_tpu_torch.optimizers.lm import cached_device_loop
    from graphite_tpu_torch.ops import pcg_loop
    from graphite_tpu_torch.ops.cuda import bal

    opts = LevenbergMarquardtOptions(iterations=2, jit_loop=True)
    counts = {}
    s_stale, copy_stale = stale_shapes(problem)
    gate, k9 = bal.gate, pcg_loop.tree_dot
    for name in ("with K7 and K9", "the plain dots", "K7's gate shut"):
        if name == "the plain dots":
            pcg_loop.tree_dot = pcg_loop.tree_dot_plain
        if name == "K7's gate shut":
            bal.gate = lambda problem, name: None
        try:
            runs = count_step_kernels(problem, solver)
            drop_loop(problem, cached_device_loop(problem, solver, opts))
        finally:
            bal.gate, pcg_loop.tree_dot = gate, k9
        counts[name] = [run[:2] for run in runs]
        if name == "K7's gate shut":
            continue
        for accepted, _, by_name, by_op, steps, dim_x in runs:
            tag = (f"{name}, " + ("accepted" if accepted else "rejected")
                   + f" iteration ({card_label()})")
            print_breakdown(tag, by_name)
            if name == "with K7 and K9":
                print_breakdown(tag, by_op, top=24,
                                by="host op and input shapes")
                # K10 took W's (4995188, 9, 3) products and adds and the
                # Hll^-1 expansion
                stale = [op for op in by_op
                         if op.startswith(("aten::mul [[4995188, 9, ",
                                           "aten::add [[4995188, 9, ",
                                           "aten::repeat_interleave"))]
                check(not stale and any(k.startswith("schur_w_kernel")
                                        for k in by_name),
                      f"jit-venice: {tag}: the trace holds the ops K10 "
                      f"replaced {stale} or no K10 kernel (its kernels "
                      f"{sorted(by_name)[:40]})")
                # K3 stores S = Hpp - the sums: no subtraction or fill over
                # S; the accepted branch relinearizes into the loop's
                # state: no copy of the Hpl group or the stored J
                stale = [op for op in by_op
                         if op.startswith(("aten::sub", "aten::rsub",
                                           "aten::fill_", "aten::zero_"))
                         and any(sh in op for sh in s_stale)]
                if accepted:
                    stale += [op for op in by_op
                              if op.startswith("aten::copy_")
                              and any(sh in op for sh in copy_stale)]
                print(f"[jit-venice] {tag}: ops over S {s_stale} or copies "
                      f"of {copy_stale}: {stale}")
                check(not stale, f"jit-venice: the trace holds the passes "
                      f"K3's store and the in-place relinearization "
                      f"removed: {stale}")
                # the CG step's vectors are pose-only (K12): no dim_x
                # vector in a CG step (the parent concatenated two a step,
                # filling the landmark segment of each); compose_delta
                # and an accepted iteration's linearize make theirs
                fills = landmark_fills(problem, by_op)
                cats = [v for k, v in by_name.items() if k.startswith("Cat")]
                print(f"[jit-venice] {tag}: {steps} CG steps; dim_x vectors "
                      f"made by cat {dim_x}; concatenation kernels (calls, "
                      f"ms) ({sum(c for c, _ in cats)}, "
                      f"{sum(m for _, m in cats):.4f}) (the parent's rejected "
                      f"iteration: 24, 0.2156 in 10 steps); fills of a "
                      f"landmark segment {fills}")
                check(steps > 0 and dim_x["cg_step"] == 0 and not fills,
                      f"jit-venice: dim_x vectors built in the CG step: "
                      f"{dim_x}, fills {fills}")
    check(any(a for a, _ in counts["with K7 and K9"]),
          f"jit-venice: no accepted iteration traced: {counts}")
    print(f"[jit-venice] device kernels of LM iterations 1 and 2 from the "
          f"start (accepted, kernels), the captured iteration run eagerly, "
          f"each in a torch.profiler trace of its own (None: the trace saw "
          f"no device activity): {counts}; the parent's with K7 and K9 "
          f"(PR 20's final run): "
          f"{[(a, PARENT_KERNELS[a]) for a, _ in counts['with K7 and K9']]}")
    with_k9 = counts["with K7 and K9"]
    check(all(k is not None for _, k in with_k9)
          and all(a <= b for (_, a), (_, b) in zip(
              with_k9, counts["the plain dots"])),
          f"jit-venice: K9 did not cut the kernels an iteration: {counts}")


def phase_jit_pose(problem, iterations, host):
    """sphere2500 under jit_loop vs phase 4b's host loop (K6, K11); then
    the device kernels of its first two iterations from the start, the
    captured iteration's code run eagerly under ``torch.profiler``, with
    K11 and with K11's gates shut (the jvp branch and the generic update
    of earlier PRs), by kernel name and by host op."""
    from graphite_tpu_torch.ops.cuda import pose

    solver = pose_solver()
    _, loop, launches = run_graph("jit-sphere2500", problem, solver,
                                  iterations, host)
    check(loop.capture_launches.get("pcg_mf.solve_pcg_mf") == 1,
          "K6 must launch once per replay")
    check_k7("jit-sphere2500", launches, entries=())  # no BAL factor
    check(not any(launches.get(e, 0) for e in K7_ENTRIES),
          "jit-sphere2500: K7 launched on a pose graph")
    check_k11("jit-sphere2500", launches)
    check(all(loop.capture_launches.get(e) == 1 for e in K11_ENTRIES),
          f"jit-sphere2500: K11's entries must be captured once each (the "
          f"trial chi2 and update in the step, the linearization in the "
          f"accepted branch): {loop.capture_launches}")

    counts = {}
    gates = pose.gate, pose.update_gate
    for name in ("with K11", "K11's gates shut"):
        if name != "with K11":
            pose.gate = lambda problem, name: None
            pose.update_gate = lambda problem, name: False
        try:
            runs = count_step_kernels(problem, solver)
        finally:
            pose.gate, pose.update_gate = gates
        counts[name] = [run[:2] for run in runs]
        accepted, _, by_name, by_op, _, _ = runs[0]
        tag = (f"{name}, " + ("accepted" if accepted else "rejected")
               + f" iteration ({card_label()})")
        print_breakdown(tag, by_name, phase="jit-sphere2500")
        print_breakdown(tag, by_op, top=24, by="host op and input shapes",
                        phase="jit-sphere2500")
        k11_kernels = [k for k in by_name if k.startswith((
            "linearize_kernel", "residual_kernel", "scale_b_kernel",
            "update_kernel"))]
        check(bool(k11_kernels) == (name == "with K11"),
              f"jit-sphere2500: {name}: K11's kernels in the trace: "
              f"{k11_kernels}")
    print(f"[jit-sphere2500] device kernels of LM iterations 1 and 2 from "
          f"the start (accepted, kernels), the captured iteration run "
          f"eagerly, each in a torch.profiler trace of its own: {counts}")
    check(all(a < b for (_, a), (_, b) in zip(
        counts["with K11"], counts["K11's gates shut"])),
          f"jit-sphere2500: K11 did not cut the kernels an iteration: "
          f"{counts}")
    drop_loop(problem, loop)
    return launches


def phase_remask(iterations):
    """Ladybug-49 frozen remaskable on the card, under jit_loop: an edit
    (every observation of points 0-77 disabled, camera 1 fixed) reuses the
    captured graph and matches a fresh freeze bitwise; undoing it
    reproduces the first run; LM2 stops where the CPU's does."""
    import numpy as np
    import torch

    from graphite_tpu_torch import FP32_FP32
    from graphite_tpu_torch.io import bal, synthetic
    from graphite_tpu_torch.optimizers import (
        LevenbergMarquardtOptions,
        levenberg_marquardt,
        levenberg_marquardt2,
    )
    from graphite_tpu_torch.optimizers.lm import device_loops
    from graphite_tpu_torch.solvers import PCGSchurSolver

    ds = synthetic.make_bal("ladybug", seed=0)
    n_pts = 78  # 1% of the 7,776 points

    def frozen(device, edited):
        g, _, _, fs = bal.build_graph(ds, precision=FP32_FP32)
        p = g.freeze(device=torch.device(device), remaskable=True)
        if edited:
            edit(p, fs)
        return p, fs

    def handles(fs):
        rows = np.asarray(fs.input_order)
        return np.nonzero(ds.point_idx[rows] < n_pts)[0]

    def edit(p, fs, on=True):
        fname = next(iter(p.factor_meta))
        for h in handles(fs):
            p.set_factor_active(fname, int(h), 0x80 if on else 0)
        p.set_vertex_fixed("bal_camera", 1, on)

    solver = PCGSchurSolver(10, 1.0, 5.0)
    opts = LevenbergMarquardtOptions(iterations=iterations, jit_loop=True)
    problem, fs = frozen(DEVICE, False)
    masks = [(t, t.data_ptr()) for t in
             [va.active for va in problem.data.vertices.values()]
             + [a for fa in problem.data.factors.values()
                for a in (fa.factor_mask, fa.slot_mask)]]
    t0 = time.perf_counter()
    full = levenberg_marquardt(problem, solver, options=opts)
    loops = device_loops(problem)
    check(len(loops) == 1, "one cached loop")
    capture = loops[0].capture
    t_edit = time.perf_counter()
    edit(problem, fs)
    t_edit = time.perf_counter() - t_edit
    edited = levenberg_marquardt(problem, solver, options=opts)
    check(device_loops(problem) == loops and loops[0].capture is capture,
          "the remask re-captured")
    check(all(t.data_ptr() == ptr for t, ptr in masks),
          "a mask tensor moved")
    fresh, _ = frozen(DEVICE, True)
    same_bits("remask vs fresh freeze", edited,
              levenberg_marquardt(fresh, solver, options=opts))
    # launches of every graph the phase replays: this one, the remasked
    # problem's and its LM2 graph
    launches = {}
    for loop in device_loops(fresh):
        add_launches(launches, graph_launches(loop))
    del fresh
    first_pts = problem.params0["bal_point"][:n_pts]
    check(torch.equal(edited.params["bal_point"][:n_pts], first_pts),
          "a disabled point moved")
    check(torch.equal(edited.params["bal_camera"][1],
                      problem.params0["bal_camera"][1]),
          "the fixed camera moved")
    edit(problem, fs, on=False)
    same_bits("remask undone vs first run",
              levenberg_marquardt(problem, solver, options=opts), full)
    print(f"[remask] {len(handles(fs))} observations of points 0-{n_pts - 1}"
          f" disabled and camera 1 fixed in {t_edit:.3f} s; one cached "
          f"graph, mask data_ptrs unchanged; bitwise equal to a fresh "
          f"remaskable freeze; undone: bitwise the first run; chi2 "
          f"{full.chi2!r} (all) / {edited.chi2!r} (edited); ms per "
          f"replay {statistics.mean(loops[0].replay_ms):.4f}")
    print_replays("remask", loops[0], full,
                  edited.iterations + 2 * full.iterations,
                  edited.accepted_steps + 2 * full.accepted_steps)

    lm2_iters = 30
    lm2_opts = LevenbergMarquardtOptions(iterations=lm2_iters, jit_loop=True)
    gpu = levenberg_marquardt2(problem, solver, options=lm2_opts)
    cpu_problem, _ = frozen("cpu", False)
    # the CPU's host loop (bitwise its uncaptured device loop, which would
    # run all 30 iterations) stops at the stop
    cpu = levenberg_marquardt2(cpu_problem, solver,
                               options=LevenbergMarquardtOptions(
                                   iterations=lm2_iters))
    lm2_loop = device_loops(problem)[-1]
    check(lm2_loop is not loops[0], "LM2 reused the LM graph")
    print(f"[remask] LM2 stop iteration card={gpu.iterations} "
          f"cpu={cpu.iterations} (of {lm2_iters}) accepted card="
          f"{[h['accepted'] for h in gpu.history]}; ms per replay "
          f"{statistics.mean(lm2_loop.replay_ms[:gpu.iterations]):.4f}")
    acc, _, after = print_replays("remask LM2", lm2_loop, gpu,
                                  gpu.iterations, gpu.accepted_steps)
    check(after and max(after) < 0.05 * statistics.median(acc),
          "remask: LM2's replays after the stop cost 5% of an accepted "
          "replay or more")
    check(gpu.iterations == cpu.iterations,
          "LM2 stops at another iteration on the card")
    check([h["accepted"] for h in gpu.history]
          == [h["accepted"] for h in cpu.history], "LM2 accept patterns")
    print(f"[remask] phase host seconds {time.perf_counter() - t0:.1f}")
    for loop in device_loops(problem):
        add_launches(launches, graph_launches(loop))
    check_k7("remask", launches)
    return launches


def phase_jit_cli():
    """The circle example and the CLIs' --jit-loop / --lm2 on the card."""
    import numpy as np
    import torch

    from graphite_tpu_torch.examples import bal as bal_cli
    from graphite_tpu_torch.examples import circle
    from graphite_tpu_torch.examples import pose_graph as pose_cli

    def run():
        return (circle.main([]),
                bal_cli.main(["--synthetic", "ladybug", "--iterations",
                              "10", "--jit-loop", "--lm2"]),
                pose_cli.main(["--poses", "500", "--iterations", "5",
                               "--jit-loop"]))

    (res_c, res_b, res_p), launches, _ = count_launches(
        run, record_events=False)
    pts = res_c.params["point2"].detach().cpu().numpy()
    radii = np.hypot(pts[:, 0], pts[:, 1])
    rng = np.random.default_rng(0)
    angles = rng.uniform(0.0, 2 * np.pi, 5)
    start = np.stack([4.0 * np.cos(angles) + rng.normal(0, 0.3, 5),
                      4.0 * np.sin(angles) + rng.normal(0, 0.3, 5)], axis=1)
    print(f"[cli-jit] circle radii={radii.tolist()}")
    # float32, as the JAX package's own float32 run: 4.000000 for points 0
    # and 1, 4.000021 for point 3
    check(all(abs(radii[i] - 4.0) < 1e-4 for i in (0, 1, 3)),
          "circle: a free point is off the radius")
    for i in (2, 4):
        check(torch.equal(res_c.params["point2"][i].cpu(),
                          torch.tensor(start[i], dtype=torch.float32)),
              f"circle: point {i} moved")
    for name, res in (("bal --jit-loop --lm2", res_b),
                      ("pose_graph --jit-loop", res_p)):
        print(f"[cli-jit] {name}: chi2 {res.initial_chi2!r} -> {res.chi2!r}"
              f" iterations={res.iterations}")
        check(res.chi2 < res.initial_chi2, f"{name}: chi2 not lowered")
    check_k11("cli-jit", launches)
    return launches

# ---- the precision policies ---------------------------------------------

POLICIES = ("FP64_FP64", "FP64_FP32", "FP64_BF16", "FP32_FP32", "FP32_BF16",
            "FP32_FP16")


# Venice-1778's K1 sites of phase 20, by (rows, width, permuted)
VENICE_K1_F64 = ((5_001_946, 3, False), (5_001_946, 9, True))


def phase_k1_f64(venice):
    """K1's float64 instance vs its plain version at Ladybug-49's sorted
    sites (seeded shapes of ``K1_SHAPES``) and at Venice-1778's point rows
    (sorted) and camera rows (permuted), from the frozen problem's plans:
    bitwise equal to the CPU's plain version, two runs bitwise identical,
    within 1e-12 of the card's plain version (whose ``index_add_`` adds in
    no fixed order)."""
    import numpy as np
    import torch

    from graphite_tpu_torch.ops.cuda import segsum, segsum_stream

    rng = np.random.default_rng(20)
    sites = []
    for k, ns, d, is_sorted, site in K1_SHAPES:
        if not is_sorted:
            continue
        seg = np.sort(rng.integers(0, ns, k))
        sites.append((f"ladybug {k}x{d}->{ns} group "
                      f"{segsum.group_size(k, len(np.unique(seg)), d)} "
                      f"{site}",
                      segsum.plan_segments(seg, ns, DEVICE, width=d), d,
                      "(segsum)" in site))
    want = set(VENICE_K1_F64)
    for label, plan, d in k1_sites(venice, "venice"):
        key = (plan.rows, d, plan.perm is not None)
        if key in want:
            want.discard(key)
            sites.append((label, plan, d, False))
    check(not want, f"Venice K1 plans not found: {want}")
    stats = {}
    for label, plan, d, scatter in sites:
        vals = torch.as_tensor(rng.standard_normal((plan.rows, d)),
                               device=DEVICE)
        cvals, cplan = vals.cpu(), on_cpu(plan)
        wrapper = (segsum.sorted_segment_sum if scatter
                   else segsum_stream.streaming_segment_sum)
        name = ("segsum.sorted_segment_sum[f64]" if scatter
                else "segsum_stream.streaming_segment_sum[f64]")
        check(wrapper(vals, plan).dtype == torch.float64,
              "K1 float64 returned another dtype")
        stats.setdefault(name, []).append(measure(
            "k1-f64", label, lambda: wrapper(vals, plan),
            lambda: segsum.segment_sum_plain(vals, plan),
            lambda: segsum.segment_sum_plain(cvals, cplan), 10, 3,
            k1_bound(vals, plan),
            k1_library(vals, input_order_ids(plan), plan.num_segments),
            tol=1e-12))
        del vals, cvals, cplan
    return stats


def median_ms(result):
    """Median device ms of an LM run's iterations 1.. (the first builds
    the host plans)."""
    return statistics.median(h["device_ms"] for h in result.history[1:])


def policy_check(tag, policy, gpu, cpu, cpu_problem=None, solver=None,
                 states=None):
    """The card-vs-CPU criterion of a policy: FP32_* bitwise (accept
    pattern, chi2 per iteration, final parameters); FP64_FP64 the accept
    pattern and chi2 within 1e-9; FP64_FP32 and FP64_BF16 (a float64 J
    rounded to float32 or bf16: a last-bit difference of the card's
    float64 cos / sin can flip that rounding) within 1e-3, or, where the
    two runs part, the CPU's step from each of the card's ``states``
    (``compare_lockstep``)."""
    import torch

    if policy.startswith("FP32"):
        bitwise = compare_runs(tag, gpu, cpu)
        check(bitwise, f"{tag}: not bitwise the CPU's run")
        for name, p in cpu.params.items():
            check(torch.equal(gpu.params[name].cpu(), p),
                  f"{tag}: parameters {name} differ from the CPU's")
        return
    if policy == "FP64_FP64":
        compare_runs(tag, gpu, cpu, rtol=1e-9)
        return
    n = len(cpu.history)
    rel = max(abs(a["chi2"] - b["chi2"]) / abs(b["chi2"])
              for a, b in zip(gpu.history, cpu.history))
    same = ([h["accepted"] for h in gpu.history[:n]]
            == [h["accepted"] for h in cpu.history])
    if same and rel <= 1e-3:
        compare_runs(tag, gpu, cpu)
        return
    print(f"[{tag}] the runs part (accept patterns equal={same}, max chi2 "
          f"rel diff={rel:.3e}): the CPU's step from each card state")
    compare_lockstep(tag, gpu, states, cpu_problem, solver)


def policy_run(tag, policy, make_problem, solver, iterations, cpu_iters):
    """One policy's LM run on the card (launches counted, peak memory)
    and on the CPU, held to ``policy_check``; returns the card's run and
    launches."""
    import torch

    # the states of the two policies that may part (``policy_check``)
    recorded = (Recorded(solver) if policy in ("FP64_FP32", "FP64_BF16")
                else None)
    problem = make_problem(DEVICE, policy)
    torch.cuda.reset_peak_memory_stats()
    gpu, launches, kernel_ms = count_launches(
        lambda: run_lm(problem, recorded or solver, iterations))
    peak = torch.cuda.max_memory_allocated()
    check_solution(tag, problem, gpu)
    del problem
    cpu_problem = make_problem("cpu", policy)
    cpu = run_lm(cpu_problem, solver, cpu_iters)
    policy_check(tag, policy, gpu, cpu, cpu_problem, solver,
                 recorded and recorded.states[:cpu_iters])
    print(f"[{tag}] ms per LM iteration (median of iterations 1..): "
          f"device={median_ms(gpu):.3f} peak device memory="
          f"{peak / 2**20:.1f} MiB ({card_label()})")
    print_launches(tag, launches, kernel_ms)
    return gpu, launches


def check_policy_kernels(tag, policy, launches, kernels, bal=True):
    """K1 in the policy's graph dtype launched; each entry of ``kernels``
    launched where it maps to True and never where it maps to False (the
    K2-K6 entries by the dtype of their sites: ``schur_kernels`` for K3,
    K4 and K5); on a BAL path (``bal``) each K7 entry launched in the
    graph dtype's instance (``[f64]`` in a float64 graph) and never in
    the other, and K10 and K13 in the inverses' dtype (float64 under
    FP64_FP64 and FP64_BF16) and never in the other."""
    f64 = policy.startswith("FP64")
    if bal:
        mine, other = ((K7_ENTRIES_F64, K7_ENTRIES) if f64
                       else (K7_ENTRIES, K7_ENTRIES_F64))
        check_k7(tag, launches, mine)
        check(all(launches[e] == 0 for e in other),
              f"{tag}: K7 launched in the other graph dtype's instance: "
              f"{ {e: launches[e] for e in other} }")
        for kernel in (K10, K13):
            mine, other = ((kernel + "[f64]", kernel) if inv_f64(policy)
                           else (kernel, kernel + "[f64]"))
            print(f"[{tag}] launches {mine}={launches[mine]} "
                  f"{other}={launches[other]}")
            check(launches[mine] > 0 and launches[other] == 0,
                  f"{tag}: {kernel} launched {launches[mine]} / "
                  f"{launches[other]} times in the inverses' dtype / the "
                  f"other")
    k1 = ("segsum_stream.streaming_segment_sum[f64]" if f64
          else "segsum_stream.streaming_segment_sum")
    check(launches[k1] > 0, f"{tag}: {k1} never launched")
    if not f64:
        check(launches["segsum_stream.streaming_segment_sum[f64]"] == 0,
              f"{tag}: K1 float64 launched on a float32 graph")
    for name, launched in kernels.items():
        if launched:
            check(launches[name] > 0, f"{tag}: {name} never launched")
        else:
            check(launches[name] == 0, f"{tag}: {name} launched on a site "
                  "of another dtype")


def phase_precision_ladybug(iterations):
    """Ladybug-49 under the six policies, then FP64_FP64, FP64_BF16,
    FP64_FP32 and FP32_BF16 with phase 9's forced branches; card vs
    CPU."""
    from graphite_tpu_torch import schur
    from graphite_tpu_torch.solvers import PCGSchurSolver

    out = {}
    for policy in POLICIES:
        tag = f"precision-ladybug {policy}"
        _, launches = policy_run(
            tag, policy, ladybug_problem, PCGSchurSolver(10, 1.0, 5.0),
            iterations, iterations)
        # S is float32 where inv_dtype is: FP32_*, FP64_FP32
        check_policy_kernels(tag, policy, launches, {
            "pcg_dense.dense_pcg": policy not in ("FP64_FP64",
                                                  "FP64_BF16")})
        out[tag] = launches
    gates = schur.CHUNK_THRESHOLD, schur._smv_chunk_rows
    schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = 0, (lambda rb: 0)
    try:
        for policy in ("FP64_FP64", "FP64_BF16", "FP64_FP32", "FP32_BF16"):
            tag = f"precision-ladybug-forced {policy}"
            _, launches = policy_run(
                tag, policy, ladybug_problem,
                PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0),
                iterations, iterations)
            check_policy_kernels(tag, policy, launches,
                                 schur_kernels(policy))
            out[tag] = launches
        # jit_loop under FP64_FP32 with the forced branches: the casts in
        # and out of K2, K4 and K5 allocate inside the capture
        tag = "precision-ladybug-graph FP64_FP32 forced"
        problem = ladybug_problem(DEVICE, "FP64_FP32")
        solver = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
        host = run_lm(problem, solver, iterations)
        _, _, out[tag] = run_graph(tag, problem, solver, iterations, host)
        del problem
    finally:
        schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = gates
    # and FP64_FP64: run_pcg_fixed on float64 cuBLAS products, K1 float64
    tag = "precision-ladybug-graph FP64_FP64"
    problem = ladybug_problem(DEVICE, "FP64_FP64")
    solver = PCGSchurSolver(10, 1.0, 5.0)
    host = run_lm(problem, solver, iterations)
    _, _, out[tag] = run_graph(tag, problem, solver, iterations, host)
    return out


def phase_precision_pose():
    """sphere2500 under FP32_BF16 (K6 on the float32 fold of the bf16 J),
    30 iterations, and FP64_FP64 (K11's and K6's float64 instances), 10
    iterations; card vs CPU, unit quaternions; FP64_FP64 also under
    ``jit_loop``, its replays bitwise the host loop."""
    import torch

    solver = pose_solver()
    out = {}
    for policy, iterations in (("FP32_BF16", 30), ("FP64_FP64", 10)):
        tag = f"precision-sphere2500 {policy}"
        f64 = policy.startswith("FP64")
        gpu, launches = policy_run(
            tag, policy, lambda dev, pol: pose_problem(dev, policy=pol),
            solver, iterations, iterations)
        check_quaternions(tag, gpu)
        # K6 and K11 in the graph dtype's instance, never in the other's
        mine, other = ("pcg_mf.solve_pcg_mf[f64]", "pcg_mf.solve_pcg_mf")
        if not f64:
            mine, other = other, mine
        check_policy_kernels(tag, policy, launches, {mine: True,
                                                     other: False},
                             bal=False)
        mine11, other11 = ((K11_ENTRIES_F64, K11_ENTRIES) if f64
                           else (K11_ENTRIES, K11_ENTRIES_F64))
        check_k11_counts(tag, launches, gpu, mine11)
        check(not any(launches[e] for e in other11),
              f"{tag}: K11 launched in the other graph dtype's instance")
        check(launches[mine] == len(gpu.history),
              f"{tag}: K6 must launch once per solve")
        print(f"[{tag}] K6 launches {mine}={launches[mine]} "
              f"{other}={launches[other]} in {len(gpu.history)} solves "
              f"({card_label()})")
        out[tag] = launches
    tag = "precision-sphere2500-graph FP64_FP64"
    problem = pose_problem(DEVICE, policy="FP64_FP64")
    host = run_lm(problem, solver, 10)
    _, loop, out[tag] = run_graph(tag, problem, solver, 10, host)
    check(loop.capture_launches.get("pcg_mf.solve_pcg_mf[f64]") == 1
          and all(loop.capture_launches.get(e) == 1
                  for e in K11_ENTRIES_F64),
          f"{tag}: K6 and each K11 entry must be captured once "
          f"({loop.capture_launches})")
    drop_loop(problem, loop)
    del problem
    torch.cuda.empty_cache()
    return out


# phase 23's Venice-1778 policies, each with the CPU iterations it is held
# to (on the card problem's copy, ~40 s an iteration): FP64_FP64 two, so
# that its first accepted step (Venice rejects its first iteration) goes
# through the float64 Schur kernels on both sides; FP32_BF16 one
VENICE_POLICIES = (("FP32_BF16", 1), ("FP64_FP64", 2))


def phase_precision_venice(ds, solver, iterations, fp32, structures):
    """Venice-1778 at full size under each of ``VENICE_POLICIES``
    (``precision_venice_run``); returns the launches of each run."""
    out = {}
    for policy, cpu_iters in VENICE_POLICIES:
        out.update(precision_venice_run(ds, solver, iterations, policy,
                                        cpu_iters, fp32, structures))
    return out


def precision_venice_run(ds, solver, iterations, policy, cpu_iters, fp32,
                         structures):
    """Venice-1778 under ``policy`` at full size: ``iterations`` LM
    iterations on the card, ms per accepted and rejected iteration apart,
    peak memory and the Schur kernels' launches beside FP32_FP32's
    (``fp32``: phase 7's run, peak and launches), and the stored
    Jacobians' bytes; under FP64_FP64 the same iterations under
    ``jit_loop`` bitwise the card's host loop; then ``cpu_iters`` on the
    CPU (on the card problem's copy, ``Problem.to``): FP32_* bitwise the
    card's, FP64_FP64 the accept pattern and chi2 within 1e-9 (the card's
    float64 cos / sin are not correctly rounded). The Hessian and Schur
    structures are topology only: ``structures``, phase 5's, are reused,
    not built again."""
    import numpy as np
    import torch

    import graphite_tpu_torch as gtt
    from graphite_tpu_torch.io import bal

    prec = getattr(gtt, policy)
    tag = f"precision-venice {policy}"
    t0 = time.perf_counter()
    g, *_ = bal.build_graph(ds, precision=prec)
    problem = g.freeze(device=torch.device(DEVICE))
    src_offsets, src_ids = structures["topology"]
    check(np.array_equal(problem.block_offsets, src_offsets)
          and all(np.array_equal(problem.host.factor_ids[n], src_ids[n])
                  for n in src_ids), f"{tag}: topology differs from phase 5")
    problem._cache.update({k: v for k, v in structures.items()
                           if k != "topology"})
    print(f"[{tag}] host set-up seconds={time.perf_counter() - t0:.1f}")
    torch.cuda.reset_peak_memory_stats()
    gpu, launches, kernel_ms = count_launches(
        lambda: run_lm(problem, solver, iterations))
    peak = torch.cuda.max_memory_allocated()
    check_solution(tag, problem, gpu)
    # the stored Jacobians: every slot's (F, E * d) block in the storage
    # dtype
    j_elems = sum(fm.count * fm.ftype.residual_dim
                  * sum(vt.dim for vt in fm.ftype.vertex_types)
                  for fm in problem.factor_meta.values())
    j_bytes = prec.solver_dtype.itemsize * j_elems
    fp32_run, fp32_peak, fp32_launches = fp32

    def split(run):
        hist = run.history[1:]
        acc = [h["device_ms"] for h in hist if h["accepted"]]
        rej = [h["device_ms"] for h in hist if not h["accepted"]]
        return (f"accepted={statistics.median(acc) if acc else None} "
                f"rejected={statistics.median(rej) if rej else None}")

    for name, run in ((policy, gpu), ("FP32_FP32, phase 7", fp32_run)):
        print(f"[{tag}] {name}: cuda chi2={[h['chi2'] for h in run.history]}"
              f" accepted={[h['accepted'] for h in run.history]} "
              f"{split(run)} device_ms by iteration="
              f"{[round(h['device_ms'], 3) for h in run.history]}")
    print(f"[{tag}] ms per LM iteration (median of iterations 1..): "
          f"device={median_ms(gpu):.3f} (FP32_FP32, phase 7: "
          f"{median_ms(fp32_run):.3f}); peak device memory "
          f"max_memory_allocated={peak / 2**30:.3f} GiB (FP32_FP32: "
          f"{fp32_peak / 2**30:.3f} GiB); stored J {j_bytes / 1e6:.1f} MB "
          f"(FP32_FP32: {4 * j_elems / 1e6:.1f} MB) ({card_label()})")
    mine = schur_kernels(policy)
    shown = [n for n, on in mine.items() if on] + [
        K10 + ("[f64]" if inv_f64(policy) else "")]
    print(f"[{tag}] the Schur kernels' launches (FP32_FP32's, phase 7): "
          + ", ".join(f"{n}={launches[n]} "
                      f"({fp32_launches[n.replace('[f64]', '')]})"
                      for n in shown))
    print_launches(tag, launches, kernel_ms)
    check_policy_kernels(tag, policy, launches, mine)
    out = {tag: launches}
    if policy == "FP64_FP64":
        _, _, out[tag + " graph"] = run_graph(f"{tag} graph", problem,
                                              solver, iterations, gpu)
    cpu_problem = problem.to("cpu")
    del problem
    torch.cuda.empty_cache()
    cpu = run_lm(cpu_problem, solver, cpu_iters)
    bitwise = compare_runs(tag, gpu, cpu,
                           rtol=1e-9 if policy == "FP64_FP64" else 1e-3)
    print(f"[{tag}] {cpu_iters} CPU iterations bitwise the card's: "
          f"{bitwise}")
    return out


# ---- first-order optimizers, covariance, the range-bearing example -------

def card_label():
    """The card's name and power limit, as ``nvidia-smi`` gives them
    (queried once)."""
    if not hasattr(card_label, "text"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        card_label.text = smi.stdout.strip().splitlines()[0]
    return card_label.text


# (optimizer, learning rate) of the first-order runs: the JAX package's
# test rates (tests/test_gd_adam_ba.py)
FIRST_ORDER = (("gd", 0.1), ("adam", 0.3))
K1_ENTRIES = ("segsum.sorted_segment_sum",
              "segsum_stream.streaming_segment_sum")


def first_order(problem, name, lr, iterations):
    """``gradient_descent`` or ``adam`` on ``problem`` from its start:
    (final parameters, history, the cached loop, the call's seconds)."""
    from graphite_tpu_torch.optimizers import (
        AdamOptions,
        GradientDescentOptions,
        adam,
        gradient_descent,
    )

    if name == "gd":
        run = gradient_descent
        opts = GradientDescentOptions(iterations=iterations,
                                      learning_rate=lr)
        key = ("gd", lr, iterations)
    else:
        run = adam
        opts = AdamOptions(iterations=iterations, learning_rate=lr)
        key = ("adam", lr, opts.beta1, opts.beta2, opts.epsilon, iterations)
    t0 = time.perf_counter()
    pf, hist = run(problem, options=opts)
    seconds = time.perf_counter() - t0
    return pf, hist, problem._cache.get(key), seconds


def same_first_order(tag, gpu, cpu):
    """The card's (params, hist) bitwise the CPU's."""
    import torch

    pf, hist = gpu
    cpu_pf, cpu_hist = cpu
    check(torch.equal(hist.cpu(), cpu_hist), f"{tag}: chi2 history differs "
          f"from the CPU's: {hist.tolist()} vs {cpu_hist.tolist()}")
    for n, p in cpu_pf.items():
        check(torch.equal(pf[n].cpu(), p), f"{tag}: params {n} differ")


def eager_step_ms(loop, steps):
    """The same step uncaptured on the card, after one untimed step:
    (device ms per step from CUDA events around ``steps`` steps, K1's
    launches and kernel ms per step)."""
    import torch

    from graphite_tpu_torch.ops import device_loop

    with device_loop.enabled():
        loop.step()

    def run():
        with device_loop.enabled():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                loop.step()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / steps

    ms, launches, kernel_ms = count_launches(run)
    k1 = sum(launches[e] for e in K1_ENTRIES) / steps
    k1_ms = sum(kernel_ms[e] for e in K1_ENTRIES) / steps
    return ms, k1, k1_ms


def print_first_order(tag, name, loop, hist, seconds, eager):
    import torch

    ms, k1, k1_ms = eager
    h = hist.tolist()
    per_replay = {k: v for k, v in loop.capture_launches.items()}
    print(f"[{tag}] {name} ({card_label()}): iterations={len(h)} chi2 "
          f"{h[0]!r} -> {h[-1]!r} fell={h[-1] < h[0]} rises="
          f"{sum(b > a for a, b in zip(h, h[1:]))}")
    print(f"[{tag}] {name} ({card_label()}): graph ms per replay="
          f"{statistics.mean(loop.replay_ms):.4f} (per replay "
          f"{[round(m, 4) for m in loop.replay_ms]}) uncaptured step on the "
          f"card ms per iteration={ms:.4f} capture seconds="
          f"{loop.capture_seconds:.3f} (first call {seconds:.3f} s) graph "
          f"pool memory={loop.pool_bytes / 2**20:.1f} MiB "
          f"max_memory_allocated="
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    print(f"[{tag}] {name} ({card_label()}): launches per replay="
          f"{per_replay} K1 per replay="
          f"{sum(per_replay.get(e, 0) for e in K1_ENTRIES)} K1 per eager "
          f"step={k1:.1f} K1 ms per eager step={k1_ms:.4f}")


def drop_loop(problem, loop):
    """Free a cached loop (its graph and pool)."""
    for key in [k for k, v in problem._cache.items() if v is loop]:
        del problem._cache[key]


def phase_first_order_ladybug(iterations):
    """GD and Adam at Ladybug-49 (FP32_FP32) as replays of one captured
    iteration, each bitwise the CPU run (history and final parameters)."""
    import torch

    total = {}
    for name, lr in FIRST_ORDER:
        problem = ladybug_problem(DEVICE)
        torch.cuda.reset_peak_memory_stats()
        pf, hist, loop, seconds = first_order(problem, name, lr, iterations)
        check(loop is not None and loop.capture is not None,
              f"{name}: no captured graph")
        check(loop.capture.host_calls == 0, f"{name}: a host sync in the "
              "graph")
        check(sum(loop.capture_launches.get(e, 0) for e in K1_ENTRIES) > 0,
              f"{name}: K1 not in the graph")
        again, hist2, _, _ = first_order(problem, name, lr, iterations)
        same_first_order(f"first-order-ladybug {name} (second call)",
                         (again, hist2),
                         ({n: p.cpu() for n, p in pf.items()}, hist.cpu()))
        cpu = first_order(ladybug_problem("cpu"), name, lr, iterations)
        same_first_order(f"first-order-ladybug {name}", (pf, hist), cpu[:2])
        print(f"[first-order-ladybug] {name}: bitwise_equal_to_cpu=True "
              f"(history and parameters, {iterations} iterations)")
        print_first_order("first-order-ladybug", name, loop, hist, seconds,
                          eager_step_ms(loop, iterations))
        add_launches(total, graph_launches(loop))
    return total


def phase_first_order_venice(problem, iterations, cpu_iters):
    """GD and Adam at Venice-1778 (FP32_FP32, full size): ``iterations``
    replays; then ``cpu_iters`` replays of their own capture from the same
    start, handed to the CPU check (``phase_first_order_venice_cpu``)."""
    import torch

    total, short = {}, {}
    for name, lr in FIRST_ORDER:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pf, hist, loop, seconds = first_order(problem, name, lr, iterations)
        check(loop is not None and loop.capture is not None,
              f"{name}: no captured graph")
        check(loop.capture.host_calls == 0,
              f"{name}: a host sync in the graph")
        check(bool(torch.isfinite(hist).all()), f"{name}: chi2 not finite")
        for p in pf.values():
            check(bool(torch.isfinite(p).all()), f"{name}: bad parameters")
        print_first_order("first-order-venice", name, loop, hist, seconds,
                          eager_step_ms(loop, 3))
        check_k7(f"first-order-venice {name}", graph_launches(loop),
                 ("bal.bal_linearize", "bal.bal_scale_b"))
        add_launches(total, graph_launches(loop))
        drop_loop(problem, loop)
        del pf
        pf2, hist2, loop2, _ = first_order(problem, name, lr, cpu_iters)
        check(torch.equal(hist2, hist[:cpu_iters]),
              f"{name}: the {cpu_iters}-iteration run differs")
        add_launches(total, graph_launches(loop2))
        drop_loop(problem, loop2)
        short[name] = ({n: p.cpu() for n, p in pf2.items()}, hist2.cpu())
    return total, short


def phase_first_order_venice_cpu(cpu_problem, short, cpu_iters):
    """The CPU's first ``cpu_iters`` GD and Adam iterations at
    Venice-1778 from the same start, bitwise the card's."""
    for name, lr in FIRST_ORDER:
        pf, hist, _, seconds = first_order(cpu_problem, name, lr, cpu_iters)
        same_first_order(f"first-order-venice-cpu {name}", short[name],
                         (pf, hist))
        print(f"[first-order-venice-cpu] {name}: {cpu_iters} CPU iterations "
              f"bitwise the card's (history {hist.tolist()} and parameters)"
              f" in {seconds:.1f} s")


# damping of the covariance phases, as tests/test_covariance.py's
COV_DAMPING = 1e-2
# the float32 Schur complement's cancellation error, relative to max|S|
# (ROADMAP Queue C)
S_CANCELLATION = 4e-5
# the bound on the Schur path's normwise backward error at Venice-1778:
# 25x the cancellation level of S, which bounds each entry's error of S
# relative to max|S| <= max diag(H_d); the factor leaves room for a row
# of such errors acting on x (Ladybug-49 on the CPU: 1.3e-6)
COV_BACKWARD_BOUND = 1e-3
# the bound on the covariance's relative asymmetry before its symmetric
# part is taken (the tolerance ladder's float32 rung)
COV_ASYMMETRY_BOUND = 1e-3


def covariance_targets(problem):
    """4 cameras and 4 points spread over the problem (48 columns)."""
    import numpy as np

    n_cam = problem.vertex_meta["bal_camera"].count
    n_pt = problem.vertex_meta["bal_point"].count
    cams = np.linspace(0, n_cam - 1, 4).astype(int)
    pts = n_cam + np.linspace(0, n_pt - 1, 4).astype(int)
    return ([("bal_camera", int(c)) for c in cams]
            + [("bal_point", int(p)) for p in pts])


def max_rel(a, b):
    """max|a - b| / max|b|."""
    return float((a - b).abs().max() / b.abs().max())


def phase_covariance_ladybug():
    """Ladybug-49 covariance (FP32_FP32, damping 1e-2, 4 cameras and 4
    points): the Schur path on the card against the CPU's within 1e-9,
    the dense path on the full H (dim_h 23,769) on the card, and the two
    within the tolerance from the float32 cancellation in S."""
    import torch

    from graphite_tpu_torch.covariance import joint_covariance
    from graphite_tpu_torch.linearize import linearize

    problem = ladybug_problem(DEVICE)
    lin = linearize(problem, problem.params0)
    targets = covariance_targets(problem)
    out, times = {}, {}

    def run(method):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = joint_covariance(problem, lin, targets, method=method,
                               damping=COV_DAMPING)
        end.record()
        end.synchronize()
        times[method] = start.elapsed_time(end)
        return res

    total = {}
    for method in ("schur", "dense"):
        run(method)  # host plans built
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out[method], launches, _ = count_launches(lambda: run(method),
                                                  record_events=False)
        peak = torch.cuda.max_memory_allocated()
        print(f"[covariance-ladybug] {method} ({card_label()}): "
              f"ms={times[method]:.3f} peak max_memory_allocated="
              f"{peak / 2**30:.3f} GiB launches="
              f"{ {k: v for k, v in launches.items() if v} }")
        add_launches(total, launches)
    cpu_problem = ladybug_problem("cpu")
    cpu = joint_covariance(cpu_problem,
                           linearize(cpu_problem, cpu_problem.params0),
                           targets, method="schur", damping=COV_DAMPING)
    schur, dense = out["schur"].cpu(), out["dense"].cpu()
    vs_cpu = max_rel(schur, cpu)
    # kappa(S) of the damped Schur complement: its eigenvalues in float64
    from graphite_tpu_torch.covariance import schur_system
    from graphite_tpu_torch.solvers.dense_cholesky_schur import (
        schur_to_dense,
    )

    ops = schur_system(problem, lin, COV_DAMPING, False)
    ev = torch.linalg.eigvalsh(schur_to_dense(problem, ops.ss,
                                              ops.sv).double())
    kappa = float(ev[-1] / ev[0])
    tol = kappa * S_CANCELLATION
    vs_dense = max_rel(schur, dense)
    print(f"[covariance-ladybug] ({card_label()}) dim_h={problem.dim_h} "
          f"dim_p={ops.ss.dim_p} columns={schur.shape[0]} schur card vs "
          f"cpu max rel={vs_cpu:.3e} (bound 1e-9) bitwise="
          f"{torch.equal(schur, cpu)}; schur vs dense on the card max rel="
          f"{vs_dense:.3e} (bound kappa(S) x {S_CANCELLATION} = {tol:.3e}, "
          f"kappa(S)={kappa:.1f})")
    check(vs_cpu <= 1e-9, f"covariance: card and CPU differ by {vs_cpu}")
    check(vs_dense <= tol, f"covariance: schur and dense differ by "
          f"{vs_dense} > {tol}")
    for name, c in (("schur", schur), ("dense", dense)):
        check(bool(torch.isfinite(c).all())
              and bool((torch.diagonal(c) > 0).all()),
              f"covariance {name}: a non-positive or non-finite diagonal")
    return total


def phase_covariance_venice(problem):
    """Venice-1778 covariance, the Schur path (damping 1e-2, 4 cameras and
    4 points: 48 columns): the public ``joint_covariance`` (its first call
    builds the host plans), with K3 once and K4 twice per column; then the
    same stage by stage with CUDA events, bitwise the public result, each
    full column x_j checked against the damped Hessian (``hessian_matvec``
    plus the damping diagonal): the normwise backward error ||H_d x_j -
    e_j|| / (max diag(H_d) ||x_j|| + 1) within ``COV_BACKWARD_BOUND``."""
    import torch

    from graphite_tpu_torch import covariance as cov
    from graphite_tpu_torch.hessian import (
        apply_damping,
        build_hessian_structure,
        compute_hessian_values,
    )
    from graphite_tpu_torch.linearize import (
        DIAG_MAX,
        DIAG_MIN,
        hessian_matvec,
        linearize,
    )
    from graphite_tpu_torch.schur import (
        SchurOps,
        build_schur_structure,
        schur_values,
    )
    from graphite_tpu_torch.solvers.dense_cholesky_schur import (
        schur_to_dense,
    )

    gdt = problem.precision.graph_dtype
    targets = covariance_targets(problem)
    cols, _ = cov._target_columns(problem, targets)
    k = len(cols)
    lin = linearize(problem, problem.params0)
    stages = {}

    def stage(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        stages[name] = stages.get(name, 0.0) + start.elapsed_time(end)
        return out

    def public():
        return cov.joint_covariance(problem, lin, targets, method="schur",
                                    damping=COV_DAMPING)

    t0 = time.perf_counter()
    joint, launches, _ = count_launches(public, record_events=False)
    first_s = time.perf_counter() - t0
    check(launches["segsum_stream.streaming_segment_product_sum_rtbl"] == 1,
          "covariance: K3 must launch once")
    check_k7("covariance-venice", launches, ("bal.bal_hessian_sum",))
    check(launches["bal.bal_hessian_sum"] == 3,
          "covariance: K7's Hessian sum must launch once per site")
    for key in ("segmv.block_matvec_wtbl",
                "segsum_stream.streaming_matvec_tbl"):
        check(launches[key] == k, f"covariance: {key} must launch once per "
              f"column ({launches[key]} for {k})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    again = stage("joint_covariance", public)
    check(torch.equal(again, joint), "covariance: not bitwise repeatable")
    peak = torch.cuda.max_memory_allocated()

    hs = build_hessian_structure(problem)
    ss = build_schur_structure(problem)
    hv = stage("hessian values (K7, K1) + damping", lambda: apply_damping(
        problem, hs, compute_hessian_values(problem, hs, lin), lin.diag,
        COV_DAMPING, False))
    sv = stage("schur_values (K3)", lambda: schur_values(problem, ss, hv))
    ops = SchurOps(problem, ss, hv, sv)
    S = stage("densify S", lambda: schur_to_dense(problem, ss, sv))
    n = S.shape[0]
    L = stage("float64 factor", lambda: cov.cholesky64(S))
    del S
    bs = [stage("b_S (K4), all columns", lambda c=c: ops.b_schur(
        cov.unit_column(problem.dim_x, int(c), gdt, problem.device)))
        for c in cols]
    Xp = stage("solve (48 right-hand sides)", lambda: torch.cholesky_solve(
        torch.stack(bs, dim=1).to(L.dtype), L))
    xs = [stage("back-substitution (K4) + compose, all columns",
                lambda j=j, c=c: cov.schur_column(ops, int(c), Xp[:, j]))
          for j, c in enumerate(cols)]
    per_col = {s_: round(v / k, 4) for s_, v in stages.items()
               if "all columns" in s_}
    print(f"[covariance-venice] ({card_label()}) dim_p={n} dim_x="
          f"{problem.dim_x} columns={k} first call {first_s:.2f} s (host "
          f"plans) launches={ {k_: v for k_, v in launches.items() if v} }")
    print(f"[covariance-venice] ({card_label()}) stage ms="
          f"{ {s_: round(v, 4) for s_, v in stages.items()} } per column="
          f"{per_col}; float64 factor bound="
          f"{1e3 * n ** 3 / 3 / FP64_OPS_PER_S:.2f} ms (PERF.md: 49.46 ms "
          f"for cholesky_ex + cholesky_solve at the same n); peak "
          f"max_memory_allocated of joint_covariance={peak / 2**30:.3f} GiB")
    check(bool(torch.isfinite(Xp).all()), "covariance: the factor failed")

    # backward error of each column against the damped Hessian
    damp = COV_DAMPING * lin.diag.clamp(DIAG_MIN, DIAG_MAX)
    d_max = float((lin.diag + damp)[: problem.dim_h].max())
    etas = []
    for c, x in zip(cols, xs):
        r = (hessian_matvec(problem, lin, x) + damp * x)[: problem.dim_h]
        r = r.double()
        r[int(c)] -= 1.0
        etas.append(float(r.norm()) / (
            d_max * float(x[: problem.dim_h].double().norm()) + 1.0))
    print(f"[covariance-venice] ({card_label()}) backward error max="
          f"{max(etas):.3e} median={statistics.median(etas):.3e} (bound "
          f"{COV_BACKWARD_BOUND}, max diag(H_d)={d_max:.4g})")
    check(max(etas) <= COV_BACKWARD_BOUND,
          f"covariance: backward error {max(etas)} > {COV_BACKWARD_BOUND}")

    # the selected entries as joint_covariance takes them
    c_t = torch.as_tensor(cols, device=problem.device)
    pose = torch.as_tensor(cols < n, device=problem.device)
    raw = torch.stack([torch.where(
        pose, Xp[:, j].index_select(0, c_t.clamp(max=n - 1)),
        x.index_select(0, c_t).to(Xp.dtype)) for j, x in enumerate(xs)],
        dim=1)
    s = lin.scales.index_select(0, c_t).to(raw.dtype)
    raw = raw * s[:, None] * s[None, :]
    asym = max_rel(raw, raw.T)
    staged = 0.5 * (raw + raw.T)
    diag = torch.diagonal(joint)
    print(f"[covariance-venice] ({card_label()}) staged run bitwise "
          f"joint_covariance={torch.equal(joint, staged)} relative "
          f"asymmetry={asym:.3e} (bound {COV_ASYMMETRY_BOUND}) diagonal "
          f"min={float(diag.min()):.4g} max={float(diag.max()):.4g}")
    check(torch.equal(joint, staged), "covariance: the public call differs "
          "from the staged run")
    check(asym <= COV_ASYMMETRY_BOUND, f"covariance: asymmetry {asym}")
    check(bool((diag > 0).all()) and bool(torch.isfinite(joint).all()),
          "covariance: a non-positive or non-finite diagonal")
    return launches


def phase_range_bearing():
    """The range-bearing SLAM example at its default size (100 poses, 40
    landmarks, 25 iterations: dim_p 297, K2) and at 500 poses, 200
    landmarks, 10 iterations (dim_p 1,497: a dense S with ``run_pcg``), on
    the card and on the CPU: the same accept pattern, chi2 within
    1e-3."""
    import contextlib
    import io

    from graphite_tpu_torch.examples import range_bearing_slam

    total = {}
    for size in ([], ["--poses", "500", "--landmarks", "200",
                      "--iterations", "10"]):
        tag = "range-bearing " + (" ".join(size) or "default")
        with contextlib.redirect_stdout(io.StringIO()) as log:
            t0 = time.perf_counter()
            gpu, launches, _ = count_launches(
                lambda: range_bearing_slam.main(size), record_events=False)
            t_gpu = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = range_bearing_slam.main(size + ["--device", "cpu"])
            t_cpu = time.perf_counter() - t0
        lines = log.getvalue().splitlines()
        dev_ms = [h["device_ms"] for h in gpu.history[1:]]
        print(f"[{tag}] {lines[0]}; card ({card_label()}) {t_gpu:.2f} s "
              f"(ms per LM iteration, median of iterations 1..: "
              f"{statistics.median(dev_ms):.3f}), CPU {t_cpu:.2f} s; "
              f"launches={ {k: v for k, v in launches.items() if v} }")
        compare_runs(tag, gpu, cpu)
        check(gpu.chi2 < gpu.initial_chi2, f"{tag}: chi2 not lowered")
        if not size:
            check(launches["pcg_dense.dense_pcg"] > 0,
                  "K2 never launched at the default size")
        add_launches(total, launches)
    return total


# ---- factor-parallel sharding (graphite_tpu_torch/parallel) --------------

def lm_options(iterations):
    from graphite_tpu_torch.optimizers import LevenbergMarquardtOptions

    return LevenbergMarquardtOptions(iterations=iterations)


def same_params(a, b):
    import torch

    return a.keys() == b.keys() and all(
        torch.equal(torch.as_tensor(a[k]).cpu(), torch.as_tensor(b[k]).cpu())
        for k in a)


def phase_shard_w1(problem, solver, iterations, host):
    """S1: ``sharded_lm`` at world size 1 over NCCL on phase 7's problem
    (``freeze(pad_factors_to=1)`` is that problem), bitwise phase 7's host
    loop ``host``: accept pattern, chi2, final parameters."""
    import tempfile

    import torch.distributed as dist

    from graphite_tpu_torch.parallel import make_mesh, sharded_lm

    tag = "shard-venice-w1"
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rv",
                                rank=0, world_size=1)
        mesh = make_mesh(device=problem.device)
        try:
            # K8's arena is made at the first collective
            mesh.allreduce(problem.params0[next(iter(problem.params0))])
            t0 = time.perf_counter()
            (params, chi2, k, accepted, trace), launches, kernel_ms = (
                count_launches(lambda: sharded_lm(
                    problem, mesh, solver, lm_options(iterations),
                    with_trace=True)))
            seconds = time.perf_counter() - t0
        finally:
            mesh.close()
            dist.destroy_process_group()
    trace = trace.tolist()
    chi_host = [h["chi2"] for h in host.history]
    acc_host = [h["accepted"] for h in host.history]
    print(f"[{tag}] {mesh.backend} world={mesh.world} chi2="
          f"{[t[0] for t in trace]} accepted={[bool(t[3]) for t in trace]} "
          f"({seconds / iterations * 1e3:.3f} ms per iteration, host clock, "
          f"its first linearization included; phase 7: "
          f"{sum(h['time'] for h in host.history) / iterations * 1e3:.3f})")
    print_launches(tag, launches, kernel_ms)
    check(k == len(host.history) and [t[0] for t in trace] == chi_host,
          f"{tag}: chi2 is not phase 7's bit for bit")
    check([bool(t[3]) for t in trace] == acc_host,
          f"{tag}: accept pattern differs from phase 7's")
    check(same_params(params, host.params),
          f"{tag}: final parameters differ from phase 7's")
    print(f"[{tag}] bitwise phase 7's host loop: accept pattern, chi2 and "
          f"final parameters")
    check_k10(tag, launches, k3_calls(launches))
    check_k12(tag, launches, k3_calls(launches))
    graph = shard_w1_graph(problem, solver, iterations, host)
    order_witness(problem, solver, 3, host)
    return add_launches(launches, graph)


def shard_w1_graph(problem, solver, iterations, host):
    """S1 under ``jit_loop`` (world size 1 may capture: its one NCCL rank's
    all-reduces lie inside the conditional regions): bitwise phase 7's host
    loop; its replays printed as phases 15-18 print theirs. Returns the
    graph's launches."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist

    from graphite_tpu_torch.optimizers.lm import device_loops
    from graphite_tpu_torch.parallel import make_mesh, sharded_lm
    from graphite_tpu_torch.parallel.sharding import _replica

    tag = "shard-venice-w1 jit_loop"
    opts = dataclasses.replace(lm_options(iterations), jit_loop=True)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/rv",
                                rank=0, world_size=1)
        mesh = make_mesh(device=problem.device)
        try:
            replica = _replica(problem, mesh)
            params, chi2, k, accepted, trace = sharded_lm(
                problem, mesh, solver, opts, with_trace=True)
            (loop,) = device_loops(replica)
            trace = trace.tolist()
            check(k == len(host.history)
                  and [t[0] for t in trace] == [h["chi2"]
                                                for h in host.history]
                  and same_params(params, host.params),
                  f"{tag}: not bitwise phase 7's host loop")
            result = types.SimpleNamespace(
                iterations=k, history=[dict(accepted=bool(t[3]))
                                       for t in trace[:k]])
            print(f"[{tag}] bitwise phase 7's host loop; capture seconds="
                  f"{loop.capture_seconds:.3f}")
            print_replays(tag, loop, result, k, accepted)
            launches = graph_launches(loop)
            check_k10(tag, launches, k3_calls(launches))
            check_k12(tag, launches, k3_calls(launches),
                      loop.capture.region_runs()["cg_step"])
            drop_loop(replica, loop)
            del loop
        finally:
            mesh.close()
            dist.destroy_process_group()
    return launches


def order_witness(problem, solver, iterations, host):
    """Phase 7's unsharded run again from its parameters moved by one
    float32 ulp (``nextafter`` up): how far a rounding-level change alone
    takes free-running float32 Venice trajectories apart (the measure for
    S2's free-running chi2 against phase 7). Printed, not checked."""
    import torch

    nudged = {n: torch.nextafter(v, torch.full_like(v, float("inf")))
              for n, v in problem.params0.items()}
    run = run_lm(problem, solver, iterations, params=nudged)
    chi = [h["chi2"] for h in run.history]
    chi_host = [h["chi2"] for h in host.history[:iterations]]
    rel = [abs(a - b) / abs(b) for a, b in zip(chi, chi_host)]
    print(f"[order-witness] unsharded from phase 7's parameters + 1 ulp: "
          f"initial_chi2={run.initial_chi2!r} chi2={chi} accepted="
          f"{[h['accepted'] for h in run.history]} (phase 7: {chi_host}); "
          f"rel diff per iteration={[f'{x:.3e}' for x in rel]}")


def collective_timer(owner, attr, tensor_arg):
    """Wraps the collective ``owner.<attr>`` (K8's ``Transport._call``, or
    ``torch.distributed.all_reduce`` under the plain transport) with CUDA
    events on the current stream: ``ms()`` the total since the last
    ``reset()``, ``calls`` and ``bytes`` (of positional argument
    ``tensor_arg``); ``restore()`` puts the collective back."""
    import torch

    inner = getattr(owner, attr)

    class Timer:
        def __init__(self):
            self.reset()

        def reset(self):
            self.events, self.calls, self.bytes = [], 0, 0

        def ms(self):
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in self.events)

        def restore(self):
            setattr(owner, attr, inner)

    timer = Timer()

    def timed_call(*args, **kwargs):
        tensor = args[tensor_arg]
        timer.calls += 1
        timer.bytes += tensor.numel() * tensor.element_size()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(*args, **kwargs)
        b.record()
        timer.events.append((a, b))
        return out

    setattr(owner, attr, timed_call)
    return timer


@contextlib.contextmanager
def plain_transport():
    """Every ``Mesh`` collective on K8's plain version (the zeroed
    buffer's ``all_reduce`` over the mesh's group, gloo here, and the rows
    added in rank order), swapped in for an oracle run."""
    from graphite_tpu_torch.ops.cuda import allreduce as k8
    from graphite_tpu_torch.parallel.sharding import Mesh

    kept = Mesh.allreduce, Mesh.gather
    Mesh.allreduce = lambda self, x, tag="": k8.allreduce_plain(
        x, self.rank, self.world, self.group)
    Mesh.gather = lambda self, x, tag="": k8.gather_plain(
        x, self.rank, self.world, self.group)
    try:
        yield
    finally:
        Mesh.allreduce, Mesh.gather = kept


def timed_lm(mesh, problem, solver, iterations, timer):
    """``sharded_lm``'s host loop, timed: (its outputs, host ms, device ms
    of the rank's stream, the collectives' ms, calls and MB)."""
    import torch

    from graphite_tpu_torch.parallel import sharded_lm

    timer.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run = sharded_lm(problem, mesh, solver, lm_options(iterations),
                     with_trace=True)
    end.record()
    torch.cuda.synchronize()
    return run, dict(ms=1e3 * (time.perf_counter() - t0),
                     device_ms=start.elapsed_time(end),
                     collective_ms=timer.ms(), collective_calls=timer.calls,
                     collective_mb=timer.bytes / 1e6)


def same_run(a, b):
    """Two ``sharded_lm`` outputs with trace bitwise equal."""
    import torch

    return torch.equal(a[4], b[4]) and same_params(a[0], b[0])


def shard_venice_host(mesh, venice, iterations, initial_chi2):
    """S2 on one rank (see ``phase_shard``); also the shapes of its
    collectives, for K8's phase."""
    import torch
    import torch.distributed as dist

    from graphite_tpu_torch import schur
    from graphite_tpu_torch.ops.cuda import allreduce as k8
    from graphite_tpu_torch.ops.cuda import segsum_stream
    from graphite_tpu_torch.parallel import sharded_lm
    from graphite_tpu_torch.solvers import PCGSchurSolver

    out = dict(rank=mesh.rank)
    solver = Recorded(PCGSchurSolver(10, 1.0, 5.0))
    slices, calls = [], []
    kernel, k8_call = schur.streaming_segment_product_sum, k8.Transport._call

    def kept(*args):  # the rank's first K3 call: its own inputs
        if not slices:
            slices.append(args)
        return kernel(*args)

    def logged(self, x, gather, tag, stats):
        calls.append((tuple(x.shape), gather, tag))
        return k8_call(self, x, gather, tag, stats)

    torch.cuda.reset_peak_memory_stats()
    schur.streaming_segment_product_sum = kept
    k8.Transport._call = logged
    try:
        t0 = time.perf_counter()
        first, launches, kernel_ms = count_launches(
            lambda: sharded_lm(venice, mesh, solver, lm_options(iterations),
                               with_trace=True))
        out["first_s"] = time.perf_counter() - t0
    finally:
        schur.streaming_segment_product_sum = kernel
        k8.Transport._call = k8_call
    out["calls"] = calls
    out["kernel_ms"] = sum(kernel_ms.values())
    states = solver.states[:iterations]
    timer = collective_timer(k8.Transport, "_call", 1)
    try:
        second, out["k8"] = timed_lm(mesh, venice, solver.solver, iterations,
                                     timer)
    finally:
        timer.restore()
    timer = collective_timer(dist, "all_reduce", 0)
    try:
        with plain_transport():
            plain, out["gloo"] = timed_lm(mesh, venice, solver.solver,
                                          iterations, timer)
    finally:
        timer.restore()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["launches"] = launches
    out["trace"] = first[4].tolist()
    out["params"] = {n: v.cpu().numpy() for n, v in first[0].items()}
    out["repeat_bitwise"] = same_run(first, second)
    out["plain_bitwise"] = same_run(first, plain)
    del second, plain
    if mesh.rank == 0:
        Wg, Rg, plan, m, kk, n = slices[0]
        cplan = segsum_stream.plan_products(
            plan.segments.seg.cpu().numpy(), plan.num_segments, "cpu")
        cWg, cRg = Wg.cpu(), Rg.cpu()
        label = (f"rank 0 of 2: {plan.rows}x({m},{kk},{n})->"
                 f"{plan.num_segments}, segments by lanes "
                 f"{product_lanes_label(plan)}, gathered streams")
        card_plain = segsum_stream.segment_product_sum_plain(
            Wg, Rg, plan, m, kk, n)
        out["k3_vs_card_plain_bitwise"] = torch.equal(
            segsum_stream.streaming_segment_product_sum(Wg, Rg, plan, m, kk,
                                                        n), card_plain)
        del card_plain
        out["k3"] = measure(
            "shard-k3", label,
            lambda: segsum_stream.streaming_segment_product_sum(
                Wg, Rg, plan, m, kk, n),
            lambda: segsum_stream.segment_product_sum_plain(
                Wg, Rg, plan, m, kk, n),
            lambda: segsum_stream.segment_product_sum_plain(
                cWg, cRg, cplan, m, kk, n), 5, 2,
            bound(nbytes(Wg, Rg, plan.segments.offsets_i32)
                  + 4 * plan.num_segments * m * n,
                  2 * plan.rows * m * kk * n))
        del cWg, cRg, Wg, Rg
        slices.clear()
        torch.cuda.empty_cache()
        # the unsharded step from each state of the sharded run
        chi_before = [initial_chi2] + [t[0] for t in out["trace"][:-1]]
        run = types.SimpleNamespace(history=[
            dict(chi2_before=c, chi2=t[0], accepted=bool(t[3]))
            for c, t in zip(chi_before, out["trace"])])
        compare_lockstep("shard-venice-w2 lockstep", run, states,
                         venice.to(mesh.device), solver.solver)
    del slices, states, first
    torch.cuda.empty_cache()
    # rank 0's extra work is done: K8's waits are for collectives only
    dist.barrier()
    return out


def k8_input(rank, shape, dtype, device):
    """A rank's seeded input to K8: normal values, every 7th -0.0 (which
    the plain version's zeroed buffer turns into +0.0)."""
    import numpy as np

    import torch

    g = np.random.default_rng([7, rank])
    v = g.standard_normal(int(np.prod(shape)))
    v[::7] = -0.0
    return torch.as_tensor(v, dtype=dtype).reshape(shape).to(device)


def bits(t):
    """A float tensor's bits, as integers."""
    import torch

    return t.view({torch.float32: torch.int32,
                   torch.float64: torch.int64}[t.dtype])


def graph_ms(fn, reps):
    """Device ms of one ``fn()`` (a K8 call): ``reps`` calls captured in
    one CUDA graph and replayed once, CUDA events around the replay, after
    an eager call (every rank runs the same calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def k8_cases(mesh, cases, reps, plain_reps, timing=True):
    """K8 on this rank against its plain version (``allreduce_plain`` /
    ``gather_plain``: gloo on the same CUDA tensors) for each (shape,
    gather, dtype) of ``cases``: bitwise, and a second call bitwise the
    first; with ``timing``, K8's ms (``graph_ms``), the plain version's,
    gloo's one ``all_reduce`` / ``all_gather`` (``library_ms``) and the
    bound: x read, the own half written, ``world`` halves read and the
    output written (world + 3 copies of x for the sum, 2 world + 2 for
    the gather), the adds of each row to +0 and of the rows."""
    import torch
    import torch.distributed as dist

    from graphite_tpu_torch.ops.cuda import allreduce as k8

    xs = [(shape, gather, k8_input(mesh.rank, shape, dtype, mesh.device))
          for shape, gather, dtype in cases]
    # every case once, the largest first: the arena takes its largest
    # size before any capture
    for _, gather, x in sorted(xs, key=lambda c: -c[2].numel()
                               * c[2].element_size()):
        (mesh.gather if gather else mesh.allreduce)(x, "k8 phase")
    w = mesh.world
    records = []
    for shape, gather, x in xs:
        def k8_call(x=x, gather=gather):
            return (mesh.gather if gather else mesh.allreduce)(x, "k8 phase")

        def plain(x=x, gather=gather):
            return (k8.gather_plain if gather else k8.allreduce_plain)(
                x, mesh.rank, w, mesh.group)

        got, again, ref = k8_call(), k8_call(), plain()
        torch.cuda.synchronize()
        bitwise = torch.equal(bits(got), bits(ref))
        repeat = torch.equal(bits(got), bits(again))
        err = (float((got.double() - ref.double()).abs().max())
               if got.numel() else 0.0)
        del got, again, ref
        label = (f"{tuple(shape)} {str(x.dtype).split('.')[-1]} "
                 f"{'gather' if gather else 'sum'}, {w} ranks")
        check(bitwise and repeat, f"k8 rank {mesh.rank}: {label}: bitwise "
              f"vs the plain version {bitwise}, repeat {repeat}")
        rec = dict(shape=label, gather=gather, err=err, bitwise=bitwise,
                   repeat=repeat)
        if timing:
            if gather:
                outs = [torch.empty_like(x) for _ in range(w)]

                def library(x=x, outs=outs):
                    dist.all_gather(outs, x)
            else:
                def library(x=x):
                    dist.all_reduce(x.clone())

            size = x.numel() * x.element_size()
            rate = (FP64_VECTOR_OPS_PER_S if x.dtype == torch.float64
                    else FP32_OPS_PER_S)
            rec.update(
                ms=graph_ms(k8_call, reps),
                plain_ms=device_ms(plain, plain_reps),
                library_ms=device_ms(library, plain_reps),
                **bound(((2 * w + 2) if gather else (w + 3)) * size,
                        (w if gather else 2 * w - 1) * x.numel(), rate))
        records.append(rec)
    mesh.check("the K8 phase")
    return records


def k8_phase(mesh, calls):
    """K8 at the sizes of S2's collectives (each distinct shape, sum or
    gather), in float32 and float64."""
    import numpy as np

    import torch

    sizes = sorted({(shape, gather) for shape, gather, _ in calls},
                   key=lambda c: (-int(np.prod(c[0])), c))
    cases = [(shape, gather, dtype) for shape, gather in sizes
             for dtype in (torch.float32, torch.float64)]
    return k8_cases(mesh, cases, reps=5, plain_reps=2)


# K8 at 4 ranks: small shapes (shape, gather, dtype)
K8_W4_CASES = [((1,), False, "float64"), ((1000,), False, "float32"),
               ((123457,), False, "float32"), ((123457,), False, "float64"),
               ((3, 4097), True, "float32"), ((3, 4097), True, "float64")]


def k8_w4_rank(mesh):
    """One of 4 ranks on cuda:0: K8 bitwise its plain version at small
    shapes, rank order beyond two."""
    import torch

    return k8_cases(mesh, [(s, g, getattr(torch, d))
                           for s, g, d in K8_W4_CASES],
                    reps=0, plain_reps=0, timing=False)


def graph_record(tag, loop, trace, iterations):
    """A rank's captured run, for the parent's print: replay ms accepted
    and rejected (the last run), the regions' runs, K8's launches at the
    top level and in the regions, capture seconds, pool, peak; checks the
    step / branch regions' runs against the trace."""
    import torch

    accepted = [bool(t[3]) for t in trace[:iterations]]
    ms = loop.replay_ms
    runs = loop.capture.region_runs()
    k8_names = ("allreduce.allreduce", "allreduce.gather")
    top = sum(loop.capture.top_launches.get(n, 0) for n in k8_names)
    launches = graph_launches(loop)
    total = sum(launches.get(n, 0) for n in k8_names)
    in_while = sum(int(r.runs) * sum(r.launches.get(n, 0) for n in k8_names)
                   for r in loop.capture.regions if r.name == "cg_step")
    check(runs.get("lm_run") == runs.get("lm_iteration")
          == runs.get("lm_update") == iterations,
          f"{tag}: the iteration, step and update regions ran {runs}")
    check(runs.get("lm_accept") == sum(accepted)
          and runs.get("lm_reject") == iterations - sum(accepted),
          f"{tag}: the accept / reject regions ran {runs}")
    check(loop.capture.host_calls == 0,
          f"{tag}: the replays hold a host call")
    return dict(
        accepted_ms=[m for m, a in zip(ms, accepted) if a],
        rejected_ms=[m for m, a in zip(ms, accepted) if not a],
        runs=runs, k8_top=top * loop.replays, k8_regions=total - top *
        loop.replays, k8_in_while=in_while, cg_steps=runs.get("cg_step"),
        capture_s=loop.capture_seconds, pool_mib=loop.pool_bytes / 2**20,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=launches)


def shard_graph(tag, mesh, problem, solver, iterations):
    """``sharded_lm`` on this rank, host loop then ``jit_loop`` from the
    same start (every K8 call inside the captured iteration, its regions
    and the CG loop's "while" node); the replays run under sync-debug mode
    "error", so a host sync there raises. Returns both runs' traces and
    parameters, the comparison and ``graph_record``; the loop is freed."""
    import dataclasses

    import torch

    from graphite_tpu_torch.optimizers.lm import cached_device_loop
    from graphite_tpu_torch.parallel import sharded_lm
    from graphite_tpu_torch.parallel.sharding import _replica

    t0 = time.perf_counter()
    host = sharded_lm(problem, mesh, solver, lm_options(iterations),
                      with_trace=True)
    host_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    opts = dataclasses.replace(lm_options(iterations), jit_loop=True)
    t0 = time.perf_counter()
    graph = sharded_lm(problem, mesh, solver, opts, with_trace=True)
    graph_s = time.perf_counter() - t0
    replica = _replica(problem, mesh)
    loop = cached_device_loop(replica, solver, opts)
    check(loop is not None and loop.capture is not None,
          f"{tag}: no captured graph")
    rec = graph_record(tag, loop, graph[4].tolist(), graph[2])
    drop_loop(replica, loop)
    del loop
    torch.cuda.empty_cache()
    return dict(rec, trace=graph[4].tolist(), host_trace=host[4].tolist(),
                params={n: v.cpu().numpy() for n, v in graph[0].items()},
                bitwise_host=same_run(graph, host), host_s=host_s,
                graph_s=graph_s, iterations=graph[2])


def shard_ladybug_forced(mesh, ladybug):
    """S3 on one rank: Ladybug-49 with the Venice branches forced, on the
    card (K8) and on the CPU (the plain version) over the same group,
    host loop and ``jit_loop``."""
    import dataclasses

    import torch

    from graphite_tpu_torch import schur
    from graphite_tpu_torch.parallel import sharded_lm
    from graphite_tpu_torch.solvers import PCGSchurSolver

    gates = schur.CHUNK_THRESHOLD, schur._smv_chunk_rows
    schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = 0, (lambda rb: 0)
    forced = PCGSchurSolver(10, 1.0, 5.0, dense_matvec_limit=0)
    runs = {}
    try:
        for where, m in (("cuda", mesh),
                         ("cpu", dataclasses.replace(
                             mesh, device=torch.device("cpu")))):
            for jit in (False, True):
                opts = dataclasses.replace(lm_options(10), jit_loop=jit)
                (p, c, kl, a, tr), lau, _ = count_launches(
                    lambda m=m, opts=opts: sharded_lm(
                        ladybug, m, forced, opts, with_trace=True),
                    record_events=False)
                runs[where, jit] = dict(
                    trace=tr.tolist(), launches=lau,
                    params={n: v.cpu() for n, v in p.items()})
    finally:
        schur.CHUNK_THRESHOLD, schur._smv_chunk_rows = gates
    card = runs["cuda", False]
    return dict(
        trace=card["trace"], cpu_trace=runs["cpu", False]["trace"],
        graph_trace=runs["cuda", True]["trace"],
        cpu_graph_trace=runs["cpu", True]["trace"],
        launches=card["launches"],
        params_bitwise=all(same_params(card["params"], r["params"])
                           for r in runs.values()))


def shard_rank(mesh, venice, ladybug, sphere, iterations, graph_iterations,
               pose_iterations, initial_chi2):
    """One rank of S2-S5 (spawned by ``phase_shard``; two ranks in two
    processes on cuda:0, every collective a K8 launch): S2, K8's phase at
    S2's sizes, S4, S3 and S5, in that order."""
    from graphite_tpu_torch.preconditioners import BlockJacobiPreconditioner
    from graphite_tpu_torch.solvers import PCGSchurSolver, PCGSolver

    out = shard_venice_host(mesh, venice, iterations, initial_chi2)
    out["k8_phase"] = k8_phase(mesh, out.pop("calls"))
    out["s4"] = shard_graph("shard-venice-w2-graph", mesh, venice,
                            PCGSchurSolver(10, 1.0, 5.0), graph_iterations)
    out["ladybug"] = shard_ladybug_forced(mesh, ladybug)
    out["s5"] = shard_graph(
        "shard-sphere2500-w2-graph", mesh, sphere,
        PCGSolver(50, 1e-10, 1e6, BlockJacobiPreconditioner()),
        pose_iterations)
    return out


def print_k8(tag, records):
    for r in records:
        print(f"[{tag}] {r['shape']} ({card_label()}): bitwise_vs_plain="
              f"{r['bitwise']} bitwise_repeat={r['repeat']} ms={r['ms']:.4f} "
              f"plain_ms (gloo, zeroed buffer + rank-order adds)="
              f"{r['plain_ms']:.4f} library_ms (gloo's one call)="
              f"{r['library_ms']:.4f} bound_ms={bound_fields(r)}")


def print_graph(tag, r, host_iterations_s):
    print(f"[{tag}] ({card_label()}) bitwise_equal_to_host_loop="
          f"{r['bitwise_host']} iterations={r['iterations']} accepted="
          f"{[bool(t[3]) for t in r['trace'][:r['iterations']]]}; replay ms "
          f"accepted median={median_or_none(r['accepted_ms'])} (n="
          f"{len(r['accepted_ms'])}) rejected median="
          f"{median_or_none(r['rejected_ms'])} (n={len(r['rejected_ms'])}); "
          f"K8 launches top level {r['k8_top']} + region runs "
          f"{r['k8_regions']} (in the CG \"while\" node {r['k8_in_while']}, "
          f"CG steps run {r['cg_steps']}); capture seconds="
          f"{r['capture_s']:.3f}; no host sync in the replays (sync-debug "
          f"mode \"error\", no host call); graph pool="
          f"{r['pool_mib']:.1f} MiB; peak "
          f"{r['peak_gib']:.3f} GiB; host loop {host_iterations_s:.3f} s, "
          f"jit_loop call {r['graph_s']:.3f} s (warm-up, capture and "
          "replays); two processes time-sliced on one card: not scaling")


def phase_shard(cpu_problem, host, iterations):
    """S2-S5 on two ranks in two processes on cuda:0 (every collective a
    K8 launch; NCCL refuses two ranks on one card), then K8 at four ranks.
    The ranks take the frozen Venice problem, its host structures included,
    from this process: no ``make_bal``, freeze or structure is built again.
    Returns the ranks' launches (summed) of every path and the measured
    records of K3 and K8."""
    import numpy as np

    import torch

    from graphite_tpu_torch.parallel import run_ranks

    tag = "shard-venice-w2"
    venice = cpu_problem.to("cpu")  # its host structures, no plans
    for name, fm in venice.factor_meta.items():
        check(fm.count % 2 == 0, f"{tag}: {name} has an odd factor count")
    ladybug = ladybug_problem("cpu", pad_factors_to=2)
    sphere = pose_problem("cpu", pad_factors_to=2)
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, 2, "gloo", venice, ladybug, sphere,
                      iterations, 10, 30, host.initial_chi2,
                      device=torch.device("cuda", 0))
    seconds = time.perf_counter() - t0
    print(f"[{tag}] 2 ranks (gloo for set-up, K8 for every collective, on "
          f"cuda:0; the ranks load the frozen problem from this process): "
          f"S2-S5 {seconds:.1f} s")
    r0, r1 = ranks
    acc_host = [h["accepted"] for h in host.history[:iterations]]
    chi_host = [h["chi2"] for h in host.history[:iterations]]
    host_ms = sum(h["device_ms"] for h in host.history[:iterations])
    for r in ranks:
        chi = [t[0] for t in r["trace"]]
        acc = [bool(t[3]) for t in r["trace"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(chi, chi_host)]
        print(f"[{tag}] rank {r['rank']}: chi2={chi} accepted={acc} (phase "
              f"7: {chi_host} {acc_host}); rel diff per iteration="
              f"{[f'{x:.3e}' for x in rel]}; first run {r['first_s']:.1f} s "
              f"with its plans; peak device memory {r['peak_gib']:.3f} GiB; "
              f"second run bitwise the first {r['repeat_bitwise']}; the "
              f"plain transport's run bitwise the first {r['plain_bitwise']}")
        for name, t in (("K8", r["k8"]), ("gloo (plain version)", r["gloo"])):
            print(f"[{tag}] rank {r['rank']} on {name} ({card_label()}): "
                  f"{t['ms'] / iterations:.3f} ms per iteration (host clock),"
                  f" collectives {t['collective_ms'] / iterations:.3f} ms per "
                  f"iteration ({t['collective_ms'] / t['ms']:.1%}; "
                  f"{t['collective_calls']} calls, {t['collective_mb']:.1f} "
                  f"MB); device (CUDA events on the rank's stream) "
                  f"{t['device_ms'] / iterations:.3f} ms per iteration, "
                  f"outside the collectives "
                  f"{(t['device_ms'] - t['collective_ms']) / iterations:.3f} "
                  f"(phase 7, unsharded: {host_ms / iterations:.3f}; before "
                  f"K8, on gloo: 1685.8 ms per iteration, 1599.1 in the "
                  f"collectives, PERF.md)")
        check(acc == acc_host, f"{tag}: accept pattern differs from phase 7")
        check(r["repeat_bitwise"], f"{tag}: two runs differ")
        check(r["plain_bitwise"],
              f"{tag}: K8's run differs from the plain transport's")
        lau = r["launches"]
        check(lau["segsum_stream.streaming_segment_product_sum"]
              == iterations, f"{tag}: K3's gathered-stream entry must run "
              f"once per rank per iteration")
        check(lau["segsum_stream.streaming_segment_product_sum_rtbl"] == 0,
              f"{tag}: the unsharded product stage ran")
        check(lau["segsum_stream.streaming_segment_sum"] > 0,
              f"{tag}: K1 never launched")
        check(lau["allreduce.allreduce"] > 0 and lau["allreduce.gather"] > 0,
              f"{tag}: K8 never launched")
        check_k7(f"{tag} rank {r['rank']}", lau)
        check_k10(f"{tag} rank {r['rank']}", lau, iterations)
        check_k12(f"{tag} rank {r['rank']}", lau, iterations)
    print(f"[{tag}] two processes share one card, time-sliced: K8's times "
          f"measure that, not scaling")
    check(r0["trace"] == r1["trace"], f"{tag}: the ranks' traces differ")
    check(all(np.array_equal(r0["params"][n], r1["params"][n])
              for n in r0["params"]), f"{tag}: the ranks' parameters differ")
    print(f"[{tag}] the two ranks' traces and parameters bitwise equal; "
          f"K3 gathered vs its plain version on the card bitwise "
          f"{r0['k3_vs_card_plain_bitwise']}")
    launches = {n: r0["launches"][n] + r1["launches"][n]
                for n in r0["launches"]}
    print(f"[{tag}] launches (both ranks) "
          f"{ {n: c for n, c in launches.items() if c} }")

    print_k8("k8", r0["k8_phase"])
    print(f"[k8] rank 1: every case bitwise its plain version and repeatable "
          f"({len(r1['k8_phase'])} cases)")

    results = {}
    for tag, key in (("shard-venice-w2-graph", "s4"),
                     ("shard-sphere2500-w2-graph", "s5")):
        for r in ranks:
            print_graph(f"{tag} rank {r['rank']}", r[key], r[key]["host_s"])
            check(r[key]["bitwise_host"],
                  f"{tag}: rank {r['rank']}'s jit_loop run is not its host "
                  "loop's bit for bit")
            check(r[key]["k8_top"] + r[key]["k8_regions"] > 0,
                  f"{tag}: K8 never ran in the graph")
            if key == "s5":
                check_k11(f"{tag} rank {r['rank']}", r[key]["launches"])
            if key == "s4":
                check_k7(f"{tag} rank {r['rank']}", r[key]["launches"])
                check_k10(f"{tag} rank {r['rank']}", r[key]["launches"],
                          k3_calls(r[key]["launches"]))
                check_k12(f"{tag} rank {r['rank']}", r[key]["launches"],
                          k3_calls(r[key]["launches"]))
        check(r0[key]["trace"] == r1[key]["trace"]
              and all(np.array_equal(r0[key]["params"][n],
                                     r1[key]["params"][n])
                      for n in r0[key]["params"]),
              f"{tag}: the ranks differ")
        results[tag] = {n: r0[key]["launches"].get(n, 0)
                        + r1[key]["launches"].get(n, 0) for n in launches}
    check(r0["s5"]["k8_in_while"] == r0["s5"]["cg_steps"] > 0,
          "shard-sphere2500-w2-graph: K8 must run once in each CG step of "
          "the \"while\" node")
    check(r0["s4"]["trace"][:iterations] == r0["trace"],
          "shard-venice-w2-graph: its first iterations are not S2's")

    tag = "shard-ladybug-w2"
    for r in ranks:
        lb = r["ladybug"]
        chi, cchi = [t[0] for t in lb["trace"]], [t[0] for t in lb["cpu_trace"]]
        acc = [bool(t[3]) for t in lb["trace"]]
        cacc = [bool(t[3]) for t in lb["cpu_trace"]]
        print(f"[{tag}] rank {r['rank']}: cuda chi2={chi} accepted={acc}; "
              f"cpu chi2={cchi} accepted={cacc}; bitwise "
              f"{chi == cchi and acc == cacc}; jit_loop card (K8) and CPU "
              f"(the plain version) bitwise the host loops "
              f"{lb['graph_trace'] == lb['cpu_graph_trace'] == lb['trace']}, "
              f"parameters of all four bitwise {lb['params_bitwise']}")
        check(acc == cacc and chi == cchi,
              f"{tag}: card and CPU trajectories differ")
        check(lb["graph_trace"] == lb["cpu_graph_trace"] == lb["trace"],
              f"{tag}: the jit_loop runs differ")
        check(lb["params_bitwise"], f"{tag}: card and CPU parameters differ")
        check(lb["launches"]["segsum_stream.streaming_segment_product_sum"]
              > 0, f"{tag}: K3's gathered-stream entry never launched")
        check_k10(f"{tag} rank {r['rank']}", lb["launches"],
                  k3_calls(lb["launches"]))
        check_k12(f"{tag} rank {r['rank']}", lb["launches"],
                  k3_calls(lb["launches"]))
        check(chi[-1] < chi[0], f"{tag}: chi2 not lowered")
    check(r0["ladybug"]["trace"] == r1["ladybug"]["trace"],
          f"{tag}: the ranks' traces differ")
    lady = {n: r0["ladybug"]["launches"][n] + r1["ladybug"]["launches"][n]
            for n in launches}
    print(f"[{tag}] launches (both ranks, the card's host loop) "
          f"{ {n: c for n, c in lady.items() if c} }")

    t0 = time.perf_counter()
    w4 = run_ranks(k8_w4_rank, 4, "gloo", device=torch.device("cuda", 0))
    print(f"[k8-w4] 4 ranks on cuda:0, {len(w4[0])} cases "
          f"{[r['shape'] for r in w4[0]]}: every rank bitwise the plain "
          f"version and repeatable; {time.perf_counter() - t0:.1f} s")
    k8_records = {"allreduce.allreduce": [], "allreduce.gather": []}
    for r in r0["k8_phase"]:
        k8_records["allreduce.gather" if r["gather"]
                   else "allreduce.allreduce"].append(r)
    return ({"shard-venice-w2": launches, "shard-ladybug-w2": lady,
             **results},
            {"segsum_stream.streaming_segment_product_sum": [r0["k3"]],
             **k8_records})


# (kernel, source, {entry point: TPU kernel body it replaces})
KERNELS = [
    ("K1", "graphite_tpu_torch/csrc/segsum.cu", {
        "segsum.sorted_segment_sum": "graphite_tpu/ops/pallas/segsum.py:70",
        "segsum_stream.streaming_segment_sum":
            "graphite_tpu/ops/pallas/segsum_stream.py:147"}),
    ("K1 float64", "graphite_tpu_torch/csrc/segsum.cu", {
        "segsum.sorted_segment_sum[f64]":
            "graphite_tpu/ops/pallas/segsum.py:70",
        "segsum_stream.streaming_segment_sum[f64]":
            "graphite_tpu/ops/pallas/segsum_stream.py:147"}),
    ("K2", "graphite_tpu_torch/csrc/pcg_dense.cu", {
        "pcg_dense.dense_pcg": "graphite_tpu/ops/pallas/pcg_dense.py:35"}),
    ("K3", "graphite_tpu_torch/csrc/segprod.cu", {
        "segsum_stream.streaming_segment_product_sum":
            "graphite_tpu/ops/pallas/segsum_stream.py:327",
        "segsum_stream.streaming_segment_product_sum_rtbl":
            "graphite_tpu/ops/pallas/segsum_stream.py:489"}),
    ("K4", "graphite_tpu_torch/csrc/segmv.cu", {
        "segsum_stream.streaming_matvec_tbl":
            "graphite_tpu/ops/pallas/segsum_stream.py:639",
        "segmv.block_matvec_wtbl": "graphite_tpu/ops/pallas/segmv.py:425",
        "segmv.block_matvec_stream": "graphite_tpu/ops/pallas/segmv.py:176"}),
    ("K5", "graphite_tpu_torch/csrc/segmv.cu", {
        "segmv.matvec_sym_stream": "graphite_tpu/ops/pallas/segmv.py:303"}),
    # the float64 instances of K3, K4 and K5 (the FP64_FP64 and FP64_BF16
    # Schur values): the same TPU kernels, which take float32 only
    ("K3 float64", "graphite_tpu_torch/csrc/segprod.cu", {
        "segsum_stream.streaming_segment_product_sum[f64]":
            "graphite_tpu/ops/pallas/segsum_stream.py:327",
        "segsum_stream.streaming_segment_product_sum_rtbl[f64]":
            "graphite_tpu/ops/pallas/segsum_stream.py:489"}),
    ("K4 float64", "graphite_tpu_torch/csrc/segmv.cu", {
        "segsum_stream.streaming_matvec_tbl[f64]":
            "graphite_tpu/ops/pallas/segsum_stream.py:639",
        "segmv.block_matvec_wtbl[f64]":
            "graphite_tpu/ops/pallas/segmv.py:425",
        "segmv.block_matvec_stream[f64]":
            "graphite_tpu/ops/pallas/segmv.py:176"}),
    ("K5 float64", "graphite_tpu_torch/csrc/segmv.cu", {
        "segmv.matvec_sym_stream[f64]":
            "graphite_tpu/ops/pallas/segmv.py:303"}),
    ("K6", "graphite_tpu_torch/csrc/pcg_mf.cu", {
        "pcg_mf.solve_pcg_mf": "graphite_tpu/ops/pallas/pcg_mf.py:121"}),
    # the float64 instance of K6 (the FP64 policies' pose graphs): the
    # same TPU kernel, which takes float32 only
    ("K6 float64", "graphite_tpu_torch/csrc/pcg_mf.cu", {
        "pcg_mf.solve_pcg_mf[f64]": "graphite_tpu/ops/pallas/pcg_mf.py:121"}),
    # no pl.pallas_call: XLA's fusion of the JAX package's plain jnp code
    # for the BAL residual and Jacobian, linearize and the Hessian values
    ("K7", "graphite_tpu_torch/csrc/bal.cu", {
        "bal.bal_residual": "none (XLA fusion: graphite_tpu/models/bal.py:37,"
                            " graphite_tpu/linearize.py:259)",
        "bal.bal_linearize": "none (XLA fusion: graphite_tpu/models/bal.py:82,"
                             " graphite_tpu/linearize.py:280)",
        "bal.bal_scale_b": "none (XLA fusion: graphite_tpu/linearize.py:280)",
        "bal.bal_hessian_sum":
            "graphite_tpu/ops/pallas/segsum_stream.py:147 (the Hessian "
            "sums of graphite_tpu/hessian.py:515, :524) and XLA fusion "
            "(graphite_tpu/hessian.py:410)"}),
    # the float64 instances of K7 (the FP64_FP64, FP64_FP32 and FP64_BF16
    # BAL path): the same fusions and the same Pallas kernel, float32 only
    ("K7 float64", "graphite_tpu_torch/csrc/bal.cu", {
        "bal.bal_residual[f64]": "none (the same, float64)",
        "bal.bal_linearize[f64]": "none (the same, float64)",
        "bal.bal_scale_b[f64]": "none (the same, float64)",
        "bal.bal_hessian_sum[f64]":
            "graphite_tpu/ops/pallas/segsum_stream.py:147 (the same sums, "
            "float64 or float32 values) and XLA fusion "
            "(graphite_tpu/hessian.py:410)"}),
    # no pl.pallas_call: the JAX package's collectives inside its sharded
    # program (lax.psum of problem.allreduce, lax.all_gather of the S
    # ranges)
    ("K8", "graphite_tpu_torch/csrc/allreduce.cu", {
        "allreduce.allreduce": "none (lax.psum, graphite_tpu/graph.py:333)",
        "allreduce.gather":
            "none (lax.all_gather, graphite_tpu/schur.py:698)"}),
    # no pl.pallas_call: XLA's reduction of the CG loop's jnp.dot
    ("K9", "graphite_tpu_torch/csrc/dot.cu", {
        "dot.tree_dot": "none (XLA's reduction of jnp.dot, "
                        "graphite_tpu/ops/pcg_loop.py:27)",
        "dot.tree_dot[f64]": "none (the same, float64)"}),
    # no pl.pallas_call: XLA's fusion of the JAX package's plain jnp
    # inverses and W = Hpl Hll^-1
    ("K10", "graphite_tpu_torch/csrc/schur_w.cu", {
        K10: "none (XLA fusion: graphite_tpu/schur.py:499-508, :543-599)"}),
    ("K10 float64", "graphite_tpu_torch/csrc/schur_w.cu", {
        K10 + "[f64]": "none (the same, float64)"}),
    # no pl.pallas_call: XLA's fusion of the JAX package's CG step (one
    # lax.while_loop body) and its block-Jacobi-Schur einsum
    ("K12", "graphite_tpu_torch/csrc/pcg_step.cu", {
        K12_BJS: "none (XLA fusion: graphite_tpu/preconditioners/"
                 "block_jacobi_schur.py:62-74, graphite_tpu/ops/"
                 "pcg_loop.py:19-70)",
        K12_ADVANCE: "none (XLA fusion: graphite_tpu/ops/pcg_loop.py:19-70)",
        K12_COMMIT: "none (XLA fusion: graphite_tpu/ops/pcg_loop.py:19-70)",
        K12_BJS + "[f64]": "none (the same, float64 vectors)",
        K12_ADVANCE + "[f64]": "none (the same, float64)",
        K12_COMMIT + "[f64]": "none (the same, float64)"}),
    # no pl.pallas_call: XLA's fusion of the landmark solve's block mv
    ("K13", "graphite_tpu_torch/csrc/schur_w.cu", {
        K13: "none (XLA fusion: graphite_tpu/schur.py:1595)",
        K13 + "[f64]": "none (the same, float64 inverses)"}),
    # no pl.pallas_call: XLA's fusion of the JAX package's AUTO branch (a
    # vmapped jax.jacfwd per factor type) over the SE3 pose-graph factors,
    # the chi2, scaling and b around it, and apply_update's retraction
    ("K11", "graphite_tpu_torch/csrc/pose.cu", {
        "pose.se3_residual": "none (XLA fusion: graphite_tpu/models/"
                             "pose_graph.py:63, :74, graphite_tpu/"
                             "linearize.py:421)",
        "pose.se3_linearize": "none (XLA fusion of jax.jacfwd: graphite_tpu/"
                              "linearize.py:97-153, :280, graphite_tpu/"
                              "models/lie.py:118-165)",
        "pose.se3_scale_b": "none (XLA fusion: graphite_tpu/linearize.py:280)",
        "pose.se3_update": "none (XLA fusion: graphite_tpu/linearize.py:602, "
                           "graphite_tpu/models/lie.py:157)"}),
    # the float64 instances of K11 (FP64_FP64, FP64_FP32, FP64_BF16)
    ("K11 float64", "graphite_tpu_torch/csrc/pose.cu", {
        e: "none (the same, float64)" for e in K11_ENTRIES_F64}),
]


def summed(records, key):
    """The sum of ``key`` over records, or None if any record lacks it."""
    vals = [r[key] for r in records]
    return None if any(v is None for v in vals) else sum(vals)


def kernels_json(measured, launches_by_path):
    """One entry per kernel: its times summed over the measured shapes of
    all its entry points (one call each), the bound and the library call
    over the same shapes, and its launches on every main path."""
    out = []
    for kernel, source, entries in KERNELS:
        recs = [r for e in entries for r in measured.get(e, [])]
        by_path = {path: sum(launches.get(e, 0) for e in entries)
                   for path, launches in launches_by_path.items()}
        work = dict(bytes_ms=sum(r["bytes_ms"] for r in recs),
                    ops_ms=sum(r["ops_ms"] for r in recs))
        out.append(dict(
            name=kernel + ": " + ", ".join(entries), route="cuda",
            source=source, replaces=", ".join(entries.values()),
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=max(r["err"] for r in recs),
            ms=sum(r["ms"] for r in recs),
            plain_ms=sum(r["plain_ms"] for r in recs),
            bound_ms=sum(bound_fields(r)["bound_ms"] for r in recs),
            bound_by=bound_fields(work)["bound_by"],
            library_ms=summed(recs, "library_ms"),
            entry_points=[dict(
                name=e, replaces=r,
                launches={p: launches.get(e, 0)
                          for p, launches in launches_by_path.items()},
                shapes=[m["shape"] for m in measured[e]],
                ms_by_shape=[m["ms"] for m in measured[e]],
                plain_ms_by_shape=[m["plain_ms"] for m in measured[e]],
                bound_ms_by_shape=[bound_fields(m)["bound_ms"]
                                   for m in measured[e]],
                library_ms_by_shape=[m["library_ms"] for m in measured[e]])
                for e, r in entries.items() if e in measured]))
    return out


def timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[{name}] phase seconds={time.perf_counter() - t0:.1f}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from graphite_tpu_torch.solvers import PCGSchurSolver

    t_start = time.perf_counter()
    print(f"[env] python={sys.version.split()[0]} torch={torch.__version__} "
          f"cuda={torch.version.cuda} device={torch.cuda.get_device_name(0)}")
    solver = PCGSchurSolver(max_iter=10, tol=1.0, rejection_ratio=5.0)
    timed("build", phase_build)
    k1 = timed("k1", phase_k1, DEVICE)
    k2 = timed("k2", phase_k2, DEVICE, solver, 1e-4)
    ladybug_launches = timed("slice", phase_slice, solver, 10)
    k6 = timed("k6", phase_k6)
    pose_launches, pose, pose_host = timed("sphere2500", phase_pose, 30)
    pose_k1 = timed("sphere2500-k1", phase_k1_sites, pose, "sphere2500", 4)
    k11 = timed("k11", phase_k11, pose)
    timed("cond", phase_cond, pose)
    pose_graph_launches = timed("jit-sphere2500", phase_jit_pose, pose, 30,
                                pose_host)
    sphere_n = pose.dim_h
    del pose
    generic_launches = timed("sphere2500-generic", phase_pose_generic, 10)

    host_setup = timed("host-setup", phase_host_setup)
    ds, problem, lin, hv, sv, ops, host_setup["venice-1778"] = timed(
        "venice-setup", phase_venice_setup)
    venice_measured = timed("venice-kernels", phase_venice_kernels, problem,
                            lin, hv, sv, ops)
    venice_dim_p = ops.ss.dim_p
    del sv
    torch.cuda.empty_cache()
    k7 = timed("k7", phase_k7, problem, lin)
    k9 = timed("k9", phase_k9, [
        ("Venice dim_p", venice_dim_p, torch.float32),
        ("Venice dim_p", venice_dim_p, torch.float64),
        ("sphere2500 n d", sphere_n, torch.float32)])
    k10 = timed("k10", phase_k10, problem, ops.ss, hv)
    del hv, ops
    solve_calls = timed("venice-solve", record_venice_solve, problem, lin,
                        solver)
    k12 = timed("k12", phase_k12, solve_calls)
    k13 = timed("k13", phase_k13, solve_calls)
    del solve_calls
    del lin
    torch.cuda.empty_cache()
    k1_f64 = timed("k1-f64", phase_k1_f64, problem)
    gpu, venice_launches, venice_peak, branch_ms = timed(
        "venice", phase_venice_slice, problem, solver, 10)
    shard_w1_launches = timed("shard-venice-w1", phase_shard_w1, problem,
                              solver, 10, gpu)
    venice_graph_launches = timed("jit-venice", phase_jit_venice, problem,
                                  solver, 10, gpu, branch_ms)
    first_order_venice, first_order_short = timed(
        "first-order-venice", phase_first_order_venice, problem, 10, 2)
    covariance_venice = timed("covariance-venice", phase_covariance_venice,
                              problem)
    torch.cuda.empty_cache()
    direct_gpu, direct_venice_launches, venice_first = timed(
        "direct-venice", phase_direct_venice, problem, 10)
    cpu_problem = problem.to("cpu")
    del problem
    torch.cuda.empty_cache()
    timed("venice-cpu", phase_venice_cpu, cpu_problem, gpu, solver, 2,
          direct_gpu, 2)
    timed("first-order-venice-cpu", phase_first_order_venice_cpu,
          cpu_problem, first_order_short, 2)
    shard_launches, shard_measured = timed(
        "shard-w2", phase_shard, cpu_problem, gpu, 3)
    structures = dict(cpu_problem.to("cpu")._cache, topology=(
        cpu_problem.block_offsets, dict(cpu_problem.host.factor_ids)))
    del cpu_problem
    precision_venice = timed("precision-venice", phase_precision_venice, ds,
                             solver, 10,
                             (gpu, venice_peak, venice_launches), structures)
    del ds, structures
    timed("forced", phase_forced, 10)
    direct_ladybug_launches, ladybug_firsts = timed(
        "direct-ladybug", phase_direct_ladybug, 10)
    full_h_launches, full_h_firsts = timed("direct-full-h",
                                           phase_direct_full_h, 3)
    sphere_direct_launches, sphere_firsts, nd_k1 = timed(
        "direct-sphere2500", phase_direct_sphere, 6)
    cli_launches = timed("cli", phase_cli)
    ladybug_graph_launches = timed("jit-ladybug", phase_jit_ladybug, 10)
    remask_launches = timed("remask", phase_remask, 10)
    cli_jit_launches = timed("cli-jit", phase_jit_cli)
    precision_ladybug = timed("precision-ladybug", phase_precision_ladybug,
                              10)
    precision_pose = timed("precision-sphere2500", phase_precision_pose)
    first_order_ladybug = timed("first-order-ladybug",
                                phase_first_order_ladybug, 30)
    covariance_ladybug = timed("covariance-ladybug", phase_covariance_ladybug)
    range_bearing = timed("range-bearing", phase_range_bearing)

    firsts = {**{f"ladybug {k}": v for k, v in ladybug_firsts.items()},
              **{f"ladybug full H {k}": v for k, v in full_h_firsts.items()},
              **{f"sphere2500 {k}": v for k, v in sphere_firsts.items()},
              "venice sparse-schur": venice_first}
    print(json.dumps({"direct_factorizations": firsts}))
    print(json.dumps({"host_setup_seconds_native_numpy": host_setup}))
    measured = merge_measured(k1, k2, k6, pose_k1, venice_measured, nd_k1,
                              k1_f64, shard_measured, k7, k9, k10, k11,
                              k12, k13)
    print(json.dumps({"kernels": kernels_json(
        measured, {"ladybug-49": ladybug_launches,
                   "sphere2500": pose_launches,
                   "sphere2500-generic": generic_launches,
                   "venice-1778": venice_launches,
                   "shard-venice-w1": shard_w1_launches,
                   **shard_launches,
                   "direct-ladybug": direct_ladybug_launches,
                   "direct-full-h": full_h_launches,
                   "direct-sphere2500": sphere_direct_launches,
                   "direct-venice": direct_venice_launches,
                   "cli": cli_launches,
                   "ladybug-49-graph": ladybug_graph_launches,
                   "venice-1778-graph": venice_graph_launches,
                   "sphere2500-graph": pose_graph_launches,
                   "remask-graph": remask_launches,
                   "cli-jit": cli_jit_launches, **precision_ladybug,
                   **precision_pose, **precision_venice,
                   "first-order-ladybug-graph": first_order_ladybug,
                   "first-order-venice-graph": first_order_venice,
                   "covariance-ladybug": covariance_ladybug,
                   "covariance-venice": covariance_venice,
                   "range-bearing": range_bearing})}))
    print(f"[done] total seconds={time.perf_counter() - t_start:.1f}")

    print(card_label())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
