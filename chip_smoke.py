"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. identify the card (there is no CPU path: no CUDA device is an error);
2. build the CUDA kernels from ``proxtpu_torch/csrc`` (first use), then
   start block 12 of ``docs/tpu_scaling.md`` (two Gloo processes, see 18)
   beside the checks of 3, and wait for it before the first timing;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes the driven paths give it and a ragged one (``fb_step`` and
   ``fista_step`` at every branch of their launch plan: a ring filled by the
   bulk copy or by ordinary loads, one stage that holds the lane, the lane
   read in place; ``fista_k_steps`` at every branch of its own: 1, 2, 4 and
   8 thread blocks per lane, stages filled by the bulk copy or by ordinary
   loads, tiles read in place; ``pg_step`` and ``pg_k_steps`` at clusters
   of 2 and 1 and both ways to fill the ring; ``cp_k_steps`` bit for bit in
   both variants, a cluster per image and tiles with a halo), then time
   both, the one-step kernels in an eager loop and at the device's pace
   with their plan and the blocks an SM holds, and their wrappers' host
   time by part; ``pg_step`` and ``pg_k_steps`` at the device's pace with
   their plan; ``cp_k_steps`` at the device's pace over K = 1, 2, 4, 8
   (the intercept is the load, store and launch, the slope one step) with
   its plan; time the read-floor probe ``read_reduce`` at every step
   kernel's shape, and its wrapper's host time by part; its bfloat16
   instance against its plain version; the bfloat16-A instances of
   ``fb_step`` and ``fista_step`` at every check shape and every branch of
   their plan at 2 bytes an entry (and both choices of each pass: x in
   registers or not, one or two columns a thread), each bit-equal to the
   float32 kernel on ``A16.float()`` and near the plain version there,
   then timed at the main path's two shapes beside their bound, their read
   floor (``read_reduce`` on the bf16 A, beside the library call
   ``A16.sum(dim=(1, 2), dtype=torch.float32)``) and the float32
   instances;
4. run the main path at full size: 256 distinct-A lasso problems of
   200 x 400 (``bench.gen_problems``, seed 0, from the port's copy in
   ``proxtpu_torch/tools/problems.py``) through
   ``solve_lasso_batch_packed_tail(restart=True, k1=192, tail=64)``, drained
   by ``stream_solve`` at depth 2, with a host residual recheck, the kernels'
   launch counts, the device time per solve (launches x the kernels' time at
   the device's pace) beside the wall, and a cross-check against the plain
   route;
5. drive the library route, ``BatchedAlgorithm`` -> ``match_kernel_solver``,
   at full width, on the kernel route and on the plain route
   (``use_kernels=False``), with every lane done on both, a host recheck
   and the launch counts of each route's kernels:
   (a) lasso 64 x 512 x 1024 (``benchmarks/kernel_sweep.py``, seed 0, 2 MB
       of A per lane): the blocked solver, ``fb_step`` then
       ``fista_k_steps``; once more with adaptive restart;
   (b) nonconvex box QP, n = 512, B = 64 (``benchmarks/families_bench.py``'s
       family, rng 7, 1 MB of Q per lane): ``pg_step`` then ``pg_k_steps``;
   (c) the flagship 256 x 200 x 400: the packed solver, ``fista_step``;
   (d) 256 tall 400 x 200 lasso problems with the strong-convexity modulus
       ``mf``: ``fb_step`` then ``fista_step`` with a constant beta;
6. drive the rest of the lasso family at full width, each on the kernel
   and the plain route, every lane done, a host recheck, launch counts:
   (g) the shared-A path of ``benchmarks/shared_bench.py``: one 200 x 400
       A, 256 lambdas log-spaced from 0.02 to 0.5 lambda_max, through
       ``BatchedAlgorithm`` with a ``Shared`` least-squares f, with and
       without adaptive restart: ``solve_lasso_multirhs`` (cuBLAS, no
       hand-written kernel) against the generic driver;
   (h) ``solve_lasso_batch_mixed`` on the flagship problems, with and
       without restart: the bf16 instances in stage 1, the float32 ones in
       stage 2, their launches apart;
   (i) ``step_mult = 1.5`` with restart through ``solve_lasso_batch_packed``
       and ``solve_lasso_batch``, the canonical recheck at gamma = 1/L,
       beside the restart-only counts;
   (j) ``solve_lasso_batch_compacting`` on the flagship problems with lambda
       spread (rng 5), restart on and off: bit-equal to
       ``solve_lasso_batch`` on the kernel route;
7. drive the TV route, ``BatchedAlgorithm(make_chambolle_pock_iteration)``
   -> ``match_tv_solver`` -> ``solve_tv_batch`` -> ``cp_k_steps``, on the
   kernel route and on the generic driver, with a float64 fixed-point
   recheck of every returned (x, y) on the host:
   (e) 64 images of 64 x 64 (``benchmarks/tv_bench.py``, seed 0, noise
       0.15, lam 0.12, tol 1e-4): one thread block per image;
   (f) 64 images of 256 x 256, the same generator: a cluster of 16 blocks
       per image, one band of 16 rows each;
8. run the reference suite: the ten solver configurations of
   ``benchmarks/run_benchmarks.py`` (FB, FISTA, ZeroFPR, PANOC, PANOCplus,
   Douglas-Rachford, DRLS, AFBA-1, AFBA-2, SFISTA;
   ``proxtpu_torch/tools/reference_suite.py``), each warmed up on
   ``lasso_tiny.npz`` (20 iterations) and timed once on
   ``lasso_medium.npz`` (500 x 1000;
   Douglas-Rachford on ``lasso_small.npz``, 50 x 100) in float64 on the
   card, every one converged and its float64 host recheck
   (the FB fixed-point residual at gamma = 1 / ||A||^2) under twice the JAX
   package's own, beside the JAX CPU record's count; PANOC, ZeroFPR and DRLS
   once more in float32; and ``BatchedAlgorithm`` of PANOC, ZeroFPR and
   DRLS on 64 random 50 x 100 lassos under ``torch.func.vmap`` with the
   masked searches, every lane rechecked and lanes 0-1 held against their
   single solves.  No kernel lies on this path: every launch counter stays
   at 0;
9. run the application families (``proxtpu_torch/tools/families.py``): the
   SVM path, min-CVaR (its cap cut to 4,000), matrix completion,
   graphical lasso, 1-D TV (the prox under vmap, with the cost of its
   masked trips) and sparse logistic, each at its benchmark script's
   published size in float32 through ``BatchedAlgorithm``'s generic driver,
   timed after a short warm-up and held to its script's gate (matrix
   completion also to 1.25 x the 9.840 s a solve it took with cuSOLVER's
   float32 SVD); no kernel lies on this path, and the phase fails past its
   90 s budget;
10. run the flat machines and the warm start (phase "flat machines",
    ``proxtpu_torch/parallel/flat_ls.py``, ``adaptive_batch.py``,
    ``warm.py``), each route timed after a short warm-up with its trips
    and PyTorch operations a trip, every lane done and rechecked in
    float64 on the host; the phase fails past its 60 s budget:
    (m) ``benchmarks/flat_ls_bench.py``'s flagship problems
        (``bench.gen_problems(256)``, tol 1e-5, Lf per lane) through the
        default ``BatchedAlgorithm``: PANOC, ZeroFPR and PANOCplus on the
        flat machines, each rechecked under twice the JAX package's own
        float32 recheck and its first lanes (0-7 of PANOC, 0-3 of the
        others) against their single solves on the card; PANOC once more on the bounded route (``use_kernels=False``)
        with the ratio of operations an iteration;
    (n) ``benchmarks/logistic_bench.py``'s three flat variants
        (``flat_zerofpr_shared``, ``flat_zerofpr_stacked``,
        ``flat_panoc_shared``) on the families' logistic data, under the
        families' float64 recheck, beside that phase's bounded PANOC;
    (o) the adaptive machines on (m)'s problems: FISTA with no step
        (``batched_adaptive_fista``) and adaptive PANOC from a gamma ten
        times too large;
    (p) ``WarmStartedBatchedAlgorithm(FastForwardBackward)`` in float64 at
        tol 1e-6: the float32 stage on the kernel route (``fista_step``;
        its launches join the kernels' line), the polish on the float64
        plain step, every lane's float64 residual <= 1.05 tol, beside the
        cold float64 solve on the generic driver;
11. drive the drivers' remaining surface (phase "drivers", routes
    (q)-(v)); the phase fails past its 90 s budget:
    (q) ``ForwardBackward`` and ``FastForwardBackward`` on cell (k)'s
        ``lasso_medium`` in float64 at ``check_every`` 1 and 16: the
        suite's counts (2811, 3912) at both, bit-equal solutions, the wall
        and the host's waits on the card (PyTorch's sync debug mode) of
        each;
    (r) 1000 ``states`` of FISTA there, ``save_state`` on the card,
        ``load_state(like=...)`` (also onto the CPU and back), the solve
        resumed with ``resume_iters=1000``: 3912 in all and the unbroken
        run's bits; ``run_recorded`` of FB's residual every 10 iterations:
        ``count == it // 10`` and NaN after it;
    (s) FISTA on the flagship problems (``bench.gen_problems`` seed 0) on
        the generic driver through ``batched_run_segments(segment=128)``,
        the second snapshot saved and the run resumed from disk: counts
        and bits of ``batched_run_loop``;
    (t) ``compacting_batched_run`` against ``batched_run_loop`` on route
        (j)'s lambda-spread problems: the lanes that differ in count or
        bits, both rechecks <= 2 tol, both walls;
    (u) ``BatchedAlgorithm(use_kernels=False).run_recorded`` of the
        per-lane residual every 8 iterations: the unrecorded iterations,
        NaN after ``count``, the wall against the unrecorded run;
    (v) one main-path solve inside ``utils.profiling.trace``: the trace's
        ``fista_step`` and ``fb_step`` kernel events equal the launch
        counters; ``compiled_stats`` of the same solve: the kernels' flops
        and bytes by the JAX package's ``CostEstimate`` formulas at each
        launch's width;
12. drive batched Li-Lin (phase "batched Li-Lin", route (z)): ``BatchedAlgorithm
    (make_li_lin_iteration)`` on route (b)'s 64 box QPs, float32, tol 1e-4,
    capped at 2,000, as ``benchmarks/families_bench.py`` runs it: the
    lanes reported done rechecked <= 2 tol, the lanes where Li-Lin's
    monitor accepts a limit cycle printed beside those of float64 (the same
    in both packages), the done lanes solved again as their own batch, all
    done and rechecked, and the single-problem solver on lanes 0-7 beside
    the batched counts; no kernel launches; the phase fails past its 45 s
    budget;
13. drive the sharding layer (phase "sharding", routes (w) and (x)); the
    phase fails past its 120 s budget:
    (w) a one-rank NCCL process group (``tcp://localhost``) and
        ``default_dp_mesh()``: ``sharded_solve_lasso_batch_packed(restart=
        True)`` on the flagship problems, every lane done, the recheck <=
        1.1 tol, bit-equal to ``solve_lasso_batch_packed``; the other five
        ``sharded_solve_*`` wrappers at routes (a), (b) (with and without
        ``iter_block``), (f) and (g)'s shapes and on the flagship, each
        bit-equal to its unsharded solver with its kernels' launches; PANOC
        on a row-sharded ``ShardedMatrixOperator`` and ``ConsensusADMM`` at
        ``dryrun_multichip``'s sizes against their unsharded runs;
        ``dryrun_multichip(1)``; route (y)'s problem unplaced (timed) and at
        a (1, 1) ``("dp", "tp")`` mesh, where the vmap-aware all-reduce runs
        on NCCL: bit-equal, one all-reduce at init and one a step;
    (x) ``python -m proxtpu_torch.tools.spmd_worker --cases card``: two Gloo
        ranks sharing the card, 128 flagship lanes each, gathered and held
        against (w) lane for lane (bit for bit where ``step_plan`` at B =
        128 is the plan at 256; else every lane rechecked and the lanes
        apart printed); a row-sharded PANOC and a consensus over the two
        ranks against one rank; each rank's wall and the two-rank wall;
14. drive the dp x tp composition (phase "dp x tp", route (y)): ``python -m
    proxtpu_torch.tools.spmd_worker --ranks 4 --cases shared_tp``, four Gloo
    ranks sharing the card as a (2, 2) mesh, ``benchmarks/scaling.py --path
    shared_tp`` at full width (256 lanes over dp, one A of 200 x 400 in row
    stripes over tp, tol 1e-5, ``check_every`` 8, one warm-up and two timed
    solves): one all-reduce over tp at init and a step, none over dp, tp
    ranks bit-equal, every lane done, bit-equal to the stripes emulated in
    this process, within 1e-3 of (w)'s unplaced run and every lane's
    float64 recheck <= 1.2 tol; each rank's wall, the four-rank wall, the
    one-rank wall, the lanes apart in count, µs a Gloo all-reduce; the
    phase fails past its 120 s budget;
15. drive the tp layout on the shared-A solver, the flat machines and
    DRLS: phase "tp legs at (1, 1)", each route unplaced (timed, the
    reference) and at a (1, 1) ``("dp", "tp")`` mesh on a one-rank NCCL
    group (bit-equal, the route taken and its all-reduces a step or trip;
    it fails past its 60 s budget); then phase "tp legs", ``python -m
    proxtpu_torch.tools.spmd_worker --ranks 4 --cases tp_legs``, four Gloo
    ranks sharing the card as a (2, 2) mesh, each route after a warm-up of
    a few steps:
    (aa) route (y)'s problem through ``BatchedAlgorithm(
         make_fast_forward_backward_iteration)`` with ``Shared(
         LeastSquaresLoss)`` in row stripes: ``solve_lasso_multirhs``'s
         core on the stripe (the counting wrapper), one all-reduce a step;
    (ab) the same problem through ``BatchedAlgorithm`` of PANOC and ZeroFPR
         (``Shared(SqrDistance(b))`` beside ``Shared(MatrixOperator(A))``,
         both in row stripes: two all-reduces a trip) and of
         FastForwardBackward with no step (the adaptive FISTA machine, two
         a trip), and route (n)'s ``flat_zerofpr_shared`` on the
         families' logistic data with A in row stripes;
    (ac) the same problem through ``BatchedAlgorithm(make_drls_iteration)``
         with ``Shared(make_least_squares(A, b))`` in row stripes
         (``RowShardedLeastSquares``: the wide A's factors from the
         stripes gathered once; DRLS's flat machine, three all-reduces a
         trip: Woodbury's two sums and the prox's value);
    each: none over dp, tp ranks bit-equal, every lane done, bit-equal to
    the stripes emulated in this process, within 1e-3 of its unplaced
    run and every lane's float64 recheck <= 1.2 tol (DRLS: the
    Douglas-Rachford residual at its gamma 0.95 / Lf; the logistic route:
    both runs under the families' gate, the distance printed), the lanes
    apart in count printed; each rank's
    wall, the four-rank wall, the steps or trips, the all-reduces a rank,
    µs a Gloo all-reduce at each size, (aa) against (y)'s wall; the phase
    fails past its 180 s budget;
16. ``tools/graft_entry.entry()`` with no argument: its FISTA step built on
    the card, against the same step on a CPU copy within 1e-5;
17. run the JAX package's example scripts and its guides' code on the card
    (phase "examples", ``proxtpu_torch/examples``): the 14 scripts at
    their sizes, seeds, dtypes and caps, each held to its own oracle (the
    assertions of ``tests/test_docs_examples.py``), its wall and
    iterations printed beside the JAX package's counts on the CPU and how
    far they are apart; the ten guide blocks, each held to what it claims;
    the nuclear-norm prox in float32 within 5e-6 of float64 LAPACK on the
    host at robust PCA's ``L + S`` and a normal 60 x 50; a complex64 lasso
    through ``BatchedAlgorithm``'s default route, no kernel launched and
    bit-equal to ``use_kernels=False``; the phase fails past its 120 s
    budget;
18. run the code blocks of ``docs/tpu_scaling.md`` on the card (phase
    "scaling guide", ``proxtpu_torch/examples/scaling_guide.py``) at the
    scale their text gives: 4096 float64 lassos through ``batch_problems``
    with a Python ``Lf`` a problem (their data and Lipschitz constants
    made in a thread while phase "examples" runs) and the same lanes by one factory call,
    bit-equal; bounded adaptive FB; vmapped power iteration; the sharded
    PANOC and consensus on a one-rank NCCL group; block 7's
    ``set_matmul_precision("default")`` as written and a FISTA solve at
    each of the three settings (``"high"`` and ``"default"`` capped at
    SCALING_REDUCED_MAXIT), with the TF32 guard; the warm start on a
    shared A; ``solve_lasso_batch`` (``fb_step``,
    ``fista_step``); the shared-A leg; ``stream_solve`` of the packed
    solver (``fista_step``); two Gloo ranks sharing the card in
    ``dryrun_multichip`` (started after the build, beside the phases that
    check the kernels, and waited for before the first one that times
    them); each block held to what
    its paragraph claims, its wall, lanes, iterations and launches printed;
    no other block launches a kernel; ``fb_step`` and ``fista_step`` give
    the same bits under ``"default"`` as under ``"highest"``; ``pmatvec``
    and ``pdot`` at each setting held to their rounding (``"default"``:
    the product of bfloat16-rounded operands) and PyTorch's flags put
    back; the phase
    fails past its 90 s budget;
19. print the kernels' JSON line (time, plain version's time, bound and,
    where one PyTorch call computes the same function, that call's time),
    the seconds of every phase, then the result line.

Imports no JAX.  Needs one card, ``nvcc`` (CUDA_HOME) and a few minutes.
"""

import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

DEVICE = "cuda"
TOL = 1e-5
MAXIT = 2000
N_STREAM = 6
MAIN_SHAPES = [(256, 200, 400), (64, 200, 400)]  # bulk phase, narrow tail
# fb_step and fista_step at every shape a path gives them: the main path's,
# route (a)'s first step (64 x 512 x 1024), route (d)'s tall 400 x 200
# (route (c) is MAIN_SHAPES[0]), and the small shape of kernel_sweep.py:22,
# which the reference sent to XLA on a v5e
STEP_SHAPES = MAIN_SHAPES + [(256, 400, 200), (64, 512, 1024),
                             (1024, 64, 128)]
# and at every other branch of their launch plan: a ragged M and N (one
# stage, ordinary loads), rows of no multiple of 16 bytes in a lane larger
# than a block's shared memory (a ring filled by ordinary loads), and rows
# too wide for three one-row stages beside x, g and r (the lane in place)
CHECK_SHAPES = STEP_SHAPES + [(7, 33, 161), (5, 300, 250), (2, 24, 12000)]
# the bfloat16-A instances at the same shapes (at 2 bytes an entry
# (2, 24, 12000) walks a ring of one-row tiles), at a lane whose bf16 rows
# are still too wide for a ring (read in place), at an odd N through a ring
# (one column a thread in pass 2) and at an N just too wide for x in
# registers in pass 1
BF16_CHECK_SHAPES = CHECK_SHAPES + [(2, 24, 20000), (9, 300, 251),
                                    (16, 200, 520)]
# One step against its plain version.  Both sum 200- to 1024-term f32
# products in different orders (warp shuffles vs cuBLAS), so each output
# carries a few ulps of its largest partial sums: iterates and residuals
# are O(1) here, so 1e-5 absolute is ~100 ulps of headroom.  rs sums up to
# 1024 such products of O(1) differences and can reach O(10), so it is
# held relative to its size.
ATOL = 1e-5
RS_RTOL = 1e-4
# K = 8 steps against the plain version.  Each step carries the one-step
# difference above into the next; on these inputs the plain version in f32
# sits up to 4.5e-6 from the same eight steps in f64 (iterates up to ~10),
# so two f32 versions are held to 5e-5, ten times that.
K = 8
ATOL_K = 5e-5
BLOCKED_SHAPES = [(64, 512, 1024), (7, 33, 161)]  # route (a), ragged
# fista_k_steps at every branch of its launch plan on 132 SMs: clusters of
# 4 and 8 thread blocks per lane (route (a) has 2, the ragged shape 1), M
# that does not divide over the cluster with a short last tile, rows of no
# multiple of 16 bytes under a cluster (stages filled by ordinary loads),
# and rows too wide for a ring of stages (tiles read in place by one block
# per lane, also where the rows alone would have made a cluster)
CLUSTER_SHAPES = [(32, 256, 512), (16, 512, 256), (16, 515, 256),
                  (16, 515, 250), (3, 40, 8400), (2, 130, 8404)]
# B above the SM count: one block per lane, two waves
WIDE_BATCH_SHAPE = (256, 512, 512)
# route (b) (a cluster of 2 blocks per lane), ragged (rows of no multiple
# of 16 bytes: a ring filled by ordinary loads)
BOX_SHAPES = [(64, 512), (7, 161)]
SMALL_BOX = (256, 128)         # dispatch.py:767-770, sent to XLA on a v5e


# TV denoising (benchmarks/tv_bench.py:28-37, 61-66)
TV_LAM = 0.12
TV_TOL = 1e-4
TV_MAXIT = 5000
TV_SHAPES = [(64, 64, 64), (64, 256, 256)]  # routes (e) and (f)
# cp_k_steps is also checked at a ragged shape and the reference's test
# shape (one block of 1024 and of 512 threads), a ragged image that takes a
# cluster of 8, rows wider than a block (a cluster of 8 whose threads walk
# 47 blocks of 32 columns), and at an image no cluster holds (the halo
# variant)
TV_CHECK_SHAPES = TV_SHAPES + [(7, 33, 21), (4, 16, 24), (3, 301, 203),
                               (2, 40, 1500)]
TV_HALO = (2, 512, 512)
# K of cp_k_steps at the device's pace: the intercept of the time over K is
# the load, the store and the launch, the slope one step
TV_KS = (1, 2, 4, 8)
# read_reduce against A.sum: both sum M * N f32 terms of size O(1/sqrt(M))
# in different orders; each carries a few ulps of its largest partial sum
# (at most about |A|_1 of a lane, ~2e4 at 512 x 1024), so the sums are held
# relative to the lane's sum of absolute values.
READ_RTOL = 1e-5
# every step kernel's operator shape, for the measured read floor
FLOOR_SHAPES = [(256, 200, 400), (64, 200, 400), (64, 512, 1024),
                (1024, 64, 128), (64, 512, 512), (256, 128, 128)]
# datasheet rates of one H100 SXM: device memory, f32 outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


# route (h)'s device ms per solve (launches x the kernels' times at the
# device's pace), restart off and on, when the bf16 instances ran the
# float32 kernels' body (NVIDIA H100 80GB HBM3, 700 W)
H_DEVICE_MS_F32_DESIGN = {False: 19.9, True: 9.41}


def bound(nbytes, ops):
    """``(ms, by)``: the least time the card could take to move ``nbytes``
    (each input read once, each output written once) or do ``ops`` float32
    operations, whichever is larger, and which of the two it is."""
    tb, to = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def cp_bound(B, H, W):
    """cp_k_steps at K steps: b, x, yx, yy, g1, g2, lam -> x, yx, yy, res;
    25 operations per pixel and step, counted from the plain version (3 for
    the divergence, 5 for xbar, 2 for mid, 2 differences, 4 for v, 4 for
    its norm, 3 for the scale, 2 products)."""
    return bound(4 * (7 * B * H * W + 4 * B), 25 * K * B * H * W)


def lasso_bound(B, M, N, vecs, scalars, steps, a_bytes=4):
    """A lasso step kernel: A (``a_bytes`` an entry), b, ``vecs`` (B, N) and
    ``scalars`` (B,) operands and results moved once; two products with A
    per step (2 M N operations each) plus about ten per entry of the
    iterate."""
    return bound(a_bytes * B * M * N
                 + 4 * (B * M + vecs * B * N + scalars * B),
                 steps * B * (4 * M * N + 10 * N))


# operands and results of the one-step kernels: fb_step A, b, x, gamma, thr
# -> z, res; fista_step A, b, x, z_prev, beta, gamma, thr, done -> x, z_prev,
# res, rs
STEP_OPERANDS = {"fb_step": (2, 3), "fista_step": (4, 6)}


def read_bound(B, M, N, a_bytes=4):
    """read_reduce: A (``a_bytes`` an entry) -> out, one addition per
    entry."""
    return bound(a_bytes * B * M * N + 4 * B, B * M * N)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_identify():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke test "
                         "runs only on a GPU")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    print(card)
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = run([f"{CUDA_HOME}/bin/nvcc", "--version"]).splitlines()[-1]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {nvcc}, device 0: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    return card


def phase_build():
    from proxtpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.2f} s into {_build.build_dir()}")
    log = _build.build_dir() / "nvcc.log"
    if log.exists():
        print(log.read_text().strip())


@functools.lru_cache(maxsize=None)
def step_inputs(B, M, N, seed):
    """Operands of one lasso step on the card, made once per shape and seed
    (a lane's Lipschitz constant is a singular value decomposition); callers
    clone what a kernel updates in place."""
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A], np.float32)
    gamma = 1.0 / Lf
    arrays = dict(
        A=A,
        b=rng.standard_normal((B, M)).astype(np.float32),
        x=rng.standard_normal((B, N)).astype(np.float32),
        z_prev=rng.standard_normal((B, N)).astype(np.float32),
        beta=rng.uniform(0.1, 0.9, B).astype(np.float32),
        gamma=gamma.astype(np.float32),
        thr=(gamma * rng.uniform(0.05, 0.5, B)).astype(np.float32),
        shrink=(1.0 + gamma * 0.3).astype(np.float32),
        done=(rng.random(B) < 0.5).astype(np.float32),
    )
    return {k: torch.tensor(v, device=DEVICE) for k, v in arrays.items()}


def max_err(got, want):
    return float((got - want).abs().max())


def check_kernels():
    """Every variant against the plain version at every check shape;
    returns the largest absolute error of z, x+ and res per kernel."""
    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import lasso as tl

    worst = {"fb_step": 0.0, "fista_step": 0.0}
    branches = set()
    for B, M, N in CHECK_SHAPES:
        d = step_inputs(B, M, N, seed=B + M + N)
        threads, R, S, smem = tl.step_plan(B, M, N, _build.sm_count(0),
                                           _build.max_shared_bytes(0))
        branch = ("in place" if S == 0 else
                  ("one stage, " if S == 1 else "ring, ")
                  + ("bulk copy" if N % 4 == 0 else "ordinary loads"))
        branches.add(branch)
        print(f"  {(B, M, N)}: {threads} threads, {S} stages of {R} rows, "
              f"{smem} bytes ({branch})")
        for shrink in (None, d["shrink"]):
            args = (d["A"], d["b"], d["x"], d["gamma"], d["thr"])
            z_k, r_k = tl.fused_fb_prox_grad(*args, shrink=shrink)
            z_p, r_p = tl.reference_fb_prox_grad(*args, shrink=shrink)
            torch.cuda.synchronize()
            err = max(max_err(z_k, z_p), max_err(r_k, r_p))
            assert err <= ATOL, (B, M, N, shrink is not None, err)
            worst["fb_step"] = max(worst["fb_step"], err)
            print(f"  fb_step    {(B, M, N)} shrink={shrink is not None}: "
                  f"max|err| {err:.3e}")
            for restart in (False, True):
                for done in (torch.zeros_like(d["done"]), d["done"]):
                    rest = (d["beta"], d["gamma"], d["thr"], done)
                    want = tl.reference_fista_full_step(
                        d["A"], d["b"], d["x"], d["z_prev"], *rest,
                        shrink=shrink, restart=restart)
                    got = tl.fused_fista_full_step(
                        d["A"], d["b"], d["x"].clone(), d["z_prev"].clone(),
                        *rest, shrink=shrink, restart=restart)
                    torch.cuda.synchronize()
                    err = max(max_err(g, w) for g, w in
                              zip(got[:3], want[:3]))
                    rs_err = float(((got[3] - want[3]).abs()
                                    / (1 + want[3].abs())).max())
                    assert err <= ATOL and rs_err <= RS_RTOL, (
                        B, M, N, restart, err, rs_err)
                    frozen = done != 0
                    assert torch.equal(got[0][frozen], d["x"][frozen])
                    worst["fista_step"] = max(worst["fista_step"], err)
                    print(f"  fista_step {(B, M, N)} shrink="
                          f"{shrink is not None} restart={restart} "
                          f"frozen={int(frozen.sum())}: max|err| {err:.3e}, "
                          f"rs rel {rs_err:.3e}")
    # every branch of the plan was reached
    assert branches == {"ring, bulk copy", "ring, ordinary loads",
                        "one stage, bulk copy", "one stage, ordinary loads",
                        "in place"}, branches
    return worst


def raises(exc, fn):
    """Hold that ``fn()`` raises ``exc``: a kernel wrapper refuses an
    operand, it never takes the plain version for a CUDA tensor."""
    try:
        fn()
    except exc:
        return
    raise AssertionError(f"no {exc.__name__} raised")


def check_bf16_kernels():
    """The bfloat16-A instances of fb_step and fista_step at every shape of
    BF16_CHECK_SHAPES, which reach every branch of their plan at 2 bytes an
    entry (and both choices of each of its passes: x in registers or in
    shared memory, one or two columns a thread), with and without shrink,
    restart off and on, with and without frozen lanes: each result is equal
    to the last bit to the float32 kernel's on ``A16.float()`` (the same
    sums in the same order on the same values), and within ATOL / RS_RTOL
    of the plain version there.  Operands they do not take raise.  Returns
    the largest error against the plain version per instance."""
    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import lasso as tl

    worst = {"fb_step_bf16": 0.0, "fista_step_bf16": 0.0}
    branches, passes = set(), set()
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    for B, M, N in BF16_CHECK_SHAPES:
        d = step_inputs(B, M, N, seed=B + M + N)
        A16 = d["A"].to(torch.bfloat16)
        A32 = A16.float()
        threads, R, S, smem, cols, xregs = tl.step_plan(B, M, N, sms, limit,
                                                        elem=2)
        passes |= {f"{cols} column(s) a thread",
                   "x in registers" if xregs else "x in shared memory"}
        branch = ("in place" if S == 0 else
                  ("one stage, " if S == 1 else "ring, ")
                  + ("bulk copy" if N * 2 % 16 == 0 else "ordinary loads"))
        branches.add(branch)
        cases = 0
        for shrink in (None, d["shrink"]):
            args = (d["b"], d["x"], d["gamma"], d["thr"])
            got = tl.fused_fb_prox_grad(A16, *args, shrink=shrink)
            f32 = tl.fused_fb_prox_grad(A32, *args, shrink=shrink)
            want = tl.reference_fb_prox_grad(A32, *args, shrink=shrink)
            torch.cuda.synchronize()
            assert all(torch.equal(g, f) for g, f in zip(got, f32)), (
                "fb_step_bf16", B, M, N, shrink is not None)
            err = max(max_err(g, w) for g, w in zip(got, want))
            assert err <= ATOL, (B, M, N, err)
            worst["fb_step_bf16"] = max(worst["fb_step_bf16"], err)
            cases += 1
            for restart in (False, True):
                for done in (torch.zeros_like(d["done"]), d["done"]):
                    rest = (d["beta"], d["gamma"], d["thr"], done)
                    got, f32 = (tl.fused_fista_full_step(
                        A, d["b"], d["x"].clone(), d["z_prev"].clone(),
                        *rest, shrink=shrink, restart=restart)
                        for A in (A16, A32))
                    want = tl.reference_fista_full_step(
                        A32, d["b"], d["x"], d["z_prev"], *rest,
                        shrink=shrink, restart=restart)
                    torch.cuda.synchronize()
                    assert all(torch.equal(g, f) for g, f in zip(got, f32)), (
                        "fista_step_bf16", B, M, N, restart,
                        shrink is not None)
                    err = max(max_err(g, w) for g, w in zip(got[:3], want))
                    rs_err = float(((got[3] - want[3]).abs()
                                    / (1 + want[3].abs())).max())
                    assert err <= ATOL and rs_err <= RS_RTOL, (
                        B, M, N, restart, err, rs_err)
                    frozen = done != 0
                    assert torch.equal(got[0][frozen], d["x"][frozen])
                    worst["fista_step_bf16"] = max(worst["fista_step_bf16"],
                                                   err)
                    cases += 1
        print(f"  fb_step_bf16 / fista_step_bf16 {(B, M, N)}: {threads} "
              f"threads, {S} stages of {R} rows, {smem} bytes ({branch}), "
              f"{cols} column(s) a thread, x in "
              f"{'registers' if xregs else 'shared memory'}; "
              f"equal to the float32 kernel on A16.float() in {cases} cases, "
              f"max|err| to the plain version {worst['fb_step_bf16']:.3e} / "
              f"{worst['fista_step_bf16']:.3e}")
    assert branches == {"ring, bulk copy", "ring, ordinary loads",
                        "one stage, bulk copy", "one stage, ordinary loads",
                        "in place"}, branches
    assert passes == {"1 column(s) a thread", "2 column(s) a thread",
                      "x in registers", "x in shared memory"}, passes
    d = step_inputs(*MAIN_SHAPES[1], seed=sum(MAIN_SHAPES[1]))
    A16 = d["A"].to(torch.bfloat16)
    fb = (d["b"], d["x"], d["gamma"], d["thr"])
    raises(TypeError, lambda: tl.fused_fb_prox_grad(d["A"].half(), *fb))
    raises(TypeError, lambda: tl.fused_fb_prox_grad(
        A16, d["b"], d["x"].to(torch.bfloat16), d["gamma"], d["thr"]))
    raises(ValueError, lambda: tl.fused_fb_prox_grad(
        A16.transpose(1, 2).contiguous().transpose(1, 2), *fb))
    raises(TypeError, lambda: tl.solve_lasso_batch_mixed(
        d["A"], d["b"], d["thr"], 1.0 / d["gamma"], TOL,
        warm_dtype=torch.float16))
    print("  refused: A in float16, x in bfloat16, a bf16 A not contiguous, "
          "warm_dtype float16 (each raises)")
    return worst


def time_ms(fn, reps=20, inner=10):
    """``reps`` samples of one step's time in ms, each from CUDA events
    around ``inner`` back-to-back calls, after a warm-up.  This is the
    step's cost in an eager loop: the device's time, or the host's where
    the host cannot keep up.  A is not flushed from L2 between calls: the
    solver reads the same A on every iteration."""
    for _ in range(3):
        fn()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return ts


def graph_ms(fn, reps=20, inner=10):
    """The median time in ms of one call at the device's own pace:
    ``inner`` calls are captured into a CUDA graph, whose replay costs the
    host one launch, and ``reps`` replays are timed with CUDA events.
    Where :func:`time_ms` reads more, the host sets the pace of the eager
    loop."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / inner)
    return statistics.median(ts)


def time_kernels(card):
    """fb_step and fista_step against their plain versions at every shape a
    path gives them, in an eager loop and at the device's own pace, with the
    launch plan and the blocks one SM holds.  Returns the flagship-shape
    eager medians per kernel and ``{(kernel, shape): ms at the device's
    pace}``."""
    import ctypes

    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import lasso as tl

    flagship, pace = {}, {}
    for B, M, N in STEP_SHAPES:
        d = step_inputs(B, M, N, seed=B + M + N)
        live = torch.zeros_like(d["done"])
        fb = (d["A"], d["b"], d["x"], d["gamma"], d["thr"])
        full = (d["A"], d["b"], d["x"], d["z_prev"], d["beta"], d["gamma"],
                d["thr"], live)
        x, zp = d["x"].clone(), d["z_prev"].clone()
        pairs = {
            "fb_step": (lambda: tl.fused_fb_prox_grad(*fb),
                        lambda: tl.reference_fb_prox_grad(*fb)),
            "fista_step": (
                lambda: tl.fused_fista_full_step(
                    d["A"], d["b"], x, zp, *full[4:], restart=True),
                lambda: tl.reference_fista_full_step(*full, restart=True)),
        }
        plan = tl.step_plan(B, M, N, _build.sm_count(0),
                            _build.max_shared_bytes(0))
        gb = B * M * N * 4 / 1e9
        for name, (kernel, plain) in pairs.items():
            # plain, kernel, kernel, plain: a drift in clocks shows as a
            # difference between the two runs of one side
            p1, k1, k2, p2 = (time_ms(plain, reps=10), time_ms(kernel),
                              time_ms(kernel), time_ms(plain, reps=10))
            k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
            g = pace[(name, (B, M, N))] = graph_ms(kernel)
            held = ctypes.c_int()
            _build.check(_build.library().proxtpu_step_blocks_per_sm(
                int(name == "fista_step"), 4, M, N, *plan, 1, 0,
                ctypes.byref(held)), "step_blocks_per_sm")
            print(f"  {name:10s} {(B, M, N)}: kernel {1e3 * k:.1f} us eager "
                  f"(runs {1e3 * statistics.median(k1):.1f} / "
                  f"{1e3 * statistics.median(k2):.1f}), {1e3 * g:.1f} us at "
                  f"the device's pace (CUDA graph; A read once = "
                  f"{gb / (g * 1e-3):.0f} GB/s); plain {1e3 * p:.1f} us "
                  f"(runs {1e3 * statistics.median(p1):.1f} / "
                  f"{1e3 * statistics.median(p2):.1f}); bound "
                  f"{1e3 * lasso_bound(B, M, N, *STEP_OPERANDS[name], 1)[0]:.1f}"
                  f" us; plan {plan[0]} "
                  f"threads, {plan[2]} stages of {plan[1]} rows, {plan[3]} "
                  f"bytes, {held.value} blocks per SM  [{card}]")
            if (B, M, N) == MAIN_SHAPES[0]:
                flagship[name] = (k, p)
        if (B, M, N) in MAIN_SHAPES:
            step_host_parts(d, card)
    return flagship, pace


def time_bf16_kernels(card, pace):
    """The bfloat16-A instances of fb_step and fista_step at the main
    path's two shapes, against their plain versions (the float32 step on A
    cast up per call), in an eager loop and at the device's pace, with the
    plan at 2 bytes an entry, the blocks one SM holds and the bound, beside
    their read floor (``read_reduce`` on the bf16 A, against its plain
    version and the library call ``A16.sum(dim=(1, 2),
    dtype=torch.float32)``) and the float32 instance's time at the device's
    pace (``pace`` of time_kernels, which this adds the bf16 instances and
    the floor to).  Returns the flagship-shape eager medians per kernel
    (kernel, plain), the floor's library call there, and the launches of
    the floor's bf16 instance in this phase."""
    import ctypes

    from proxtpu_torch.kernels import _build, probe
    from proxtpu_torch.kernels import lasso as tl

    flagship, library = {}, None
    probe.read_reduce.launches_bf16 = 0
    for B, M, N in MAIN_SHAPES:
        d = step_inputs(B, M, N, seed=B + M + N)
        A16 = d["A"].to(torch.bfloat16)
        # the floor: read_reduce on the bf16 A, its plain version, the
        # library call
        res, scratch = torch.empty(B, device=DEVICE), \
            probe.read_reduce_scratch(A16)
        floor = lambda: probe.read_reduce(A16, out=res, scratch=scratch)  # noqa: E731
        lib_sum = lambda: A16.sum(dim=(1, 2), dtype=torch.float32)  # noqa: E731
        nbytes = A16.numel() * 2 + B * 4
        k, p = time_pair("read_reduce_bf16", floor,
                         lambda: probe.reference_read_reduce(A16),
                         f"{(B, M, N)}", card, nbytes)
        lib_ms = statistics.median(time_ms(lib_sum, reps=10))
        g = pace[("read_reduce_bf16", (B, M, N))] = graph_ms(floor)
        lib_g = graph_ms(lib_sum)
        print(f"    at the device's pace (CUDA graph): kernel {1e3 * g:.1f} "
              f"us, library A16.sum(dtype=float32) {1e3 * lib_g:.1f} us "
              f"(eager {1e3 * lib_ms:.1f}); bound "
              f"{1e3 * read_bound(B, M, N, 2)[0]:.1f} us  [{card}]")
        if (B, M, N) == MAIN_SHAPES[0]:
            flagship["read_reduce_bf16"], library = (k, p), lib_ms
        live = torch.zeros_like(d["done"])
        fb = (d["b"], d["x"], d["gamma"], d["thr"])
        rest = (d["beta"], d["gamma"], d["thr"], live)
        x, zp = d["x"].clone(), d["z_prev"].clone()
        pairs = {
            "fb_step_bf16": (lambda: tl.fused_fb_prox_grad(A16, *fb),
                             lambda: tl.reference_fb_prox_grad(A16, *fb)),
            "fista_step_bf16": (
                lambda: tl.fused_fista_full_step(A16, d["b"], x, zp, *rest,
                                                 restart=True),
                lambda: tl.reference_fista_full_step(
                    A16, d["b"], d["x"], d["z_prev"], *rest, restart=True)),
        }
        plan = tl.step_plan(B, M, N, _build.sm_count(0),
                            _build.max_shared_bytes(0), elem=2)
        gb = B * M * N * 2 / 1e9
        for name, (kernel, plain) in pairs.items():
            p1, k1, k2, p2 = (time_ms(plain, reps=10), time_ms(kernel),
                              time_ms(kernel), time_ms(plain, reps=10))
            k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
            g = pace[(name, (B, M, N))] = graph_ms(kernel)
            held = ctypes.c_int()
            _build.check(_build.library().proxtpu_step_blocks_per_sm(
                int(name == "fista_step_bf16"), 2, M, N, *plan,
                ctypes.byref(held)), "step_blocks_per_sm")
            base = name[:-len("_bf16")]
            bnd = lasso_bound(B, M, N, *STEP_OPERANDS[base], 1, a_bytes=2)[0]
            floor_g = pace[("read_reduce_bf16", (B, M, N))]
            print(f"  {name:15s} {(B, M, N)}: kernel {1e3 * k:.1f} us eager "
                  f"(runs {1e3 * statistics.median(k1):.1f} / "
                  f"{1e3 * statistics.median(k2):.1f}), {1e3 * g:.1f} us at "
                  f"the device's pace (A read once at 2 bytes = "
                  f"{gb / (g * 1e-3):.0f} GB/s), float32 instance "
                  f"{1e3 * pace[(base, (B, M, N))]:.1f} us at the device's "
                  f"pace; plain {1e3 * p:.1f} us (runs "
                  f"{1e3 * statistics.median(p1):.1f} / "
                  f"{1e3 * statistics.median(p2):.1f}); bound "
                  f"{1e3 * bnd:.1f} us, bf16 read floor {1e3 * floor_g:.1f} "
                  f"us, library call: none; plan {plan[0]} threads, "
                  f"{plan[2]} stages of {plan[1]} rows, {plan[3]} bytes, "
                  f"{plan[4]} column(s) a thread in pass 2, x in "
                  f"{'registers' if plan[5] else 'shared memory'}, "
                  f"{held.value} blocks per SM  [{card}]")
            if (B, M, N) == MAIN_SHAPES[0]:
                flagship[name] = (k, p)
    return flagship, library, probe.read_reduce.launches_bf16


def step_host_parts(d, card):
    """Where the host time of one fista_step call goes: each part of the
    wrapper as it is, and as it was with a device context, a boxed stream, a
    library lookup, named operand lists and an uncached plan per call."""
    import ctypes

    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import lasso as tl

    A, b = d["A"], d["b"]
    B, M, N = A.shape
    dev = A.device
    live = torch.zeros_like(d["done"])
    x, zp = d["x"].clone(), d["z_prev"].clone()
    scalars = (d["beta"], d["gamma"], d["thr"], live)
    names = ("beta", "gamma", "thr", "done_mask")
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    plan = tl.step_plan(B, M, N, sms, limit)
    entry = _build.library().proxtpu_fista_step
    raw = torch._C._cuda_getCurrentRawStream(dev.index)
    res, rs = torch.empty(B, device=dev), torch.empty(B, device=dev)
    tensors = (A, b, x, zp, *scalars, None, res, rs)

    def pointers():
        return [None if t is None else t.data_ptr() for t in tensors]

    def device_context():
        with torch.cuda.device(dev):
            pass

    def named_check():
        tl._check_operands(A, b, [("x", x), ("z_prev", zp)],
                           list(zip(names, scalars)), 0)

    def as_it_was():
        named_check()
        out = torch.empty(B, dtype=x.dtype, device=x.device)
        out2 = torch.empty_like(out)
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _build.library().proxtpu_fista_step(
                A.data_ptr(), b.data_ptr(), x.data_ptr(), zp.data_ptr(),
                *(t.data_ptr() for t in scalars), None, out.data_ptr(),
                out2.data_ptr(), B, M, N, 1,
                *tl.step_plan(B, M, N, _build.sm_count(A.device.index),
                              _build.max_shared_bytes(A.device.index)),
                ctypes.c_void_p(stream))
        _build.check(err, "fista_step")

    fb = (A, b, d["x"], d["gamma"], d["thr"])
    parts = {
        "_check_operands (named lists, ten tensors)": named_check,
        "_operands_ok": lambda: tl._operands_ok(A, b, (x, zp), scalars),
        "step_plan": lambda: tl.step_plan(B, M, N, sms, limit),
        "sm_count, max_shared_bytes and the plan, cached": lambda: (
            tl.cached_step_plan(B, M, N, _build.sm_count(0),
                                _build.max_shared_bytes(0))),
        "torch.empty(B) and empty_like": lambda: (
            torch.empty(B, dtype=x.dtype, device=x.device),
            torch.empty_like(res)),
        "x.new_empty(B) and empty_like": lambda: (x.new_empty(B),
                                                  torch.empty_like(res)),
        "with torch.cuda.device(A.device)": device_context,
        "A.get_device() == torch.cuda.current_device()":
            lambda: A.get_device() == torch.cuda.current_device(),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "_build.library() and the entry's lookup":
            lambda: _build.library().proxtpu_fista_step,
        "the entry, cached": lambda: tl._entries.get("fista_step"),
        "ten data_ptr()": pointers,
        "ctypes call (one launch), stream boxed in c_void_p":
            lambda: entry(*pointers(), B, M, N, 1, *plan,
                          ctypes.c_void_p(raw)),
        "ctypes call (one launch), stream as int":
            lambda: entry(*pointers(), B, M, N, 1, *plan, raw),
        "fused_fista_full_step, whole, its parts as they were": as_it_was,
        "fused_fista_full_step, whole": lambda: tl.fused_fista_full_step(
            A, b, x, zp, *scalars, restart=True),
        "fused_fb_prox_grad, whole": lambda: tl.fused_fb_prox_grad(*fb),
    }
    print(f"    host time per call by part at {tuple(A.shape)} "
          f"(time.perf_counter, median of 5 batches of 100 calls)  [{card}]:")
    for name, fn in parts.items():
        print(f"      {name}: {host_us(fn):.2f} us")


def box_inputs(B, n, seed):
    """Random symmetric Q (eigenvalues within about [-1, 1]), q, x in the
    box, gamma = 0.95 / ||Q||, bounds +-1, half the lanes frozen."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, n, n))
    Q = ((G + G.transpose(0, 2, 1)) / (2 * np.sqrt(2 * n))).astype(np.float32)
    L = np.abs(np.linalg.eigvalsh(Q.astype(np.float64))).max(axis=1)
    arrays = dict(
        Q=Q,
        q=rng.standard_normal((B, n)).astype(np.float32),
        x=rng.uniform(-1, 1, (B, n)).astype(np.float32),
        gamma=(0.95 / L).astype(np.float32),
        lo=np.full(B, -1.0, np.float32),
        hi=np.full(B, 1.0, np.float32),
        done=(rng.random(B) < 0.5).astype(np.float32),
    )
    return {k: torch.tensor(v, device=DEVICE) for k, v in arrays.items()}


def check_new_kernels():
    """fista_k_steps, pg_step and pg_k_steps against their plain versions
    at the library route's shapes and a ragged one (fista_k_steps also at
    every branch of its launch plan, see CLUSTER_SHAPES), restart on and
    off, with and without frozen lanes; frozen lanes come back bit-equal,
    and two calls of fista_k_steps give the same bits.  Returns the largest
    absolute error per kernel."""
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    from proxtpu_torch.kernels import _build

    worst = {"fista_k_steps": 0.0, "pg_step": 0.0, "pg_k_steps": 0.0}
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    plans = set()
    cases = [(shape, False) for shape in BLOCKED_SHAPES + CLUSTER_SHAPES]
    # and route (a)'s shape in a buffer whose lanes do not start on 16
    # bytes (stages filled by ordinary loads)
    for (B, M, N), shifted in cases + [(BLOCKED_SHAPES[0], True)]:
        d = dict(step_inputs(B, M, N, seed=B + M + N))
        if shifted:
            flat = torch.empty(B * M * N + 1, device=DEVICE)
            flat[1:] = d["A"].reshape(-1)
            d["A"] = flat[1:].view(B, M, N)
            assert d["A"].data_ptr() % 16 == 4 and d["A"].is_contiguous()
        C, R, S = tl.k_steps_plan(B, M, N, sms, limit)
        fill = ("in place" if S == 0 else "bulk copy"
                if N % 4 == 0 and not shifted else "ordinary loads")
        plans.add((C, fill))
        t0 = torch.tensor(np.random.default_rng(B).uniform(1, 5, B)
                          .astype(np.float32), device=DEVICE)
        for restart in (False, True):
            for done in (torch.zeros_like(d["done"]), d["done"]):
                args = (d["A"], d["b"], d["x"], d["z_prev"], t0, d["gamma"],
                        d["thr"], done)
                want = tl.reference_fista_k_steps(*args, K=K,
                                                  restart=restart)
                got, again = (tl.fused_fista_k_steps(
                    d["A"], d["b"], d["x"].clone(), d["z_prev"].clone(),
                    t0.clone(), d["gamma"], d["thr"], done, K=K,
                    restart=restart) for _ in range(2))
                torch.cuda.synchronize()
                err = max(max_err(g, w) for g, w in zip(got, want))
                assert err <= ATOL_K, (B, M, N, restart, err)
                assert all(torch.equal(g, a) for g, a in zip(got, again)), (
                    "two calls differ", B, M, N, restart)
                frozen = done != 0
                for g, w in zip(got[:3], (d["x"], d["z_prev"], t0)):
                    assert torch.equal(g[frozen], w[frozen])
                assert bool((got[3][frozen] == 0).all())
                worst["fista_k_steps"] = max(worst["fista_k_steps"], err)
                print(f"  fista_k_steps {(B, M, N)} K={K} C={C} R={R} S={S} "
                      f"({fill}) restart={restart} "
                      f"frozen={int(frozen.sum())}: max|err| {err:.3e}, two "
                      f"calls bit-equal")
    # every branch of the plan was reached
    assert {c for c, _ in plans} == {1, 2, 4, 8}, plans
    assert {f for _, f in plans} == {"bulk copy", "ordinary loads",
                                     "in place"}, plans
    assert (8, "ordinary loads") in plans, plans
    pg_plans = set()
    for B, n in BOX_SHAPES + [SMALL_BOX]:
        d = box_inputs(B, n, seed=B + n)
        C, R, S = tb.pg_plan(B, n, sms, limit)
        pg_plans.add((C, "bulk copy" if n % 4 == 0 else "ordinary loads"))
        print(f"  pg_k_steps {(B, n)}: plan C, R, S = {(C, R, S)}")
        for done in (torch.zeros_like(d["done"]), d["done"]):
            frozen = done != 0
            rest = (d["gamma"], d["lo"], d["hi"])
            z_p, r_p = tb.reference_pg_box_step(d["Q"], d["q"], d["x"],
                                                *rest)
            z_p = torch.where(frozen[:, None], d["x"], z_p)
            r_p = torch.where(frozen, 0.0, r_p)
            z_k, r_k = tb.fused_pg_box_step(d["Q"], d["q"], d["x"].clone(),
                                            *rest, done)
            x_p, s_p = tb.reference_pg_box_k_steps(d["Q"], d["q"], d["x"],
                                                   *rest, done, K=K)
            x_k, s_k = tb.fused_pg_box_k_steps(d["Q"], d["q"],
                                               d["x"].clone(), *rest, done,
                                               K=K)
            torch.cuda.synchronize()
            e1 = max(max_err(z_k, z_p), max_err(r_k, r_p))
            eK = max(max_err(x_k, x_p), max_err(s_k, s_p))
            assert e1 <= ATOL and eK <= ATOL_K, (B, n, e1, eK)
            for x_got in (z_k, x_k):
                assert torch.equal(x_got[frozen], d["x"][frozen])
            worst["pg_step"] = max(worst["pg_step"], e1)
            worst["pg_k_steps"] = max(worst["pg_k_steps"], eK)
            print(f"  pg_step / pg_k_steps {(B, n)} K={K} "
                  f"frozen={int(frozen.sum())}: max|err| {e1:.3e} / "
                  f"{eK:.3e}")
    # a cluster of 2 by bulk copy, one block by ordinary loads and by bulk
    assert pg_plans == {(2, "bulk copy"), (1, "ordinary loads"),
                        (1, "bulk copy")}, pg_plans
    return worst


def time_pair(name, kernel, plain, label, card, nbytes):
    """Plain, kernel, kernel, plain; returns the medians (ms) and prints
    them with the rate of ``nbytes`` read once per call."""
    p1, k1, k2, p2 = (time_ms(plain, reps=10), time_ms(kernel, reps=10),
                      time_ms(kernel, reps=10), time_ms(plain, reps=10))
    k, p = statistics.median(k1 + k2), statistics.median(p1 + p2)
    gb = nbytes / 1e9
    print(f"  {name:13s} {label}: kernel {1e3 * k:.1f} us (runs "
          f"{1e3 * statistics.median(k1):.1f} / "
          f"{1e3 * statistics.median(k2):.1f}), plain {1e3 * p:.1f} us "
          f"(runs {1e3 * statistics.median(p1):.1f} / "
          f"{1e3 * statistics.median(p2):.1f}) per call; "
          f"{gb / (k * 1e-3):.0f} GB/s kernel, {gb / (p * 1e-3):.0f} GB/s "
          f"plain  [{card}]")
    return k, p


def time_new_kernels(card):
    """fista_k_steps, pg_step and pg_k_steps against their plain versions at
    the library route's shapes, and pg_step at the small shape the reference
    sent to XLA on a v5e (dispatch.py:767-771; the small lasso shape of
    dispatch.py:668-676 is among time_kernels'), all lanes live; pg_step and
    pg_k_steps also at the device's pace with their plan.  Returns the
    route-shape medians per kernel and ``{(kernel, shape): ms at the
    device's pace}`` of the box-QP kernels."""
    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl

    out = {}
    for B, M, N in (BLOCKED_SHAPES[0], WIDE_BATCH_SHAPE):
        d = step_inputs(B, M, N, seed=B + M + N)
        live = torch.zeros_like(d["done"])
        t0 = torch.ones_like(d["beta"])
        x, zp, t = d["x"].clone(), d["z_prev"].clone(), t0.clone()
        kernel = lambda: tl.fused_fista_k_steps(  # noqa: E731
            d["A"], d["b"], x, zp, t, d["gamma"], d["thr"], live, K=K,
            restart=True)
        pair = time_pair(
            "fista_k_steps", kernel,
            lambda: tl.reference_fista_k_steps(
                d["A"], d["b"], d["x"], d["z_prev"], t0, d["gamma"],
                d["thr"], live, K=K, restart=True),
            f"{(B, M, N)} K={K}", card, K * B * M * N * 4)
        out.setdefault("fista_k_steps", pair)
        C, R, S = tl.k_steps_plan(B, M, N, _build.sm_count(0),
                                  _build.max_shared_bytes(0))
        print(f"    at the device's pace (CUDA graph): kernel "
              f"{1e3 * graph_ms(kernel):.1f} us; {B} x {C} thread blocks, "
              f"{S} stages of {R} rows; A streamed once per inner step "
              f"{1e3 * K * bound(4 * B * M * N, 0)[0]:.1f} us at "
              f"{PEAK_BYTES_S / 1e12} TB/s  [{card}]")
    pace = {}
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)

    def box_pair(name, B, n, seed, steps):
        d = box_inputs(B, n, seed=seed)
        live = torch.zeros_like(d["done"])
        rest = (d["gamma"], d["lo"], d["hi"])
        x = d["x"].clone()
        if steps == 1:
            kernel = lambda: tb.fused_pg_box_step(  # noqa: E731
                d["Q"], d["q"], x, *rest, live)
            plain = lambda: tb.reference_pg_box_step(  # noqa: E731
                d["Q"], d["q"], d["x"], *rest)
        else:
            kernel = lambda: tb.fused_pg_box_k_steps(  # noqa: E731
                d["Q"], d["q"], x, *rest, live, steps)
            plain = lambda: tb.reference_pg_box_k_steps(  # noqa: E731
                d["Q"], d["q"], d["x"], *rest, live, steps)
        pair = time_pair(name, kernel, plain, f"{(B, n)} K={steps}", card,
                         steps * B * n * n * 4)
        g = pace[(name, (B, n))] = graph_ms(kernel)
        print(f"    at the device's pace (CUDA graph): kernel "
              f"{1e3 * g:.1f} us; plan C, R, S = "
              f"{tb.pg_plan(B, n, sms, limit)}; Q streamed once per step "
              f"{1e3 * steps * bound(4 * B * n * n, 0)[0]:.1f} us at "
              f"{PEAK_BYTES_S / 1e12} TB/s  [{card}]")
        return pair

    B, n = BOX_SHAPES[0]
    out["pg_step"] = box_pair("pg_step", B, n, 1, 1)
    out["pg_k_steps"] = box_pair("pg_k_steps", B, n, 1, K)
    print("  small shape (the reference's XLA route on a v5e):")
    box_pair("pg_step", *SMALL_BOX, 3, 1)
    return out, pace


def tv_images(B, H, W, seed=0, noise=0.15):
    """The reference's TV test images (benchmarks/tv_bench.py:61-66): a
    centred square of ones plus Gaussian noise, float32."""
    rng = np.random.default_rng(seed)
    clean = np.zeros((B, H, W), np.float32)
    clean[:, H // 4: 3 * H // 4, W // 4: 3 * W // 4] = 1.0
    return clean + noise * rng.standard_normal((B, H, W)).astype(np.float32)


def tv_inputs(B, H, W, seed):
    """Operands of one cp_k_steps call: noisy images, a warm state, the
    default stepsizes, a per-image lam and a done mask with about half the
    images frozen."""
    from proxtpu_torch.kernels.tv import default_tv_stepsizes

    rng = np.random.default_rng(seed)
    g1, g2 = default_tv_stepsizes()
    arrays = dict(
        b=tv_images(B, H, W, seed),
        x=rng.standard_normal((B, H, W)).astype(np.float32),
        yx=(0.05 * rng.standard_normal((B, H, W))).astype(np.float32),
        yy=(0.05 * rng.standard_normal((B, H, W))).astype(np.float32),
        g1=np.full(B, g1, np.float32),
        g2=np.full(B, g2, np.float32),
        lam=np.full(B, TV_LAM, np.float32),
        lams=rng.uniform(0.05, 0.3, B).astype(np.float32),
        done=(rng.random(B) < 0.5).astype(np.float32),
    )
    return {k: torch.tensor(v, device=DEVICE) for k, v in arrays.items()}


def check_tv_kernel():
    """cp_k_steps against its plain version, bit for bit: the kernel rounds
    every operation on its own in the plain version's order and a max does
    not depend on the order, so x, yx, yy and res must be equal
    (``torch.equal``).  At TV_CHECK_SHAPES (the cluster variant) and
    TV_HALO (the halo variant), K = 1 and 8, uniform and per-image lam,
    from zero and from a warm state, with and without frozen images (which
    come back bit-equal, copied at done = 1 and left in place at done = 2).
    Returns the largest absolute error."""
    from proxtpu_torch.kernels import _build, tv

    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    worst, variants = 0.0, set()
    for B, H, W in TV_CHECK_SHAPES + [TV_HALO]:
        d = tv_inputs(B, H, W, seed=B + H + W)
        zero = torch.zeros_like(d["b"])
        for k in (1, K):
            plan = tv.cp_plan(B, H, W, k, sms, limit)
            variants.add(plan.variant)
            for lam in (d["lam"], d["lams"]):
                for state in ((zero, zero, zero), (d["x"], d["yx"], d["yy"])):
                    for done in (None, d["done"]):
                        args = (d["b"], *state, d["g1"], d["g2"], lam)
                        want = tv.reference_cp_k_steps(*args, k, done)
                        got = tv.fused_cp_k_steps(*args, k, done)
                        torch.cuda.synchronize()
                        err = max(max_err(g, w) for g, w in zip(got, want))
                        assert all(torch.equal(g, w) for g, w in
                                   zip(got, want)), (B, H, W, k, plan, err)
                        worst = max(worst, err)
                        if done is not None:
                            frozen = done != 0
                            for g, w in zip(got[:3], state):
                                assert torch.equal(g[frozen], w[frozen])
                            assert bool((got[3][frozen] == 0).all())
                            # done = 2: the outputs hold the frozen state
                            out = tuple(w.clone() for w in want[:3])
                            again = tv.fused_cp_k_steps(*args, k, 2 * done,
                                                        out=out)
                            torch.cuda.synchronize()
                            assert all(torch.equal(g, w) for g, w in
                                       zip(again, got)), (B, H, W, k)
            print(f"  cp_k_steps {(B, H, W)} K={k} {plan_text(plan, H)}: "
                  f"x, yx, yy, res equal to the plain version's bits in 8 "
                  f"cases (lam uniform and per image, zero and warm state, "
                  f"{int(d['done'].sum())} images frozen or none)")
    assert variants == {"cluster", "halo"}, variants
    return worst


def plan_text(plan, H):
    if plan.variant == "halo":
        return f"halo variant, tiles of {plan.TH} x {plan.TW}"
    return (f"cluster of {plan.C} x {plan.threads} threads, "
            f"{-(-H // plan.C)} rows a block, {plan.smem} bytes")


def time_tv_kernel(card):
    """cp_k_steps (writing into given buffers, as the solver calls it)
    beside its plain version at the two routes' shapes, K = 8, in an eager
    loop; and the kernel at the device's own pace at K = 1, 2, 4, 8, with
    the intercept and slope of a line through those four times and the
    plan.  Returns ``({shape: (kernel ms, plain ms)}, {("cp_k_steps",
    shape): ms at the device's pace, K = 8})``."""
    import ctypes

    from proxtpu_torch.kernels import _build, tv

    out, pace = {}, {}
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    for B, H, W in TV_SHAPES:
        d = tv_inputs(B, H, W, seed=1)
        args = (d["b"], d["x"], d["yx"], d["yy"], d["g1"], d["g2"], d["lam"])
        bufs = tuple(torch.empty_like(d["b"]) for _ in range(3))
        nbytes = 4 * (7 * B * H * W + 4 * B)
        out[(B, H, W)] = time_pair(
            "cp_k_steps",
            lambda: tv.fused_cp_k_steps(*args, K, None, out=bufs),
            lambda: tv.reference_cp_k_steps(*args, K),
            f"{(B, H, W)} K={K}", card, nbytes)
        ts = [graph_ms(lambda k=k: tv.fused_cp_k_steps(*args, k, None,
                                                       out=bufs))
              for k in TV_KS]
        slope, icpt = np.polyfit(TV_KS, ts, 1)
        pace[("cp_k_steps", (B, H, W))] = ts[-1]
        plan = tv.cp_plan(B, H, W, K, sms, limit)
        held = ctypes.c_int()
        _build.check(_build.library().proxtpu_cp_active_clusters(
            H, W, plan.C, plan.threads, plan.smem, ctypes.byref(held)),
            "cp_active_clusters")
        print(f"    at the device's pace (CUDA graph), K = "
              f"{', '.join(map(str, TV_KS))}: "
              f"{', '.join(f'{1e3 * t:.1f}' for t in ts)} us; intercept "
              f"{1e3 * icpt:.1f} us, slope {1e3 * slope:.1f} us a step; "
              f"{plan_text(plan, H)}, {held.value} clusters at once, "
              f"{B} clusters; bound at K = {K} "
              f"{1e3 * cp_bound(B, H, W)[0]:.1f} us ({nbytes / 1e6:.1f} MB "
              f"over {PEAK_BYTES_S / 1e12} TB/s)  [{card}]")
    return out, pace


def floor_operand(B, M, N, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor((rng.standard_normal((B, M, N)) / np.sqrt(M))
                        .astype(np.float32), device=DEVICE)


def check_read_reduce():
    """read_reduce against A.sum(dim=(1, 2)) at every floor shape and a
    ragged one whose lanes do not start on 16 bytes; two calls give the
    same bits, with the wrapper's own scratch or a given one.  Its bfloat16
    instance likewise against ``A16.float().sum(dim=(1, 2))`` on the same
    operators rounded to bf16.  Returns the largest absolute error of each
    instance."""
    from proxtpu_torch.kernels import probe

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for B, M, N in FLOOR_SHAPES + [(7, 33, 161)]:
        A32 = floor_operand(B, M, N, seed=B + M + N)
        for A in (A32, A32.to(torch.bfloat16)):
            got, again = probe.read_reduce(A), probe.read_reduce(A)
            # with the output and the scratch given, twice on one scratch
            res, scratch = torch.empty(B, device=DEVICE), \
                probe.read_reduce_scratch(A)
            for _ in range(2):
                given = probe.read_reduce(A, out=res, scratch=scratch)
            want = probe.reference_read_reduce(A)
            torch.cuda.synchronize()
            assert given is res
            assert torch.equal(got, again) and torch.equal(got, res), (
                A.dtype, B, M, N)
            err = max_err(got, want)
            rel = float(((got - want).abs()
                         / A.float().abs().sum(dim=(1, 2))).max())
            assert rel <= READ_RTOL, (A.dtype, B, M, N, err, rel)
            worst[A.dtype] = max(worst[A.dtype], err)
            print(f"  read_reduce {str(A.dtype)[6:]:8s} {(B, M, N)}: "
                  f"max|err| {err:.3e}, relative to the lane's sum of |A| "
                  f"{rel:.3e}")
    return worst[torch.float32], worst[torch.bfloat16]


def host_us(fn, batches=5, batch=100):
    """Microseconds of host time per call of ``fn``: the median over
    ``batches`` of the mean of ``batch`` calls by ``time.perf_counter``,
    synchronising between batches, outside the clock, so that a part that
    launches never waits for a full queue."""
    fn()
    ts = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        ts.append(1e6 * (time.perf_counter() - t0) / batch)
    torch.cuda.synchronize()
    return statistics.median(ts)


def read_reduce_host_parts(A, card):
    """Where the host time of one read_reduce call goes: each part of the
    wrapper, as it is and as it was with a plan, two allocations, a device
    context and a boxed stream per call, timed on its own."""
    import ctypes

    from proxtpu_torch.kernels import _build, probe

    B, n = A.shape[0], A.shape[1] * A.shape[2]
    dev = A.device
    sms = _build.sm_count(dev.index)
    S, chunk = probe.chunk_plan(B, n, sms)
    out = torch.empty(B, device=dev)
    scratch = probe.read_reduce_scratch(A)
    entry = _build.library().proxtpu_read_reduce
    raw = torch._C._cuda_getCurrentRawStream(dev.index)
    ptrs = (A.data_ptr(), scratch.data_ptr() + 4 * B, scratch.data_ptr(),
            out.data_ptr())

    def device_context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "get_device_properties(...).multi_processor_count":
            lambda: torch.cuda.get_device_properties(dev)
            .multi_processor_count,
        "sm_count, cached": lambda: _build.sm_count(dev.index),
        "chunk_plan": lambda: probe.chunk_plan(B, n, sms),
        "chunk plan, cached": lambda: probe.cached_chunk_plan(B, n, sms),
        "torch.empty((B, S))": lambda: torch.empty((B, S), device=dev),
        "torch.empty(B)": lambda: torch.empty(B, device=dev),
        "A.new_empty(B)": lambda: A.new_empty(B),
        "stream scratch, cached":
            lambda: probe._stream_scratch(dev.index, raw, B, S),
        "with torch.cuda.device(A.device)": device_context,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "is_current_stream_capturing":
            torch.cuda.is_current_stream_capturing,
        "the checks of A": lambda: (
            A.dim() != 3, A.is_cuda, A.dtype != torch.float32,
            A.is_contiguous(), A.shape, A.get_device()),
        "three data_ptr()": lambda: (A.data_ptr(), scratch.data_ptr(),
                                     out.data_ptr()),
        "_build.library() and the entry's lookup":
            lambda: _build.library().proxtpu_read_reduce,
        "ctypes call (one launch), stream boxed in c_void_p":
            lambda: entry(*ptrs, B, n, S, chunk, ctypes.c_void_p(raw)),
        "ctypes call (one launch), stream as int":
            lambda: entry(*ptrs, B, n, S, chunk, raw),
        "_build.check(0, ...)": lambda: _build.check(0, "read_reduce"),
        "read_reduce(A), whole":
            lambda: probe.read_reduce(A),
        "read_reduce(A, out=, scratch=), whole":
            lambda: probe.read_reduce(A, out=out, scratch=scratch),
        "A.sum(dim=(1, 2)), whole": lambda: A.sum(dim=(1, 2)),
    }
    print(f"    host time per call by part at {tuple(A.shape)} "
          f"(time.perf_counter, median of 5 batches of 100 calls)  [{card}]:")
    for name, fn in parts.items():
        print(f"      {name}: {host_us(fn):.2f} us")


def phase_read_floor(card):
    """The probe's own path: the measured read floor at every step kernel's
    operator shape, beside the library call ``A.sum(dim=(1, 2))`` and the
    datasheet bound.  An operand under the 50 MB of L2 stays there between
    calls, as a solver's operator does between iterations.  Both are timed
    in an eager loop (the probe also with its output and scratch passed
    back in, so that a call allocates nothing) and at the device's own pace
    (the floor proper); at the two main-path shapes the wrapper's host time
    is printed by part.  Returns ``({shape: (kernel ms, library ms)},
    launches)``."""
    from proxtpu_torch.kernels import probe

    probe.read_reduce.launches = 0
    out = {}
    for B, M, N in FLOOR_SHAPES:
        A = floor_operand(B, M, N, seed=1)
        nbytes = A.numel() * 4 + B * 4
        kernel = lambda: probe.read_reduce(A)  # noqa: E731
        library = lambda: A.sum(dim=(1, 2))  # noqa: E731
        out[(B, M, N)] = time_pair("read_reduce", kernel, library,
                                   f"{(B, M, N)}", card, nbytes)
        res, scratch = torch.empty(B, device=DEVICE), \
            probe.read_reduce_scratch(A)
        reuse = lambda: probe.read_reduce(  # noqa: E731
            A, out=res, scratch=scratch)
        lean = statistics.median(time_ms(reuse, reps=10)
                                 + time_ms(reuse, reps=10))
        print(f"    eager with out= and scratch= passed back in: kernel "
              f"{1e3 * lean:.1f} us")
        print(f"    at the device's pace (CUDA graph): kernel "
              f"{1e3 * graph_ms(reuse):.1f} us, library "
              f"{1e3 * graph_ms(library):.1f} us; bound "
              f"{1e3 * read_bound(B, M, N)[0]:.1f} us ({nbytes / 1e6:.1f} MB "
              f"over {PEAK_BYTES_S / 1e12} TB/s)  [{card}]")
        if (B, M, N) in MAIN_SHAPES:
            read_reduce_host_parts(A, card)
    return out, probe.read_reduce.launches


def tv_recheck(b, lam, x, y):
    """One Chambolle-Pock step from (x, y) in float64 on the host: the
    largest ||xbar - x||_inf + ||ybar - y||_inf over the images, the
    solver's own stopping quantity at the returned point."""
    from proxtpu_torch.kernels.tv import default_tv_stepsizes

    g1, g2 = default_tv_stepsizes()
    b, x, y = (np.asarray(v, np.float64) for v in (b, x, y))
    yx, yy = y[:, 0].copy(), y[:, 1].copy()
    yx[:, -1, :] = 0.0
    yy[:, :, -1] = 0.0
    div = yx + yy
    div[:, 1:, :] -= yx[:, :-1, :]
    div[:, :, 1:] -= yy[:, :, :-1]
    xbar = (x + g1 * div + g1 * b) / (1 + g1)
    mid = 2 * xbar - x
    v = y.copy()
    v[:, 0, :-1, :] += g2 * (mid[:, 1:, :] - mid[:, :-1, :])
    v[:, 1, :, :-1] += g2 * (mid[:, :, 1:] - mid[:, :, :-1])
    nrm = np.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2)
    scale = np.where(nrm > lam, lam / np.maximum(nrm, 1e-30), 1.0)
    ybar = v * scale[:, None]
    return float(np.max(np.abs(xbar - x).max(axis=(1, 2))
                        + np.abs(ybar - y).max(axis=(1, 2, 3))))


def tv_route(noisy):
    """``solve(use_kernels)`` and ``check(x, y)`` for the TV problem on
    ``noisy`` (B, H, W) through ``BatchedAlgorithm``."""
    from proxtpu_torch import (
        BatchedAlgorithm,
        make_chambolle_pock_iteration,
        tv_from_numpy,
    )
    from proxtpu_torch.ops import Grad2DOperator
    from proxtpu_torch.prox import NormL21, SqrDistance

    B, H, W = noisy.shape
    b, lam = tv_from_numpy(noisy, TV_LAM, device=DEVICE)
    kw = dict(x0=torch.zeros_like(b),
              y0=torch.zeros((B, 2, H, W), device=DEVICE), g=SqrDistance(b),
              h=NormL21(lam, axis=0), L=Grad2DOperator((H, W)))
    solve = lambda use: BatchedAlgorithm(  # noqa: E731
        make_chambolle_pock_iteration, maxit=TV_MAXIT, tol=TV_TOL,
        use_kernels="auto" if use else False)(**kw)
    check = lambda x, y: tv_recheck(noisy, TV_LAM, x, y)  # noqa: E731
    return solve, check


def check_tv_contract_small():
    """The reference's cross-path contract for TV at its test shape
    (tests/test_tv_kernel.py:27-29, 177-192): the kernel route against the
    generic driver, every image done, x within 1e-3, counts an upper bound
    within one block: in [iters - 1, iters + 8]."""
    solve, _ = tv_route(tv_images(4, 16, 24))
    (x, y), it, done = solve(True)
    (x_g, y_g), it_g, done_g = solve(False)
    assert bool(done.all()) and bool(done_g.all())
    dx = max_err(x, x_g)
    assert dx <= 1e-3, dx
    assert bool((it >= it_g - 1).all()) and bool((it <= it_g + 8).all()), (
        it, it_g)
    print(f"  TV (4, 16, 24): kernel route iterations {it.tolist()}, generic "
          f"driver {it_g.tolist()}, max|d x| {dx:.2e}")


def phase_tv_routes(card, pace):
    """Routes (e) and (f): the TV configuration of benchmarks/tv_bench.py at
    64 x 64 and at 256 x 256, 64 images each, with the device time per solve
    (every launch at K = 8's time: the one init launch at K = 1 is counted
    high).  Returns the launches per kernel summed over the two."""
    total = {}
    for tag, (B, H, W) in zip("ef", TV_SHAPES):
        solve, check = tv_route(tv_images(B, H, W))
        launches = drive(f"route ({tag}) TV {(B, H, W)}", solve, check,
                         TV_TOL, card, ("cp_k_steps",), dx_tol=1e-3,
                         pace=pace, shape=(B, H, W))
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
    return total


def recheck(As, bs, lams, Lfs, xs):
    """bench.py's residual recheck: the f32 FB residual of every lane."""
    gam = (1.0 / Lfs)[:, None]
    grad = np.einsum("bmn,bm->bn", As, np.einsum("bmn,bn->bm", As, xs) - bs)
    y = xs - gam * grad
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lams[:, None], 0.0)
    return float(np.max(np.max(np.abs(xs - z), axis=1) / gam[:, 0]))


def check_contract_small():
    """The reference's cross-path contract, kernel route vs plain route on
    the card, at the reference tests' shapes, where the JAX package holds
    it itself (tests/test_kernels.py:49-61, :94-149, :218-266): every lane
    done, counts within +-1, solutions within 1e-4.  The blocked solvers,
    whose counts are sampled every K, are held at the shapes of the
    reference's blocked tests (:218-266) to +-K and 1e-4, and on each route
    to the reference's blocked contract: counts no lower than the one-step
    solver's less 1 (FISTA's residual is not monotone, so a sampled count
    is an upper bound, not one within K), solutions within 5e-4 (lasso) and
    2e-3 (box QP) of the one-step solver's."""
    from proxtpu_torch import box_qp_from_numpy, problems_from_numpy
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.tools import problems
    from proxtpu_torch.kernels import lasso as tl

    def hold(name, shape, kw, kernel, plain, slack):
        z1, i1, d1 = kernel
        z2, i2, d2 = plain
        assert bool(d1.all()) and bool(d2.all()), (name, shape, kw)
        dit = int((i1 - i2).abs().max())
        dz = max_err(z1, z2)
        assert dit <= slack and dz <= 1e-4, (name, shape, kw, dit, dz)
        print(f"  {name} {shape} {kw}: max|d iters| {dit}, "
              f"max|d x| {dz:.2e}")

    def upper_bound(name, blocked, one_step, atol):
        for (zb, ib, _), (z1, i1, _) in zip(blocked, one_step):
            assert bool((ib >= i1 - 1).all()), (name, ib, i1)
            assert max_err(zb, z1) <= atol, (name, max_err(zb, z1))

    for (B, M, N, seed) in ((5, 16, 24, 0), (8, 16, 160, 5)):
        rng = np.random.default_rng(seed)
        As = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
        bs = rng.standard_normal((B, M)).astype(np.float32)
        lams = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
        Lfs = np.array([np.linalg.norm(a, 2) ** 2 for a in As])
        P = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)
        for restart in (False, True):
            runs = {}
            for solver, kw in (
                    (tl.solve_lasso_batch, {}),
                    (tl.solve_lasso_batch_packed_tail,
                     dict(k1=40, tail=B // 2)),
                    (tl.solve_lasso_batch_blocked, dict(iter_block=K))):
                if kw.get("iter_block") and (B, M, N) != (5, 16, 24):
                    continue
                runs[solver] = [solver(*P, TOL, maxit=3000, restart=restart,
                                       use_kernel=use, **kw)
                                for use in (True, False)]
                hold(solver.__name__, (B, M, N), dict(restart=restart),
                     *runs[solver], K if kw.get("iter_block") else 1)
            if tl.solve_lasso_batch_blocked in runs:
                upper_bound("solve_lasso_batch_blocked",
                            runs[tl.solve_lasso_batch_blocked],
                            runs[tl.solve_lasso_batch], 5e-4)
    for (B, n, seed) in ((6, 16, 0), (8, 16, 3)):
        Qs, qs, gam = problems.box_qp_problems(B, n, seed)
        Q, q, lo, hi, Lip = box_qp_from_numpy(Qs, qs, -1.0, 1.0, 0.95 / gam,
                                              device=DEVICE)
        runs = {}
        for solver, kw in ((tb.solve_box_qp_batch, {}),
                           (tb.solve_box_qp_batch_blocked,
                            dict(iter_block=K))):
            if kw and (B, n, seed) != (8, 16, 3):
                continue
            runs[solver] = [solver(Q, q, lo, hi, Lip, 1e-4, use_kernel=use,
                                   **kw) for use in (True, False)]
            hold(solver.__name__, (B, n), {}, *runs[solver],
                 K if kw else 1)
        if tb.solve_box_qp_batch_blocked in runs:
            upper_bound("solve_box_qp_batch_blocked",
                        runs[tb.solve_box_qp_batch_blocked],
                        runs[tb.solve_box_qp_batch], 2e-3)


def box_residuals(Qs, qs, gammas, xs):
    """Every lane's ||x - clip(x - gamma (Q x + q), -1, 1)||_inf / gamma,
    in float64."""
    x = xs.astype(np.float64)
    g = gammas.astype(np.float64)[:, None]
    grad = np.einsum("bij,bj->bi", Qs.astype(np.float64), x) + qs
    return np.max(np.abs(x - np.clip(x - g * grad, -1, 1)), axis=1) / g[:, 0]


def box_recheck(Qs, qs, gammas, xs):
    """The largest of :func:`box_residuals`."""
    return float(np.max(box_residuals(Qs, qs, gammas, xs)))


def device_time(parts, pace, wall, card):
    """Print the device time of one solve, launches x the kernel's time at
    the device's pace (``pace`` of time_kernels) summed over ``parts`` =
    ``[(kernel, shape, launches)]``, beside the solve's wall seconds."""
    total = sum(n * pace[(k, shape)] for k, shape, n in parts)
    terms = " + ".join(f"{n:g} {k} {shape} x {1e3 * pace[(k, shape)]:.1f} us"
                       for k, shape, n in parts)
    print(f"  device time per solve: {terms} = {total:.3f} ms, "
          f"{100 * total / (1e3 * wall):.1f}% of {wall:.4f} s of wall  "
          f"[{card}]")


def phase_main_path(card, pace):
    from proxtpu_torch.tools import problems
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.parallel import stream_solve

    As, bs, lams, Lfs = problems.lasso_problems(problems.BATCH)
    A, b, lam, Lf = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)

    def solve(use_kernel=True):
        return tl.solve_lasso_batch_packed_tail(
            A, b, lam, Lf, TOL, maxit=MAXIT, k1=192, tail=64, restart=True,
            use_kernel=use_kernel)

    solve()  # warm-up
    torch.cuda.synchronize()
    tl.fused_fb_prox_grad.launches = 0
    tl.fused_fista_full_step.launches = 0
    t0 = time.perf_counter()
    outs = list(stream_solve(lambda _: solve(), range(N_STREAM), depth=2))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_STREAM
    launches = {"fb_step": tl.fused_fb_prox_grad.launches,
                "fista_step": tl.fused_fista_full_step.launches}
    print(f"main path launches over {N_STREAM} solves: {launches}")
    assert all(n > 0 for n in launches.values()), launches

    xs, iters, done = outs[0]
    for other in outs[1:]:  # the kernels are deterministic
        assert all(torch.equal(a, b) for a, b in zip(other, outs[0]))
    assert bool(done.all()), f"{int((~done).sum())} lanes not converged"
    xs_np, it_np = xs.cpu().numpy(), iters.cpu().numpy()
    worst = recheck(As, bs, lams, Lfs, xs_np)
    assert worst <= 1.1 * TOL, worst
    assert np.isfinite(xs_np).all() and xs_np.shape == (problems.BATCH,
                                                         problems.N)
    print(f"main path: {problems.BATCH} lanes done, worst residual recheck "
          f"{worst:.3e} (limit {1.1 * TOL:.1e}), iterations mean "
          f"{it_np.mean():.2f} max {it_np.max()}  [{card}]")
    print(f"main path: {dt:.4f} s per solve, {problems.BATCH / dt:.1f} "
          f"problems/s (stream_solve depth 2, {N_STREAM} solves after one "
          f"warm-up)  [{card}]")
    # the bulk phase runs k1 = 192 steps at full width, the narrow phase the
    # rest at tail = 64 after its one fb_step
    per_solve = {k: n / N_STREAM for k, n in launches.items()}
    assert per_solve["fista_step"] >= 192 and per_solve["fb_step"] == 1
    device_time([("fista_step", MAIN_SHAPES[0], 192),
                 ("fista_step", MAIN_SHAPES[1],
                  per_solve["fista_step"] - 192),
                 ("fb_step", MAIN_SHAPES[1], 1)], pace, dt, card)

    # The plain route on the card.  At this width the two routes sum in
    # different orders and their trajectories part: the JAX package's own
    # kernel and XLA routes differ by up to 4 iterations (restart) on
    # bench.gen_problems(64) on the CPU (ROADMAP.md queue 3), so the +-1 /
    # 1e-4 contract is held at the test shapes in check_contract_small.
    # Here the plain route must converge every lane; its recheck, which
    # sits as near the 1.1 * tol gate as the kernel route's, is reported.
    xs_p, it_p, done_p = solve(use_kernel=False)
    assert bool(done_p.all()), f"{int((~done_p).sum())} plain lanes left"
    worst_p = recheck(As, bs, lams, Lfs, xs_p.cpu().numpy())
    dit = (iters - it_p).abs()
    print(f"plain route: worst recheck {worst_p:.3e}, iterations mean "
          f"{it_p.float().mean():.2f} max {int(it_p.max())}; kernel vs "
          f"plain: max|d iters| {int(dit.max())} ({int((dit > 1).sum())} "
          f"lanes > 1), max|d x| {max_err(xs, xs_p):.3e}")
    return launches


def launch_counters():
    """``{kernel: (wrapper, attribute)}``: the attribute of the wrapper that
    counts the kernel's launches (the one-step lasso wrappers count their
    float32 and bfloat16 instances apart)."""
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.kernels import probe, tv

    return {"cp_k_steps": (tv.fused_cp_k_steps, "launches"),
            "read_reduce": (probe.read_reduce, "launches"),
            "read_reduce_bf16": (probe.read_reduce, "launches_bf16"),
            "fb_step": (tl.fused_fb_prox_grad, "launches"),
            "fista_step": (tl.fused_fista_full_step, "launches"),
            "fb_step_bf16": (tl.fused_fb_prox_grad, "launches_bf16"),
            "fista_step_bf16": (tl.fused_fista_full_step, "launches_bf16"),
            "fista_k_steps": (tl.fused_fista_k_steps, "launches"),
            "pg_step": (tb.fused_pg_box_step, "launches"),
            "pg_k_steps": (tb.fused_pg_box_k_steps, "launches")}


def drive(name, solve, check, tol, card, expect, dx_tol=None, pace=None,
          shape=None):
    """Drive one route (``solve(use_kernels)``): once on the kernel route
    with every launch counter set to 0 just before and read just after
    (the counts this route adds to the kernels' JSON line), once on the
    plain route, which must launch no kernel.  Every lane done on both;
    ``check`` rechecks a solution (the arrays of its structure) on the
    host, held to 2 tol on both; ``expect`` lists the kernels the route
    must launch, and no other kernel may launch.  ``dx_tol``, where given,
    bounds the distance of the two routes' primal solutions.  With ``pace``
    (time_kernels') and the route's ``shape``, the device time per solve is
    printed beside the wall."""
    def arrays(sol):
        sol = sol if isinstance(sol, tuple) else (sol,)
        return [t.cpu().numpy() for t in sol]

    counters = launch_counters()

    def read():
        return {k: getattr(w, a) for k, (w, a) in counters.items()}

    solve(True)  # warm-up (the kernel route's first call)
    torch.cuda.synchronize()
    for w, a in counters.values():
        setattr(w, a, 0)
    t0 = time.perf_counter()
    xs, iters, done = solve(True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read()
    t0 = time.perf_counter()
    xs_p, it_p, done_p = solve(False)
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    assert read() == launches, f"{name}: the plain route launched a kernel"
    assert bool(done.all()), f"{name}: {int((~done).sum())} lanes left"
    assert bool(done_p.all()), f"{name}: {int((~done_p).sum())} plain left"
    moved = {k for k, n in launches.items() if n > 0}
    assert moved == set(expect), (name, launches, expect)
    sol, sol_p = arrays(xs), arrays(xs_p)
    assert all(np.isfinite(a).all() and a.shape == a_p.shape
               for a, a_p in zip(sol, sol_p))
    r, r_p = check(*sol), check(*sol_p)
    assert r <= 2 * tol and r_p <= 2 * tol, (name, r, r_p)
    xs, xs_p = (v[0] if isinstance(v, tuple) else v for v in (xs, xs_p))
    if dx_tol is not None:
        assert max_err(xs, xs_p) <= dx_tol, (name, max_err(xs, xs_p))
    dit = (iters - it_p).abs()
    print(f"{name}: launches {launches}; kernel route {dt:.4f} s, "
          f"recheck {r:.3e}, iterations mean {iters.float().mean():.2f} "
          f"max {int(iters.max())}; plain route {dt_p:.4f} s, recheck "
          f"{r_p:.3e}, iterations mean {it_p.float().mean():.2f} max "
          f"{int(it_p.max())}; max|d iters| {int(dit.max())}, max|d x| "
          f"{max_err(xs, xs_p):.3e}  [{card}]")
    if pace is not None:
        device_time([(k, shape, launches[k]) for k in expect], pace, dt, card)
    return launches


def phase_routes(card, pace):
    """Routes (a) to (d) of the library entry point at full width.
    Returns the launches per kernel summed over the routes."""
    from proxtpu_torch.tools import problems
    from proxtpu_torch import (
        AdaptiveRestartSequence,
        BatchedAlgorithm,
        FixedNesterovSequence,
        make_fast_forward_backward_iteration as ffb,
        make_forward_backward_iteration as fb,
    )
    from proxtpu_torch.prox import IndBox, LeastSquaresLoss, NormL1, Quadratic

    def lasso_route(As, bs, lams, Lfs, maxit, **extra):
        A, b, lam, Lf = (torch.tensor(v, device=DEVICE)
                         for v in (As, bs, lams, Lfs))
        kw = dict(x0=torch.zeros(A.shape[0], A.shape[2], device=DEVICE),
                  f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf, **extra)
        solve = lambda use: BatchedAlgorithm(  # noqa: E731
            ffb, maxit=maxit, tol=TOL,
            use_kernels="auto" if use else False)(**kw)
        check = lambda xs: recheck(As, bs, lams, Lfs, xs)  # noqa: E731
        return solve, check

    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # (a) the DMA-bound lasso shape: the blocked solver at K = 8
    prob = problems.lasso_problems(*BLOCKED_SHAPES[0])
    for extra in ({}, {"extrapolation_sequence":
                       AdaptiveRestartSequence(FixedNesterovSequence())}):
        solve, check = lasso_route(*prob, 3000, **extra)
        add(drive(f"route (a) {BLOCKED_SHAPES[0]} restart={bool(extra)}",
                  solve, check, TOL, card, ("fb_step", "fista_k_steps")))
    del prob
    # (b) the nonconvex box-QP family, n = 512, B = 64
    B, n = BOX_SHAPES[0]
    Qs, qs, gam = problems.box_qp_problems(B, n, seed=7)
    kw = dict(x0=torch.zeros(B, n, device=DEVICE),
              f=Quadratic(torch.tensor(Qs, device=DEVICE),
                          torch.tensor(qs, device=DEVICE)),
              g=IndBox(-1.0, 1.0), gamma=torch.tensor(gam, device=DEVICE))
    add(drive(f"route (b) box QP {(B, n)}",
              lambda use: BatchedAlgorithm(
                  fb, maxit=10_000, tol=1e-4,
                  use_kernels="auto" if use else False)(**kw),
              lambda xs: box_recheck(Qs, qs, gam, xs), 1e-4, card,
              ("pg_step", "pg_k_steps"), pace=pace, shape=(B, n)))
    # (c) the flagship through the library entry point: the packed solver
    solve, check = lasso_route(*problems.lasso_problems(problems.BATCH),
                               3000)
    add(drive(f"route (c) flagship {MAIN_SHAPES[0]}", solve, check, TOL,
              card, ("fista_step",), pace=pace, shape=MAIN_SHAPES[0]))
    # (d) tall strongly convex problems, mf = the smallest sigma_min^2
    rng = np.random.default_rng(0)
    B, M, N = problems.BATCH, problems.N, problems.M
    As = (rng.standard_normal((B, M, N)) / np.sqrt(M)).astype(np.float32)
    bs = rng.standard_normal((B, M)).astype(np.float32)
    lams = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", As, bs)), axis=1)
            ).astype(np.float32)
    sv = np.linalg.svd(As.astype(np.float64), compute_uv=False)
    Lfs = (sv[:, 0] ** 2).astype(np.float32)
    mf = float(np.min(sv[:, -1] ** 2))
    solve, check = lasso_route(As, bs, lams, Lfs, 3000, mf=mf)
    add(drive(f"route (d) tall {(B, M, N)} mf={mf:.4f}", solve, check, TOL,
              card, ("fb_step", "fista_step"), pace=pace, shape=(B, M, N)))
    return total


def profiled_device_ms(fn):
    """The device time of one call of ``fn`` in ms: the kernels' self time
    summed over a ``torch.profiler`` trace of the call (cuBLAS and PyTorch's
    own kernels included), or None where the trace holds no device time.
    The profiler slows the host, so the call's wall is not read here.
    Returns ``(ms, text)``, the text with the seconds the trace took."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    # the device's activity only: recording every host operation as well
    # costs the host far more than the solve
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages())
    ms = us / 1e3 if us > 0 else None
    text = "not measured" if ms is None else f"{ms:.3f} ms"
    return ms, f"{text} (torch.profiler, {time.perf_counter() - t0:.1f} s)"


def shared_problem():
    """The shared-A lasso path of benchmarks/shared_bench.py:43-60: one A of
    200 x 400 and one b (seed 0), 256 lambdas log-spaced from 0.02 to 0.5
    lambda_max, Lf = ||A||_2^2."""
    from proxtpu_torch.tools import problems

    return problems.shared_lasso_problem()


def shared_recheck(A, b, lams, Lf, xs):
    """The float32 FB residual of every lane on the shared A."""
    gam = np.float32(1.0 / Lf)
    y = xs - gam * ((xs @ A.T - b) @ A)
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lams[:, None], 0.0)
    return float(np.max(np.abs(xs - z)) / gam)


def phase_lasso_rest(card, pace):
    """Routes (g) to (j): the shared-A path, the mixed-precision solver, the
    over-relaxed solvers and the compacting driver at full width.  Returns
    the launches per kernel summed over the driven routes."""
    from proxtpu_torch.tools import problems
    from proxtpu_torch import (
        AdaptiveRestartSequence,
        BatchedAlgorithm,
        FixedNesterovSequence,
        Shared,
        make_fast_forward_backward_iteration as ffb,
        problems_from_numpy,
    )
    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.prox import LeastSquaresLoss, NormL1

    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # (g) one A for 256 lambdas: dispatch takes solve_lasso_multirhs, whose
    # two products a step are torch.matmul; no hand-written kernel runs
    A, b, lams, Lf = shared_problem()
    calls = []
    real = tl.solve_lasso_multirhs

    def counted(*args, **kw):
        calls.append(kw["iter_block"])
        return real(*args, **kw)

    tl.solve_lasso_multirhs = counted
    try:
        for restart in (False, True):
            kw = dict(x0=torch.zeros(len(lams), A.shape[1], device=DEVICE),
                      f=Shared(LeastSquaresLoss(
                          torch.tensor(A, device=DEVICE),
                          torch.tensor(b, device=DEVICE))),
                      g=NormL1(torch.tensor(lams, device=DEVICE)), Lf=Lf)
            if restart:
                kw["extrapolation_sequence"] = AdaptiveRestartSequence(
                    FixedNesterovSequence())
            del calls[:]
            solve = lambda use: BatchedAlgorithm(  # noqa: E731
                ffb, maxit=3000, tol=TOL,
                use_kernels="auto" if use else False)(**kw)
            add(drive(f"route (g) shared A {A.shape}, {len(lams)} lambdas "
                      f"restart={restart}", solve,
                      lambda xs: shared_recheck(A, b, lams, Lf, xs), TOL,
                      card, ()))
            _, text = profiled_device_ms(lambda: solve(True))
            print(f"  device time per solve (cuBLAS and PyTorch's "
                  f"kernels): {text}  [{card}]")
            # the warm-up, the timed and the profiled solve, all at K = 1
            assert calls == [1, 1, 1], calls
    finally:
        tl.solve_lasso_multirhs = real
    print("  route (g): both kernel-route solves reached "
          "solve_lasso_multirhs at iter_block = 1")

    As, bs, lams, Lfs = problems.lasso_problems(problems.BATCH)
    P = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)
    check = lambda xs: recheck(As, bs, lams, Lfs, xs)  # noqa: E731
    # (h) the bf16 warm stage, then the float32 polish
    for restart in (False, True):
        launches = drive(
            f"route (h) solve_lasso_batch_mixed {MAIN_SHAPES[0]} "
            f"restart={restart}",
            lambda use: tl.solve_lasso_batch_mixed(
                *P, TOL, maxit=3000, use_kernel=use, restart=restart),
            check, TOL, card,
            ("fb_step", "fista_step", "fb_step_bf16", "fista_step_bf16"),
            pace=pace, shape=MAIN_SHAPES[0])
        ms = sum(n * pace[(k, MAIN_SHAPES[0])] for k, n in launches.items()
                 if n)
        print(f"  route (h) restart={restart}: bf16 instances "
              f"{launches['fb_step_bf16']} fb_step + "
              f"{launches['fista_step_bf16']} fista_step, float32 "
              f"{launches['fb_step']} + {launches['fista_step']}; device "
              f"{ms:.3f} ms per solve, where the bf16 instances on the "
              f"float32 kernels' design took "
              f"{H_DEVICE_MS_F32_DESIGN[restart]} ms  [{card}]")
        add(launches)
    # (i) over-relaxed restart-FISTA, beside restart alone
    _, it_r, done_r = tl.solve_lasso_batch_packed(*P, TOL, maxit=3000,
                                                  restart=True)
    assert bool(done_r.all())
    for solver, expect in ((tl.solve_lasso_batch_packed, ("fista_step",)),
                           (tl.solve_lasso_batch,
                            ("fb_step", "fista_step"))):
        add(drive(f"route (i) {solver.__name__} step_mult=1.5 restart=True "
                  f"{MAIN_SHAPES[0]}",
                  lambda use: solver(*P, TOL, maxit=3000, restart=True,
                                     step_mult=1.5, use_kernel=use),
                  check, TOL, card, expect, pace=pace,
                  shape=MAIN_SHAPES[0]))
    print(f"  route (i) beside restart alone (solve_lasso_batch_packed, "
          f"step_mult=1): iterations mean {it_r.float().mean():.2f} max "
          f"{int(it_r.max())}")
    # (j) the compacting driver against solve_lasso_batch, kernel route
    rng = np.random.default_rng(5)
    spread = (lams * (0.2 + 0.8 * rng.random(len(lams)))).astype(np.float32)
    P = problems_from_numpy(As, bs, spread, Lfs, device=DEVICE)
    counters = launch_counters()
    for restart in (False, True):
        runs = {}
        for solver in (tl.solve_lasso_batch, tl.solve_lasso_batch_compacting):
            solver(*P, TOL, maxit=3000, restart=restart)  # warm-up
            torch.cuda.synchronize()
            for w, a in counters.values():
                setattr(w, a, 0)
            t0 = time.perf_counter()
            out = solver(*P, TOL, maxit=3000, restart=restart)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
            add(launches)
            _, dev = profiled_device_ms(
                lambda: solver(*P, TOL, maxit=3000, restart=restart))
            runs[solver.__name__] = (out, wall, launches, dev)
        (ref, dt_ref, l_ref, dev_ref), (got, dt, l_got, dev) = runs.values()
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), (
            "route (j): compacting differs from solve_lasso_batch", restart)
        assert bool(got[2].all()), f"route (j): {int((~got[2]).sum())} left"
        r = recheck(As, bs, spread, Lfs, got[0].cpu().numpy())
        assert r <= 2 * TOL, r
        it = got[1].float()
        print(f"route (j) solve_lasso_batch_compacting restart={restart} "
              f"{MAIN_SHAPES[0]}, lambda spread: counts, done flags and "
              f"solutions equal to solve_lasso_batch's; recheck {r:.3e}, "
              f"iterations mean {it.mean():.2f} max {int(it.max())}; "
              f"compacting {dt:.4f} s ({l_got['fb_step']} fb_step, "
              f"{l_got['fista_step']} fista_step; device {dev}), "
              f"solve_lasso_batch {dt_ref:.4f} s ({l_ref['fb_step']} + "
              f"{l_ref['fista_step']}; device {dev_ref})  [{card}]")
    return total

# The reference suite: the ten configurations of benchmarks/run_benchmarks.py
# on lasso_medium in float64 (Douglas-Rachford on lasso_small:
# reference_suite.TIMED_ON).  Per configuration: the JAX package's count in
# benchmarks/results_cpu_f64.jsonl (printed, not gated) and the recheck
# bound, twice the JAX package's own float64 recheck of the same
# configuration on the CPU, never below 1.1 tol, from
#   PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_reference_suite.py
SUITE = {
    "ForwardBackward": (2811, 1.985366e-06),
    "FastForwardBackward": (3912, 1.590724e-06),
    "ZeroFPR": (89, 1.1e-06),
    "PANOC": (213, 1.218313e-06),
    "PANOCplus": (220, 1.1e-06),
    "DouglasRachford": (5175, 1.899592e-03),  # on lasso_small
    "DRLS": (195, 1.858983e-06),
    "AFBA-1": (1389, 1.385459e-02),
    "AFBA-2": (1366, 2.389176e-03),
    "SFISTA": (2165, 1.365401e-03),
}
# the float32 line (PANOC, ZeroFPR at tol 1e-6, DRLS at 1e-4: see
# reference_suite.FLOAT32_LINE): twice the JAX package's float32 recheck at
# the same tolerance, from the same command.  The 1e-4 the FB recheck would
# ask of float32 is below what the JAX package reaches there (1.5e-4)
SUITE_F32 = {"PANOC": 3.073568e-04, "ZeroFPR": 2.938888e-04,
             "DRLS": 5.542764e-04}
SUITE_BUDGET_S = 120.0
SUITE_BATCH = (64, 50, 100)  # lasso_small's shape, numpy rng 0
SUITE_BATCH_CHECKED = 2  # lanes held against single solves (run time)
SUITE_WARM_MAXIT = 20  # a warm-up's iterations: first uses, not a solve


def suite_solve(solver, kw):
    """One solve on the card with its wall; the solution must stay there."""
    from proxtpu_torch.tools.reference_suite import primal

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sol, it = solver(**kw)
    x = primal(sol)
    torch.cuda.synchronize()
    assert x.device.type == torch.device(DEVICE).type, \
        "a reference-suite solve left the card"
    return x, it, time.perf_counter() - t0


def suite_warm_up(solver, kw):
    """``solver`` capped at SUITE_WARM_MAXIT iterations on ``kw``: the
    timed solve's first uses (allocations, library handles) without its
    cost."""
    import copy

    capped = copy.copy(solver)
    capped.maxit = SUITE_WARM_MAXIT
    suite_solve(capped, kw)


def suite_on_card(workload, dtype):
    from proxtpu_torch.tools import reference_suite as rs

    A, b, lam = rs.load_workload(workload)
    return rs.solver_configs(
        torch.tensor(A, dtype=dtype, device=DEVICE),
        torch.tensor(b, dtype=dtype, device=DEVICE), lam)


def stack_lanes(objs):
    """One function object whose tensor fields stack those of ``objs``."""
    import dataclasses

    first = objs[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(o, f.name) for o in objs])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)})


def suite_batched(card):
    """BatchedAlgorithm(PANOC | ZeroFPR | DRLS) on 64 random lassos of
    lasso_small's shape on the generic driver under torch.func.vmap, the
    masked searches injected (PANOC and ZeroFPR with the adaptive step, as
    in the suite; DRLS with Lf).  Every lane done and rechecked on the host
    to 2 tol (the library routes' gate); the first SUITE_BATCH_CHECKED
    lanes against their single host solves on the card, within 1e-5.
    Under vmap a matvec is one batched product, which adds in another
    order than a single one, so a line search's near-tie decision can flip
    late in a solve: the count agreement is printed, not gated."""
    from proxtpu_torch.tools.reference_suite import fb_recheck

    import proxtpu_torch as pt
    from proxtpu_torch.prox import functions as fns

    B, m, n = SUITE_BATCH
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, m, n))
    b = rng.standard_normal((B, m))
    lam = 0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A, b)), axis=1)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A])
    At, bt = (torch.tensor(v, device=DEVICE) for v in (A, b))
    lam_t, Lf_t = (torch.tensor(v, device=DEVICE) for v in (lam, Lf))
    x0 = torch.zeros(B, n, dtype=torch.float64, device=DEVICE)
    ls = [fns.make_least_squares(At[i], bt[i]) for i in range(B)]
    cases = {
        "PANOC": (pt.make_panoc_iteration,
                  dict(x0=x0, f=fns.SqrDistance(bt), A=At,
                       g=fns.NormL1(lam_t))),
        "ZeroFPR": (pt.make_zerofpr_iteration,
                    dict(x0=x0, f=fns.SqrDistance(bt), A=At,
                         g=fns.NormL1(lam_t))),
        "DRLS": (pt.make_drls_iteration,
                 dict(x0=x0, f=stack_lanes(ls), g=fns.NormL1(lam_t),
                      Lf=Lf_t)),
    }
    for name, (factory, kw) in cases.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, iters, done = pt.BatchedAlgorithm(
            factory, maxit=1000, tol=1e-6, use_kernels=False)(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert xs.device.type == torch.device(DEVICE).type and bool(
            done.all()), (name, int((~done).sum()))
        xs_h = xs.cpu().numpy()
        r = max(fb_recheck(A[i], b[i], lam[i], xs_h[i]) for i in range(B))
        exact, d_it, d_x = 0, 0, 0.0
        for i in range(SUITE_BATCH_CHECKED):
            lane = dict(x0=x0[i], g=fns.NormL1(float(lam[i])))
            if name == "DRLS":
                lane.update(f=ls[i], Lf=float(Lf[i]))
            else:
                lane.update(f=fns.SqrDistance(bt[i]), A=At[i])
            x, it, _ = suite_solve(getattr(pt, name)(tol=1e-6), lane)
            exact += int(iters[i]) == it
            d_it = max(d_it, abs(int(iters[i]) - it))
            d_x = max(d_x, max_err(xs[i], x))
        assert r <= 2e-6 and d_x <= 1e-5, (name, r, d_x)
        print(f"  batched {name}: {B} lanes of {m} x {n} float64 on the "
              f"generic driver under vmap, {wall:.3f} s, iterations mean "
              f"{iters.float().mean():.2f} max {int(iters.max())}, "
              f"recheck max {r:.3e}; lanes "
              f"0-{SUITE_BATCH_CHECKED - 1} against single solves: "
              f"{exact}/{SUITE_BATCH_CHECKED} counts equal, max|d iters| "
              f"{d_it}, max|d x| {d_x:.3e}  [{card}]")


def phase_reference_suite(card):
    """The reference's benchmark matrix on the port: the ten configurations
    of benchmarks/run_benchmarks.py, each warmed up on lasso_tiny
    (:func:`suite_warm_up`) and timed once on lasso_medium, in float64 on
    the card; a float64 host recheck of every answer against its bound;
    then PANOC, ZeroFPR and DRLS in float32 (full float32 matmuls), and the
    batched line.  No kernel of
    the port lies on this path: every launch counter stays at 0."""
    import proxtpu_torch as pt
    from proxtpu_torch.tools import reference_suite as rs
    from proxtpu_torch.utils.precision import require_full_f32_matmul

    t_phase = time.perf_counter()
    counters = launch_counters()
    for w, a in counters.values():
        setattr(w, a, 0)
    A, b, lam = rs.load_workload("lasso_medium")
    warm = suite_on_card("lasso_tiny", torch.float64)
    timed = {w: suite_on_card(w, torch.float64)
             for w in {"lasso_medium", *rs.TIMED_ON.values()}}
    rows = {}
    for name in rs.CONFIGS:
        workload = rs.TIMED_ON.get(name, "lasso_medium")
        solver, kw = timed[workload][name]
        suite_warm_up(*warm[name])
        x, it, wall = suite_solve(solver, kw)
        rows[name] = (workload, x, it, wall, it < solver.maxit,
                      rs.fb_recheck(*rs.load_workload(workload),
                                    x.cpu().numpy()))
    x_ffb = rows["FastForwardBackward"][1]
    print(f"  lasso_medium {A.shape[0]} x {A.shape[1]} float64, x0 = 0; "
          f"configuration: iterations (JAX CPU record), wall, converged, "
          f"recheck <= bound, max|x - x_FFB|  [{card}]")
    for name, (workload, x, it, wall, converged, r) in rows.items():
        record, limit = SUITE[name]
        apart = (f"{max_err(x, x_ffb):.3e}" if workload == "lasso_medium"
                 else f"on {workload}")
        print(f"  {name:20s} {it:6d} ({record:6d})  {wall:9.4f} s  "
              f"{converged}  {r:.6e} <= {limit:.6e}  {apart}")
    for name, (_, x, it, wall, converged, r) in rows.items():
        assert converged, f"{name} did not converge in {it} iterations"
        assert r <= SUITE[name][1], (name, r, SUITE[name][1])
    require_full_f32_matmul()
    warm32 = suite_on_card("lasso_tiny", torch.float32)
    timed32 = suite_on_card("lasso_medium", torch.float32)
    for name, limit in SUITE_F32.items():
        solver = getattr(pt, name)(tol=rs.FLOAT32_LINE[name])
        suite_warm_up(solver, warm32[name][1])
        x, it, wall = suite_solve(solver, timed32[name][1])
        r = rs.fb_recheck(A, b, lam, x.cpu().numpy())
        print(f"  float32 {name:8s} tol {rs.FLOAT32_LINE[name]:.0e} "
              f"{it:6d}  {wall:9.4f} s  {it < solver.maxit}  "
              f"{r:.6e} <= {limit:.6e}")
        assert it < solver.maxit and r <= limit, (name, it, r, limit)
    suite_batched(card)
    launched = {k: getattr(w, a) for k, (w, a) in counters.items()}
    assert not any(launched.values()), launched
    dt = time.perf_counter() - t_phase
    print(f"  reference suite: {dt:.1f} s (budget {SUITE_BUDGET_S:.0f} s"
          f"{'' if dt <= SUITE_BUDGET_S else ', OVER'})  [{card}]")


# the application families (proxtpu_torch/tools/families.py), each at its
# benchmark script's published size on the generic driver
FAMILY_BUDGET_S = 90.0
# min-CVaR's cap: the script's 50,000 cut to 4,000 for the budget (the
# generic driver is host-bound: `python -m proxtpu_torch.tools.families`
# prints its ms an iteration, and the phase's wall has varied 1.4x between
# runs of one tree).  At this cap the JAX package (CPU, float32) finishes
# 15 of 64 lanes, 0 and 3 among the first 8, and these sit up to 1.040e-4
# (relative) above the LP optimum, as at 10,000
# (`python tests/test_torch_families.py`); the port is held to twice that
CVAR_MAXIT = 4_000
CVAR_JAX_DONE = 15
CVAR_JAX_GAP = 1.040e-4
# iterations of the warm-up solve of each family (same shapes, short)
FAMILY_WARM = 4


def timed_solve(fn):
    """``(out, wall)`` of one call that ends on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def family_line(name, wall, iters, done, card, gate):
    it = iters.float()
    print(f"  {name}: {wall:.3f} s per solve, iterations median "
          f"{it.median().item():.0f} max {int(iters.max())}, done "
          f"{int(done.sum())}/{done.numel()}; {gate}  [{card}]")


def family_solve(name, solve, maxit):
    """Warm up ``solve(maxit)`` at FAMILY_WARM iterations, then one timed
    solve at the family's cap ``maxit``; returns ``(out, wall)``."""
    timed_solve(lambda: solve(FAMILY_WARM))
    out, wall = timed_solve(lambda: solve(maxit))
    sol, iters, done = out
    x = sol[0] if isinstance(sol, tuple) else sol
    assert x.device.type == torch.device(DEVICE).type, \
        f"{name}: the solve left the card"
    return out, wall


def families_svm(card):
    from proxtpu_torch.tools import families as fam

    data = fam.svm_data()
    xs = {}
    for variant in ("shared", "stacked"):
        ((x, _), iters, done), wall = family_solve(
            f"SVM {variant}", lambda cap: fam.svm_solve(
                data, variant, DEVICE, maxit=cap), fam.SVM_MAXIT)
        xs[variant] = x
        family_line(f"SVM path, {variant} A, B {len(data['lams'])}, "
                    f"{data['A'].shape[0]} x {data['A'].shape[1]}, AFBA "
                    "theta 2", wall, iters, done, card, "")
        assert bool(done.all()), (variant, int((~done).sum()))
    gap = max_err(xs["shared"], xs["stacked"])
    print(f"  SVM shared vs stacked: max|dx| {gap:.3e} <= 1e-3")
    assert gap <= 1e-3, gap


def families_cvar(card):
    from proxtpu_torch.tools import families as fam

    data = fam.cvar_data()
    ((xs, _), iters, done), wall = family_solve(
        "CVaR", lambda cap: fam.cvar_solve(data, DEVICE, maxit=cap),
        CVAR_MAXIT)
    xs_h = xs.cpu().numpy()
    gaps = {}
    for i in range(min(8, done.numel())):
        if done[i]:
            opt = fam.cvar_lp(data["Ls"][i])
            gaps[i] = (fam.cvar_value(data["Ls"][i], xs_h[i]) - opt) / abs(opt)
    B, S, n = data["Ls"].shape
    family_line(f"min-CVaR, B {B}, {S} x {n}, K {fam.CVAR_K}, "
                f"Chambolle-Pock, maxit {CVAR_MAXIT}", wall, iters, done, card,
                "relative LP gap of lanes 0-7 done: " + ", ".join(
                    f"{i}: {g:.3e}" for i, g in gaps.items()))
    assert int(done.sum()) >= CVAR_JAX_DONE - 2, int(done.sum())
    assert all(-1e-6 <= g <= 2 * CVAR_JAX_GAP for g in gaps.values()), gaps


# 1.25 x the 9.840 s a solve this family took with cuSOLVER's float32 SVD
# (PERF.md, cell (l)): the accurate SVD of the nuclear-norm prox must not
# slow it more
MC_WALL_LIMIT_S = 1.25 * 9.840


def families_mc(card):
    from proxtpu_torch.tools import families as fam

    data = fam.mc_data()
    (xs, iters, done), wall = family_solve(
        "matrix completion", lambda cap: fam.mc_solve(data, DEVICE,
                                                      maxit=cap),
        fam.MC_MAXIT)
    rel = fam.mc_heldout_error(data, xs.cpu().numpy())
    B, m, n = data["obs"].shape
    family_line(f"matrix completion, B {B}, {m} x {n}, FISTA + "
                "NuclearNorm", wall, iters, done, card,
                f"held-out relative error median {np.median(rel):.4e} "
                f"max {rel.max():.4e} (< 0.25); wall limit "
                f"{MC_WALL_LIMIT_S:.2f} s")
    assert bool(done.all()) and np.median(rel) < 0.25, (
        int((~done).sum()), np.median(rel))
    assert wall <= MC_WALL_LIMIT_S, (wall, MC_WALL_LIMIT_S)


def families_glasso(card):
    from proxtpu_torch.tools import families as fam

    data = fam.glasso_data()
    (xs, iters, done), wall = family_solve(
        "graphical lasso", lambda cap: fam.glasso_solve(data, DEVICE,
                                                        maxit=cap),
        fam.GL_MAXIT)
    kkt = fam.kkt_residuals(data["Ss"], xs.cpu().numpy(), fam.GL_LAM).max(0)
    B, n, _ = data["Ss"].shape
    family_line(f"graphical lasso, B {B}, n {n}, Douglas-Rachford", wall,
                iters, done, card, "KKT max diag {:.3e}, nonzero {:.3e}, "
                "zero {:.3e} (< {:.0e})".format(*kkt, 100 * fam.GL_TOL))
    assert bool(done.all()) and (kkt < 100 * fam.GL_TOL).all(), kkt


def families_tv1d(card):
    """Both variants under vmap at maxit = 2000 masked trips, then at the
    trips the slowest lane needs (the same answer, bit for bit): the
    difference is what the masked form costs."""
    from proxtpu_torch.tools import families as fam

    Y = fam.tv1d_data()["Y"]
    oracle = [fam.tv1d_condat(y, fam.TV1D_LAM)
              for y in Y[:fam.TV1D_ORACLE_LANES].astype(np.float64)]
    Yd = torch.tensor(Y, device=DEVICE)
    for restart in (True, False):
        timed_solve(lambda: fam.tv1d_solve(Yd, restart, maxit=FAMILY_WARM))
        (Z, _), wall = timed_solve(lambda: fam.tv1d_solve(Yd, restart))
        trips = fam.tv1d_trips(Yd, restart)
        need = int(trips.max())
        (Z_need, _), wall_need = timed_solve(
            lambda: fam.tv1d_solve(Yd, restart, maxit=need))
        assert torch.equal(Z, Z_need), "masked trips past the need moved Z"
        Zh = Z[:fam.TV1D_ORACLE_LANES].cpu().numpy().astype(np.float64)
        worst = max(float(np.max(np.abs(z - o))) for z, o in zip(Zh, oracle))
        family_line(f"1-D TV, {Y.shape[0]} x {Y.shape[1]}, restart "
                    f"{restart}, vmap, 2000 masked trips", wall, trips,
                    trips < 2000, card,
                    f"worst |z - taut string| on {len(oracle)} lanes "
                    f"{worst:.3e} (< 1e-3); at {need} trips {wall_need:.3f} "
                    f"s: the masked trips cost {wall - wall_need:.3f} s")
        assert worst < 1e-3, worst


def families_logistic(card):
    from proxtpu_torch.tools import families as fam

    data = fam.logistic_data()
    (xs, iters, done), wall = family_solve(
        "logistic", lambda cap: fam.logistic_solve(data, DEVICE, maxit=cap),
        fam.LOG_MAXIT)
    r = fam.logistic_recheck(data, xs.cpu().numpy()).max()
    (m, n), B = data["A"].shape, len(data["lams"])
    family_line(f"sparse logistic, B {B}, {m} x {n} stacked, PANOC "
                "(bounded, adaptive=False)", wall, iters, done, card,
                f"float64 FB recheck max {r:.3e} (<= {2 * fam.LOG_TOL:.0e})")
    assert bool(done.all()) and r <= 2 * fam.LOG_TOL, (
        int((~done).sum()), r)
    return wall, iters


def phase_families(card):
    """The six application families of the benchmark scripts at their
    published sizes (min-CVaR's cap cut to 4,000), float32, on the card,
    through BatchedAlgorithm's generic driver (``use_kernels=False``, as the
    scripts): each family's wall per solve after a short warm-up, its
    iterations, done share and gate.  No kernel of the port lies on this
    path: every launch counter stays at 0; the phase must end within
    FAMILY_BUDGET_S."""
    from proxtpu_torch.utils.precision import require_full_f32_matmul

    require_full_f32_matmul()
    t_phase = time.perf_counter()
    counters = launch_counters()
    for w, a in counters.values():
        setattr(w, a, 0)
    seconds, out = {}, {}
    for name, fn in (("SVM", families_svm), ("CVaR", families_cvar),
                     ("matrix completion", families_mc),
                     ("graphical lasso", families_glasso),
                     ("1-D TV", families_tv1d),
                     ("logistic", families_logistic)):
        t0 = time.perf_counter()
        out[name] = fn(card)
        seconds[name] = time.perf_counter() - t0
    launched = {k: getattr(w, a) for k, (w, a) in counters.items()}
    assert not any(launched.values()), launched
    dt = time.perf_counter() - t_phase
    print(f"  application families: {dt:.1f} s (budget "
          f"{FAMILY_BUDGET_S:.0f} s); by family: " + ", ".join(
              f"{k} {v:.1f}" for k, v in seconds.items()) + f"  [{card}]")
    assert dt <= FAMILY_BUDGET_S, (dt, FAMILY_BUDGET_S)
    return out["logistic"]



# the flat machines (proxtpu_torch/parallel/flat_ls.py, adaptive_batch.py)
# and the float32 -> float64 warm start (parallel/warm.py), routes (m)-(p)
FLAT_BUDGET_S = 60.0
# the JAX package's flat machines in float32 on bench.gen_problems(256)
# (CPU): the worst float64 recheck at gamma = 1 / Lf over the 256 lanes
# (`PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_flat_ls.py`);
# the port is held to twice each
FLAT_JAX_RECHECK = {"panoc": 9.447911e-06, "zerofpr": 1.010437e-05,
                    "panocplus": 1.015201e-05,
                    "adaptive_fista": 1.053983e-05,
                    "adaptive_panoc": 9.844179e-06}
# lanes of route (m) held against their single solves: 0-7 of PANOC,
# 0-3 of ZeroFPR and PANOCplus (a single solve on the card takes 5-10 ms
# an iteration of host: 24 of them took 19 s of the phase's 60)
FLAT_CHECKED = {"PANOC": 8, "ZeroFPR": 4, "PANOCplus": 4}
# the distance of a flat lane from its single solve: two certified float32
# answers at 200 x 400 (the main path's kernel and plain routes sit up to
# 9.838e-4 apart, route (c)), held under twice that
FLAT_DX = 2e-3
WARM_TOL = 1e-6  # route (p), tests/test_warm.py's oracle: <= 1.05 tol


class counting_trips:
    """Within ``with``: count the trips of the flat machines and of the
    host loops of the generic driver and of the lasso solvers (the calls of
    their bodies), and with ``ops=True`` the PyTorch operations inside
    those trips (a ``TorchDispatchMode``: slow, for a short run)."""

    def __init__(self, ops=False):
        self.ops, self.trips, self.n_ops = ops, 0, 0

    def _counted(self, body):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Ops(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n_ops += 1
                return func(*args, **(kwargs or {}))

        def trip(*args):
            self.trips += 1
            if not self.ops:
                return body(*args)
            with Ops():
                return body(*args)
        return trip

    def __enter__(self):
        import proxtpu_torch.kernels.lasso as tl
        import proxtpu_torch.parallel.adaptive_batch as ab
        import proxtpu_torch.parallel.batch as bt
        import proxtpu_torch.parallel.flat_ls as fl

        self.modules = fl, ab, bt, tl
        self.saved = (fl._host_while, ab._host_while, bt.run_host_loop,
                      tl.run_host_loop)
        real_while, real_loop = self.saved[0], self.saved[2]

        def host_while(active_of, body, s, every, cap):
            return real_while(active_of, self._counted(body), s, every, cap)

        def host_loop(body, state, *args, **kw):
            return real_loop(self._counted(body), state, *args, **kw)

        fl._host_while = ab._host_while = host_while
        bt.run_host_loop = tl.run_host_loop = host_loop
        return self

    def __exit__(self, *exc):
        fl, ab, bt, tl = self.modules
        (fl._host_while, ab._host_while, bt.run_host_loop,
         tl.run_host_loop) = self.saved
        return False


def flat_route(name, solve, maxit, card, gate=None, recheck_fn=None,
               launched=None):
    """Warm ``solve(cap)`` up at FAMILY_WARM iterations, time one solve at
    ``maxit`` counting its trips (and, into the dict ``launched``, the
    kernel launches of that solve alone: every counter set to 0 just
    before it and read just after), then count the operations of a trip
    in a short run.  Every lane must be done and its float64 recheck under
    ``gate``.  Returns ``(xs, iters, wall, trips, ops per trip)``."""
    timed_solve(lambda: solve(FAMILY_WARM))
    counters = launch_counters()
    for w, a in counters.values():
        setattr(w, a, 0)
    with counting_trips() as count:
        (xs, iters, done), wall = timed_solve(lambda: solve(maxit))
    if launched is not None:
        launched.update({k: getattr(w, a) for k, (w, a) in counters.items()})
    with counting_trips(ops=True) as ops:
        solve(FAMILY_WARM)
        torch.cuda.synchronize()
    per_trip = ops.n_ops / max(ops.trips, 1)
    assert xs.device.type == torch.device(DEVICE).type, \
        f"{name}: the solve left the card"
    assert bool(done.all()), f"{name}: {int((~done).sum())} lanes left"
    assert bool(torch.isfinite(xs).all()), name
    r = None
    if recheck_fn is not None:
        r = float(np.max(recheck_fn(xs.cpu().numpy())))
        assert r <= gate, (name, r, gate)
    print(f"  {name}: {wall:.3f} s, iterations mean "
          f"{iters.float().mean():.2f} max {int(iters.max())}, trips "
          f"{count.trips}, operations per trip {per_trip:.1f}"
          + ("" if r is None else f", float64 recheck {r:.3e} <= "
             f"{gate:.3e}") + f"  [{card}]")
    return xs, iters, wall, count.trips, per_trip


def per_iteration(trips, per_trip, iters):
    """Operations per iteration of a batched run: its trips' operations
    over the iterations of its slowest lane (the generic driver makes one
    trip an iteration)."""
    return trips * per_trip / int(iters.max())


def flat_pair(name, flat, bounded):
    """Print a flat route beside its bounded (masked-trial) counterpart:
    walls, iterations and operations per iteration."""
    f_ops, b_ops = per_iteration(*flat[3:], flat[1]), bounded[2]
    print(f"  {name}: flat {flat[2]:.3f} s, {f_ops:.1f} operations an "
          f"iteration; bounded {bounded[0]:.3f} s, {b_ops:.1f}; operations "
          f"an iteration bounded / flat {b_ops / f_ops:.2f}, wall "
          f"{bounded[0] / flat[2]:.2f}")


def bounded_ops(solve):
    """Operations per iteration of a generic-driver run (one trip an
    iteration), from a short run."""
    with counting_trips(ops=True) as ops:
        solve(FAMILY_WARM)
        torch.cuda.synchronize()
    return ops.n_ops / max(ops.trips, 1)


def flat_flagship(card, As, bs, lams, Lfs):
    """Route (m): benchmarks/flat_ls_bench.py's flagship problems through
    the default BatchedAlgorithm (PANOC, ZeroFPR, PANOCplus with Lf per
    lane: the flat machines), PANOC once more on the bounded route, and
    the first lanes of each (FLAT_CHECKED) against their single solves on
    the card."""
    import proxtpu_torch as pt
    from proxtpu_torch.kernels.dispatch import match_flat_linesearch
    from proxtpu_torch.prox import NormL1, SqrDistance

    A, b, lam, Lf = (torch.tensor(v, device=DEVICE)
                     for v in (As, bs, lams, Lfs))
    kw = dict(x0=torch.zeros(A.shape[0], A.shape[2], device=DEVICE),
              f=SqrDistance(b), A=A, g=NormL1(lam), Lf=Lf)

    def check(xs):
        return recheck64(As, bs, lams, Lfs, xs)

    out = {}
    for name in ("PANOC", "ZeroFPR", "PANOCplus"):
        factory = getattr(pt, f"make_{name.lower()}_iteration")
        assert match_flat_linesearch(factory, kw, tol=TOL,
                                     maxit=MAXIT) is not None, name
        key = name.lower()
        out[key] = flat_route(
            f"(m) {name} flat", lambda cap, fac=factory: pt.BatchedAlgorithm(
                fac, maxit=cap, tol=TOL)(**kw), MAXIT, card,
            2 * FLAT_JAX_RECHECK[key], check)
        xs, iters = out[key][:2]
        exact, d_it, d_x = 0, 0, 0.0
        for i in range(FLAT_CHECKED[name]):
            x, it = getattr(pt, name)(tol=TOL, maxit=MAXIT)(
                x0=kw["x0"][i], f=SqrDistance(b[i]), A=A[i],
                g=NormL1(float(lam[i])), Lf=float(Lf[i]))
            assert it < MAXIT, (name, i, it)
            exact += int(iters[i]) == it
            d_it = max(d_it, abs(int(iters[i]) - it))
            d_x = max(d_x, max_err(xs[i], x))
        print(f"    lanes 0-{FLAT_CHECKED[name] - 1} against single solves: "
              f"{exact}/{FLAT_CHECKED[name]} counts equal, max|d iters| "
              f"{d_it}, "
              f"max|d x| {d_x:.3e} <= {FLAT_DX:.0e}")
        assert d_x <= FLAT_DX, (name, d_x)

    def bounded(cap):
        return pt.BatchedAlgorithm(pt.make_panoc_iteration, maxit=cap,
                                   tol=TOL, use_kernels=False)(**kw)

    xs_b, it_b, wall_b, _, per_b = flat_route(
        "(m) PANOC bounded (use_kernels=False)", bounded, MAXIT, card,
        2 * FLAT_JAX_RECHECK["panoc"], check)
    flat_pair("(m) PANOC", out["panoc"], (wall_b, it_b, per_b))


def flat_logistic(card, family_line_):
    """Route (n): benchmarks/logistic_bench.py's three flat variants on
    tools/families.py's logistic data, gated by the families' float64
    recheck, beside the families phase's bounded PANOC."""
    from proxtpu_torch.ops.linops import MatrixOperator
    from proxtpu_torch.parallel import batched_panoc, batched_zerofpr
    from proxtpu_torch.prox import LogisticLoss, NormL1, Translate
    from proxtpu_torch.tools import families as fam
    from proxtpu_torch.utils.shared import Shared

    data = fam.logistic_data()
    A, b, lams = (torch.tensor(data[k], device=DEVICE)
                  for k in ("A", "b", "lams"))
    B, (m, n) = lams.shape[0], A.shape
    x0 = A.new_zeros(B, n)
    gamma = torch.full((B,), 0.95 / data["Lf"], device=DEVICE)
    g = NormL1(lams)
    f_log = Translate(LogisticLoss(1.0), -b)
    f_st = Translate(LogisticLoss(A.new_ones(B)),
                     (-b).expand(B, m).contiguous())
    A_st = MatrixOperator(A.expand(B, m, n).contiguous())
    variants = {
        "flat_zerofpr_shared": lambda cap: batched_zerofpr(
            Shared(f_log), Shared(MatrixOperator(A)), g, x0, gamma,
            fam.LOG_TOL, maxit=cap),
        "flat_zerofpr_stacked": lambda cap: batched_zerofpr(
            f_st, A_st, g, x0, gamma, fam.LOG_TOL, maxit=cap),
        "flat_panoc_shared": lambda cap: batched_panoc(
            Shared(f_log), Shared(MatrixOperator(A)), g, x0, gamma,
            fam.LOG_TOL, maxit=cap),
    }
    out = {name: flat_route(
        f"(n) {name}", run, fam.LOG_MAXIT, card, 2 * fam.LOG_TOL,
        lambda xs: fam.logistic_recheck(data, xs))
        for name, run in variants.items()}
    wall_b, it_b = family_line_
    per_b = bounded_ops(lambda cap: fam.logistic_solve(data, DEVICE,
                                                       maxit=cap))
    print(f"  (n) bounded PANOC of the families phase: {wall_b:.3f} s, "
          f"iterations mean {it_b.float().mean():.2f} max "
          f"{int(it_b.max())}, operations an iteration {per_b:.1f}")
    flat_pair("(n) flat_panoc_shared", out["flat_panoc_shared"],
              (wall_b, it_b, per_b))


def flat_adaptive(card, As, bs, lams, Lfs):
    """Route (o): the adaptive machines on route (m)'s problems:
    BatchedAlgorithm(FastForwardBackward) with no step (the adaptive FISTA
    machine) and adaptive PANOC from a gamma ten times too large
    (flat_ls_bench.py --adaptive)."""
    import proxtpu_torch as pt
    from proxtpu_torch.kernels.dispatch import (
        match_flat_adaptive,
        match_flat_linesearch,
    )
    from proxtpu_torch.prox import LeastSquaresLoss, NormL1, SqrDistance

    A, b, lam, Lf = (torch.tensor(v, device=DEVICE)
                     for v in (As, bs, lams, Lfs))
    x0 = torch.zeros(A.shape[0], A.shape[2], device=DEVICE)

    def check(xs):
        return recheck64(As, bs, lams, Lfs, xs)

    kw_fista = dict(x0=x0, f=LeastSquaresLoss(A, b), g=NormL1(lam))
    assert match_flat_adaptive(pt.make_fast_forward_backward_iteration,
                               kw_fista, tol=TOL, maxit=4 * MAXIT)
    flat_route("(o) adaptive FISTA flat", lambda cap: pt.BatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=cap, tol=TOL)(
            **kw_fista), 4 * MAXIT, card,
        2 * FLAT_JAX_RECHECK["adaptive_fista"], check)
    kw_panoc = dict(x0=x0, f=SqrDistance(b), A=A, g=NormL1(lam),
                    adaptive=True, gamma=10 * 0.95 / Lf)
    assert match_flat_linesearch(pt.make_panoc_iteration, kw_panoc,
                                 tol=TOL, maxit=MAXIT)
    flat_route("(o) adaptive PANOC flat, gamma 10x", lambda cap:
               pt.BatchedAlgorithm(pt.make_panoc_iteration, maxit=cap,
                                   tol=TOL)(**kw_panoc), MAXIT, card,
               2 * FLAT_JAX_RECHECK["adaptive_panoc"], check)


def flat_warm(card, As, bs, lams, Lfs):
    """Route (p): WarmStartedBatchedAlgorithm(FastForwardBackward) in
    float64 at tol 1e-6 on stacked A: stage 1 on the float32 kernel route
    (its launches counted), the polish on the float64 plain step; each
    lane's float64 FB residual <= 1.05 tol, beside the cold float64
    solve on the generic driver.  Returns the launches of stage 1."""
    import proxtpu_torch as pt
    from proxtpu_torch.parallel import (
        WarmStartedBatchedAlgorithm,
        cast_problem,
    )
    from proxtpu_torch.prox import LeastSquaresLoss, NormL1

    A, b, lam, Lf = (torch.tensor(v, dtype=torch.float64, device=DEVICE)
                     for v in (As, bs, lams, Lfs))
    kw = dict(x0=torch.zeros(A.shape[0], A.shape[2], dtype=torch.float64,
                             device=DEVICE),
              f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)

    def check(xs):
        return recheck64(As, bs, lams, Lfs, xs)

    launches = {}
    xs, iters, wall, _, _ = flat_route(
        "(p) warm start float32 -> float64, tol 1e-6",
        lambda cap: WarmStartedBatchedAlgorithm(
            pt.make_fast_forward_backward_iteration, maxit=cap,
            tol=WARM_TOL)(**kw), 20_000, card, 1.05 * WARM_TOL, check,
        launched=launches)
    moved = {k for k, v in launches.items() if v}
    assert launches["fista_step"] > 0 and moved <= {"fb_step", "fista_step"}, \
        launches
    solver = WarmStartedBatchedAlgorithm(
        pt.make_fast_forward_backward_iteration, maxit=20_000, tol=WARM_TOL)
    (_, it1, _), wall1 = timed_solve(lambda: solver.warm(
        **cast_problem(kw, solver.warm_dtype)))
    print(f"    stage 1 launches (the kernels' JSON line counts them): "
          f"{ {k: launches[k] for k in sorted(moved)} }; stage 1 alone "
          f"{wall1:.3f} s, iterations max {int(it1.max())}")
    xs_c, it_c, wall_c, _, _ = flat_route(
        "(p) cold float64, generic driver", lambda cap: pt.BatchedAlgorithm(
            pt.make_fast_forward_backward_iteration, maxit=cap,
            tol=WARM_TOL, use_kernels=False)(**kw), 20_000, card,
        1.05 * WARM_TOL, check)
    print(f"    warm / cold wall {wall / wall_c:.3f}, iterations max "
          f"{int(iters.max())} / {int(it_c.max())}, max|x_warm - x_cold| "
          f"{max_err(xs, xs_c):.3e}")
    return launches


def recheck64(As, bs, lams, Lfs, xs):
    """:func:`recheck` in float64 (the flat routes' gate)."""
    return recheck(*(np.asarray(v, np.float64)
                     for v in (As, bs, lams, Lfs, xs)))


def phase_flat(card, family_logistic):
    """Routes (m)-(p): the flat machines and the warm start at full width
    on the card; the phase must end within FLAT_BUDGET_S.  Returns the
    kernel launches of route (p)'s float32 stage."""
    from proxtpu_torch.tools.problems import BATCH, lasso_problems
    from proxtpu_torch.utils.precision import require_full_f32_matmul

    require_full_f32_matmul()
    t_phase = time.perf_counter()
    flagship = lasso_problems(BATCH)
    seconds, out = {}, {}
    for name, fn, args in (
            ("(m)", flat_flagship, flagship),
            ("(n)", flat_logistic, (family_logistic,)),
            ("(o)", flat_adaptive, flagship),
            ("(p)", flat_warm, flagship)):
        t0 = time.perf_counter()
        out[name] = fn(card, *args)
        seconds[name] = time.perf_counter() - t0
    dt = time.perf_counter() - t_phase
    print(f"  flat machines: {dt:.1f} s (budget {FLAT_BUDGET_S:.0f} s); by "
          "route: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"  [{card}]")
    assert dt <= FLAT_BUDGET_S, (dt, FLAT_BUDGET_S)
    return out["(p)"]


# the drivers' remaining surface (routes (q)-(v)): the phase's budget
DRIVERS_BUDGET_S = 90.0
# where the phase writes its checkpoints and its trace, inside the checkout
# (build/ is listed in .gitignore); removed at the end of the phase
DRIVERS_DIR = os.path.join("build", "chip_smoke_drivers")
DRIVERS_K = 16  # route (q)'s check_every
SEGMENT = 128  # route (s)
RECORD_EVERY = 8  # route (u)


def lane_residual(it, k, s):
    """The FB / FISTA stopping residual ||x - z||_inf / gamma of a state
    (per lane under the batched driver)."""
    from proxtpu_torch.utils.tree import tree_inf_norm

    return tree_inf_norm(s.res) / s.gamma


@contextlib.contextmanager
def counting_syncs():
    """Count the host's waits on the card inside the block: PyTorch's sync
    debug mode warns at every synchronizing operation (``.item()``,
    ``bool`` of a tensor, a copy to the host), and the warnings are
    counted.  Yields an object whose ``n`` is set on exit."""
    import types
    import warnings

    counter = types.SimpleNamespace(n=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield counter
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counter.n = sum("synchroniz" in str(w.message) for w in caught)


def drivers_blocking(card):
    """Route (q): ForwardBackward and FastForwardBackward on cell (k)'s
    lasso_medium in float64 (the reference suite's configurations) at
    check_every 1 and DRIVERS_K: the suite's counts at both, bit-equal
    solutions, the wall and host syncs of each (syncs counted in the
    timed run).  Returns ``{name: {K: (x, it, wall, syncs)}}``."""
    import copy

    from proxtpu_torch.tools.reference_suite import primal

    configs = suite_on_card("lasso_medium", torch.float64)
    out = {}
    for name in ("ForwardBackward", "FastForwardBackward"):
        solver, kw = configs[name]
        runs = {}
        for K in (1, DRIVERS_K):
            blocked = copy.copy(solver)
            blocked.check_every = K
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with counting_syncs() as syncs:
                sol, it = blocked(**kw)
            torch.cuda.synchronize()
            runs[K] = (primal(sol), it, time.perf_counter() - t0, syncs.n)
        (x1, it1, dt1, s1), (xk, itk, dtk, sk) = runs[1], runs[DRIVERS_K]
        print(f"  (q) {name} lasso_medium float64: check_every=1 {it1} "
              f"iterations, {dt1:.4f} s, {s1} host syncs; check_every="
              f"{DRIVERS_K} {itk} iterations, {dtk:.4f} s, {sk} host syncs; "
              f"wall K={DRIVERS_K} / K=1 {dtk / dt1:.3f}, bit-equal "
              f"{bool(torch.equal(x1, xk))}  [{card}]")
        assert it1 == itk == SUITE[name][0], (name, it1, itk)
        assert torch.equal(x1, xk), f"route (q): {name} bits differ"
        out[name] = runs
    return out


def drivers_resume(card, blocking):
    """Route (r): 1000 ``states`` of FISTA on lasso_medium, ``save_state``
    on the card, ``load_state(like=...)``, then the solve resumed with
    ``resume_iters=1000``: the total count and the bits of one unbroken
    run (route (q)'s).  The checkpoint also loads onto the CPU, and a CPU
    copy back onto the card.  Then ``run_recorded`` of FB's residual every
    10 iterations: the unbroken run's count and bits, ``count == it //
    10`` and NaN after it."""
    import proxtpu_torch as pt
    from proxtpu_torch.utils.checkpoint import load_state, save_state
    from proxtpu_torch.utils.iteration_tools import loop
    from proxtpu_torch.utils.tree import tree_leaves, tree_map

    configs = suite_on_card("lasso_medium", torch.float64)
    solver, kw = configs["FastForwardBackward"]
    iteration = solver.make_iteration(**kw)
    t0 = time.perf_counter()
    snap = loop(pt.states(iteration, max_states=1000))
    path = os.path.join(DRIVERS_DIR, "fista_1000.pt")
    save_state(path, snap)
    like = iteration.init()
    restored = load_state(path, like=like)
    x, it = solver(resume_from=restored, resume_iters=1000, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x_full, it_full = blocking["FastForwardBackward"][1][:2]
    on_cpu = load_state(path, like=tree_map(lambda v: v.cpu(), like))
    cpu_path = os.path.join(DRIVERS_DIR, "fista_1000_cpu.pt")
    save_state(cpu_path, on_cpu)
    back = load_state(cpu_path, like=like)
    leaves = [tree_leaves(t) for t in (snap, on_cpu, back)]
    moved = (all(v.device.type == "cpu" for v in leaves[1])
             and all(v.device == u.device for u, v in zip(*leaves[::2]))
             and all(torch.equal(u.cpu(), v) for u, v in zip(*leaves[:2]))
             and all(torch.equal(u, v) for u, v in zip(*leaves[::2])))
    print(f"  (r) FISTA lasso_medium: 1000 states, save_state on the card "
          f"({os.path.getsize(path)} bytes), load_state(like=...), resumed "
          f"with resume_iters=1000: {it} iterations in all (unbroken "
          f"{it_full}), bit-equal {bool(torch.equal(x, x_full))}, "
          f"{wall:.4f} s; card -> CPU -> card round trip exact {moved}  "
          f"[{card}]")
    assert it == it_full == SUITE["FastForwardBackward"][0], (it, it_full)
    assert torch.equal(x, x_full), "route (r): the resumed solve differs"
    assert moved, "route (r): a checkpoint did not move between devices"

    solver, kw = configs["ForwardBackward"]
    x_fb, it_fb = blocking["ForwardBackward"][1][:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, it, tr = solver.run_recorded(lane_residual, record_every=10, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = tr.values.cpu().numpy()
    count = int(tr.count)
    last = float(vals[count - 1])
    print(f"  (r) ForwardBackward run_recorded(residual, record_every=10): "
          f"{it} iterations, count {count}, {vals.shape[0]} slots, NaN after "
          f"count {bool(np.isnan(vals[count:]).all())}, last residual "
          f"{last:.3e}, {wall:.4f} s (unrecorded "
          f"{blocking['ForwardBackward'][1][2]:.4f} s)  [{card}]")
    assert it == it_fb and torch.equal(x, x_fb), "route (r): recording moved"
    assert count == it // 10, (count, it)
    assert np.isfinite(vals[:count]).all() and np.isnan(vals[count:]).all()


def flagship_iteration(As, bs, lams, Lfs):
    """FISTA on the flagship problems (bench.gen_problems seed 0, 256 x
    200 x 400 float32) with the given lambdas, as one batched iteration
    for the generic driver, and its kwargs."""
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.algorithms import make_fast_forward_backward_iteration
    from proxtpu_torch.prox import LeastSquaresLoss, NormL1

    A, b, lam, Lf = problems_from_numpy(As, bs, lams, Lfs, device=DEVICE)
    kw = dict(x0=torch.zeros((A.shape[0], A.shape[2]), device=DEVICE),
              f=LeastSquaresLoss(A, b), g=NormL1(lam), Lf=Lf)
    return make_fast_forward_backward_iteration(**kw), kw


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def drivers_segments(card, As, bs, lams, Lfs):
    """Route (s): FISTA on the flagship problems through the generic
    driver's ``batched_run_segments(segment=SEGMENT)``; the second snapshot
    saved with ``save_state`` and the run resumed from disk; counts and
    bits equal to ``batched_run_loop``'s (one chunk core)."""
    from proxtpu_torch.parallel import batched_run_loop, batched_run_segments
    from proxtpu_torch.utils.checkpoint import load_state, save_state

    iteration, _ = flagship_iteration(As, bs, lams, Lfs)
    (xs0, it0, d0), dt0 = timed(
        lambda: batched_run_loop(iteration, MAXIT, TOL, check_every=8))
    snaps = []
    (xs1, it1, d1), dt1 = timed(lambda: batched_run_segments(
        iteration, MAXIT, TOL, segment=SEGMENT, callback=snaps.append))
    path = os.path.join(DRIVERS_DIR, "segment_2.pt")
    save_state(path, snaps[1])
    restored = load_state(path, like=snaps[1])
    (xs2, it2, d2), dt2 = timed(lambda: batched_run_segments(
        iteration, MAXIT, TOL, segment=SEGMENT, resume=restored))
    r = recheck(As, bs, lams, Lfs, xs1.cpu().numpy())
    print(f"  (s) batched_run_segments(segment={SEGMENT}), FISTA on "
          f"{tuple(iteration.f.A.shape)}: {len(snaps)} segments, "
          f"{dt1:.4f} s; batched_run_loop {dt0:.4f} s; resumed from the "
          f"snapshot at k={restored['k']} on disk {dt2:.4f} s; iterations "
          f"mean {it1.float().mean():.2f} max {int(it1.max())}, recheck "
          f"{r:.3e}  [{card}]")
    assert bool(d0.all()) and r <= 2 * TOL, (int((~d0).sum()), r)
    for name, (xs, it, d) in (("segments", (xs1, it1, d1)),
                              ("resumed", (xs2, it2, d2))):
        assert torch.equal(it, it0) and torch.equal(d, d0), name
        assert torch.equal(xs, xs0), f"route (s): {name} bits differ"
    return it0


def drivers_compaction(card, As, bs, lams, Lfs):
    """Route (t): route (j)'s lambda-spread flagship problems on the
    generic driver, ``compacting_batched_run`` against
    ``batched_run_loop``: counts and done flags, the lanes that differ in
    count or bits, each run's recheck <= 2 tol, both walls."""
    from proxtpu_torch.parallel import batched_run_loop, \
        compacting_batched_run

    rng = np.random.default_rng(5)
    spread = (lams * (0.2 + 0.8 * rng.random(len(lams)))).astype(np.float32)
    iteration, _ = flagship_iteration(As, bs, spread, Lfs)
    maxit = 3000
    (xs0, it0, d0), dt0 = timed(
        lambda: batched_run_loop(iteration, maxit, TOL, check_every=8))
    (xs1, it1, d1), dt1 = timed(
        lambda: compacting_batched_run(iteration, maxit, TOL))
    r0 = recheck(As, bs, spread, Lfs, xs0.cpu().numpy())
    r1 = recheck(As, bs, spread, Lfs, xs1.cpu().numpy())
    counts = int((it0 != it1).sum())
    bits = int((xs0 != xs1).any(dim=1).sum())
    print(f"  (t) compacting_batched_run (chunk 256) vs batched_run_loop, "
          f"lambda spread: {dt1:.4f} s vs {dt0:.4f} s; iterations mean "
          f"{it1.float().mean():.2f} max {int(it1.max())}; lanes that "
          f"differ: {counts} in count, {bits} in bits, done flags equal "
          f"{bool(torch.equal(d0, d1))}; recheck {r1:.3e} vs {r0:.3e}  "
          f"[{card}]")
    assert bool(d0.all()) and bool(d1.all())
    assert r0 <= 2 * TOL and r1 <= 2 * TOL, (r0, r1)


def drivers_recording(card, As, bs, lams, Lfs, it_plain):
    """Route (u): ``BatchedAlgorithm(use_kernels=False).run_recorded`` of
    the per-lane residual every RECORD_EVERY iterations on the flagship
    problems: the unrecorded run's iterations, NaN in every slot after
    ``count``; the wall recorded against unrecorded."""
    import proxtpu_torch as pt
    from proxtpu_torch.algorithms import make_fast_forward_backward_iteration

    _, kw = flagship_iteration(As, bs, lams, Lfs)
    alg = pt.BatchedAlgorithm(make_fast_forward_backward_iteration,
                              maxit=MAXIT, tol=TOL, use_kernels=False)
    (_, it0, _), dt0 = timed(lambda: alg(**kw))
    (xs, it, done, tr), dt = timed(
        lambda: alg.run_recorded(lane_residual, record_every=RECORD_EVERY,
                                 **kw))
    vals = tr.values.cpu().numpy()
    count = int(tr.count)
    print(f"  (u) BatchedAlgorithm.run_recorded(residual, record_every="
          f"{RECORD_EVERY}): {dt:.4f} s against {dt0:.4f} s unrecorded "
          f"({dt / dt0:.3f}x), trace {vals.shape}, count {count}, NaN after "
          f"count {bool(np.isnan(vals[count:]).all())}  [{card}]")
    assert torch.equal(it, it0) and torch.equal(it, it_plain)
    assert bool(done.all())
    assert count == int(it.max()) // RECORD_EVERY, count
    assert np.isnan(vals[count:]).all() and np.isfinite(vals[:count]).all()


def drivers_profiling(card, A, b, lam, Lf):
    """Route (v): one ``solve_lasso_batch_packed_tail`` solve of the main
    path inside ``trace()``: the trace's device events of ``fista_step``
    and ``fb_step`` equal the wrappers' launch counters for that solve,
    and only warm-up records are lost (a plain profiler session of the
    same solve printed beside it); then ``compiled_stats`` of the same
    solve: the kernels' flops and bytes by the JAX package's formulas at
    each launch's width.  Returns the launches of the traced solve."""
    import glob
    import shutil

    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.utils import profiling
    from proxtpu_torch.utils.profiling import compiled_stats, trace

    kw = dict(maxit=MAXIT, k1=192, tail=64, restart=True)

    def solve():
        return tl.solve_lasso_batch_packed_tail(A, b, lam, Lf, TOL, **kw)

    counters = launch_counters()

    def traced(name, session):
        """``(kernel events, lost launches, ms from the first launch to the
        last lost one, warm-up launches, launch counters, seconds, path)``
        of one solve inside ``session(log_dir)``; a launch is the warm-up's
        where it precedes the end of trace()'s warm-up range."""
        for w, a in counters.values():
            setattr(w, a, 0)
        log_dir = os.path.join(DRIVERS_DIR, name)
        shutil.rmtree(log_dir, ignore_errors=True)
        t0 = time.perf_counter()
        with session(log_dir):
            solve()
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
        (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        names = [e["name"] for e in kernels]
        kept = {e.get("args", {}).get("correlation") for e in kernels}
        runtime = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                          and "Launch" in e["name"]), key=lambda e: e["ts"])
        # the launches (by their place in the session) whose kernel record
        # the trace lacks
        lost = [i for i, e in enumerate(runtime)
                if e.get("args", {}).get("correlation") not in kept]
        span = ((runtime[lost[-1]]["ts"] - runtime[0]["ts"]) / 1e3
                if lost else 0.0)
        warm_end = max((e["ts"] + e.get("dur", 0) for e in events
                        if e.get("name") == "proxtpu_torch.trace: warm-up"),
                       default=None)
        warm = (0 if warm_end is None
                else sum(e["ts"] < warm_end for e in runtime))
        seen = {"fista_step": sum("fista_step_kernel" in n for n in names),
                "fb_step": sum("fb_step_kernel" in n for n in names),
                "kernel events": len(kernels), "launches": len(runtime)}
        return seen, lost, span, warm, launches, dt, path

    def plain_session(log_dir):
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       on_trace_ready=tensorboard_trace_handler(log_dir))

    # a plain profiler session first: it may lose the first kernel records
    # (see utils/profiling.py, WARMUP_SECONDS); trace() must lose none of
    # the solve's
    raw, raw_lost, raw_span, _, _, _, _ = traced("plain_session",
                                                 plain_session)
    seen, lost, span, warm, launches, t_trace, path = traced("trace", trace)
    print(f"  (v) trace() of one main-path solve ({t_trace:.2f} s, "
          f"{os.path.getsize(path)} bytes): device events {seen}, launch "
          f"counters fista_step {launches['fista_step']} fb_step "
          f"{launches['fb_step']}; records lost {len(lost)}, at launches "
          f"{lost[:3]}..{lost[-3:]} ({span:.3f} ms from the first), the "
          f"warm-up's {warm} launches in {profiling.WARMUP_SECONDS * 1e3:g} "
          f"ms being 0..{warm - 1}; a plain profiler session of the same "
          f"solve: {raw}, records lost {len(raw_lost)}, at launches "
          f"{raw_lost[:3]}..{raw_lost[-3:]} ({raw_span:.3f} ms from the "
          f"first)  [{card}]")
    assert {k: seen[k] for k in ("fista_step", "fb_step")} == {
        k: launches[k] for k in ("fista_step", "fb_step")}, (seen, launches)
    assert warm > 0 and all(i < warm for i in lost), (warm, lost)

    for w, a in counters.values():
        setattr(w, a, 0)
    stats = compiled_stats(tl.solve_lasso_batch_packed_tail, A, b, lam, Lf,
                           TOL, **kw)
    again = {k: getattr(w, a) for k, (w, a) in counters.items()}
    B, M, N = MAIN_SHAPES[0]
    tail = MAIN_SHAPES[1][0]
    n_f, n_fb = again["fista_step"], again["fb_step"]
    # phase 1: 192 fista_step at B = 256; phase 2: fb_step, then fista_step,
    # at tail = 64
    lanes_f = 192 * B + (n_f - 192) * tail
    want = {"fista_step": (4 * lanes_f * M * N,
                           4 * lanes_f * (M * N + 5 * N)),
            "fb_step": (4 * n_fb * tail * M * N,
                        4 * n_fb * tail * (M * N + 3 * N))}
    got = {k: (v["flops"], v["bytes accessed"])
           for k, v in stats["kernels"].items()}
    cost = stats["cost_analysis"]
    mem = stats["memory_analysis"]
    print(f"  (v) compiled_stats: flops {cost['flops']:.6e} (kernels "
          f"{sum(f for f, _ in got.values()):.6e}; 257 x 4 B M N at B = 256 "
          f"would be {257 * 4 * B * M * N:.6e}), bytes accessed "
          f"{cost['bytes accessed']:.6e} (kernels "
          f"{sum(n for _, n in got.values()):.6e}), transcendentals "
          f"{cost['transcendentals']}; by kernel {stats['kernels']}; peak "
          f"device bytes {mem['peak_size_in_bytes']}, launches {again}  "
          f"[{card}]")
    assert launches == again, (launches, again)
    assert n_fb == 1 and n_f >= 192, again
    assert got == want, (got, want)
    assert cost["flops"] == sum(f for f, _ in got.values()), cost

    # what the kernel_cost hook costs a wrapper call outside
    # compiled_stats: a no-op under the hook against the bare no-op, the
    # least of two rounds of 100,000 calls each
    def noop(*args):
        return None

    hooked = profiling.kernel_cost("noop", lambda *args: {})(noop)
    us = {"bare": [], "hooked": []}
    for name, fn in (("bare", noop), ("hooked", hooked)) * 2:
        t0 = time.perf_counter()
        for _ in range(100_000):
            fn(A, b)
        us[name].append((time.perf_counter() - t0) * 10)
    hook_us = min(us["hooked"]) - min(us["bare"])
    n_launch = sum(launches.values())
    print(f"  (v) kernel_cost hook: {hook_us:.4f} us a call (hooked "
          f"{min(us['hooked']):.4f}, bare {min(us['bare']):.4f}), x "
          f"{n_launch} launches = {hook_us * n_launch / 1e3:.5f} ms a solve"
          f"  [{card}]")
    return launches


def phase_drivers(card):
    """Routes (q)-(v): the drivers' remaining surface on the card (check_every
    and resume on the single-problem driver, checkpoints, segmented,
    compacting and recorded batched runs, the profiling hooks on the main
    path); the phase must end within DRIVERS_BUDGET_S.  Returns the kernel
    launches of route (v)'s traced solve."""
    import shutil

    from proxtpu_torch.tools import problems
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.utils.precision import require_full_f32_matmul

    require_full_f32_matmul()
    os.makedirs(DRIVERS_DIR, exist_ok=True)
    t_phase = time.perf_counter()
    As, bs, lams, Lfs = problems.lasso_problems(problems.BATCH)
    seconds = {}

    def route(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(card, *args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        blocking = route("(q)", drivers_blocking)
        route("(r)", drivers_resume, blocking)
        it_flagship = route("(s)", drivers_segments, As, bs, lams, Lfs)
        route("(t)", drivers_compaction, As, bs, lams, Lfs)
        route("(u)", drivers_recording, As, bs, lams, Lfs, it_flagship)
        launches = route("(v)", drivers_profiling, *problems_from_numpy(
            As, bs, lams, Lfs, device=DEVICE))
    finally:
        shutil.rmtree(DRIVERS_DIR, ignore_errors=True)
    dt = time.perf_counter() - t_phase
    print(f"  drivers: {dt:.1f} s (budget {DRIVERS_BUDGET_S:.0f} s); by "
          "route: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"  [{card}]")
    assert dt <= DRIVERS_BUDGET_S, (dt, DRIVERS_BUDGET_S)
    return launches


SHARDING_BUDGET_S = 120.0
SHARDING_DIR = os.path.join("build", "chip_smoke_sharding")
SHARDING_RANKS = 2  # route (x): two Gloo ranks sharing the one card


def sharded_pair(name, sharded, plain, card, expect, check=None):
    """Route (w): ``sharded()`` (outputs placed on the one-rank mesh)
    against the unsharded solver ``plain()`` on the same tensors: both
    warmed up, then each timed once, every launch counter set to 0 just
    before the sharded run and read just after.  Every lane done, the
    gathered outputs bit-equal to the unsharded ones, exactly the kernels
    ``expect`` launched; ``check`` rechecks the solution on the host.
    Returns ``(launches, plain outputs)``."""
    from proxtpu_torch.parallel.sharded_ops import full_tensor

    counters = launch_counters()
    sharded(), plain()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = plain()
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    for w, a in counters.values():
        setattr(w, a, 0)
    t0 = time.perf_counter()
    out = sharded()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: getattr(w, a) for k, (w, a) in counters.items()}
    got = [full_tensor(v) for v in out]
    assert {k for k, n in launches.items() if n} == set(expect), (
        name, launches, expect)
    assert bool(got[2].all()), f"{name}: {int((~got[2]).sum())} lanes left"
    assert all(torch.equal(g, r) for g, r in zip(got, ref)), (
        f"{name}: sharded lanes differ from the unsharded solve")
    r = "" if check is None else f", recheck {check(got[0]):.3e}"
    print(f"(w) {name}: bit-equal to the unsharded solve{r}; iterations "
          f"mean {got[1].float().mean():.2f} max {int(got[1].max())}; "
          f"launches {({k: n for k, n in launches.items() if n})}; "
          f"sharded {dt:.4f} s a solve, unsharded {dt_p:.4f} s  [{card}]")
    return launches, ref


def sharding_one_rank(card):
    """Route (w): the sharding layer on a one-rank NCCL group at full width.
    Returns the kernels' launches and the flagship's unsharded solve."""
    from proxtpu_torch.tools import problems
    from proxtpu_torch import problems_from_numpy
    from proxtpu_torch.kernels import box_qp as tb
    from proxtpu_torch.kernels import lasso as tl
    from proxtpu_torch.kernels import tv
    from proxtpu_torch.parallel import (
        default_dp_mesh,
        sharded_solve_box_qp_batch,
        sharded_solve_lasso_batch,
        sharded_solve_lasso_batch_blocked,
        sharded_solve_lasso_batch_packed,
        sharded_solve_lasso_multirhs,
        sharded_solve_tv_batch,
    )
    from proxtpu_torch.tools import graft_entry, spmd_worker

    mesh = default_dp_mesh()
    total = {}

    def add(launches):
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n

    # the sharded main path: the flagship through the packed solver
    flagship = problems.lasso_problems(problems.BATCH)
    A, b, lam, Lf = problems_from_numpy(*flagship, device=DEVICE)
    check = lambda z: recheck(*flagship, z.cpu().numpy())  # noqa: E731
    launches, packed = sharded_pair(
        "sharded_solve_lasso_batch_packed(restart=True) "
        f"{MAIN_SHAPES[0]}",
        lambda: sharded_solve_lasso_batch_packed(
            A, b, lam, Lf, TOL, mesh=mesh, maxit=MAXIT, restart=True),
        lambda: tl.solve_lasso_batch_packed(A, b, lam, Lf, TOL, maxit=MAXIT,
                                            restart=True),
        card, ("fista_step",), check)
    assert check(packed[0]) <= 1.1 * TOL, check(packed[0])
    add(launches)
    add(sharded_pair(
        f"sharded_solve_lasso_batch {MAIN_SHAPES[0]}",
        lambda: sharded_solve_lasso_batch(A, b, lam, Lf, TOL, mesh=mesh,
                                          maxit=3000),
        lambda: tl.solve_lasso_batch(A, b, lam, Lf, TOL, maxit=3000),
        card, ("fb_step", "fista_step"), check)[0])
    del A, b, lam, Lf
    prob = problems.lasso_problems(*BLOCKED_SHAPES[0])
    Ak, bk, lk, Lk = problems_from_numpy(*prob, device=DEVICE)
    add(sharded_pair(
        f"sharded_solve_lasso_batch_blocked {BLOCKED_SHAPES[0]}",
        lambda: sharded_solve_lasso_batch_blocked(
            Ak, bk, lk, Lk, TOL, mesh=mesh, maxit=3000, iter_block=K),
        lambda: tl.solve_lasso_batch_blocked(Ak, bk, lk, Lk, TOL, maxit=3000,
                                             iter_block=K),
        card, ("fb_step", "fista_k_steps"),
        lambda z: recheck(*prob, z.cpu().numpy()))[0])
    del prob, Ak, bk, lk, Lk
    B, n = BOX_SHAPES[0]
    Qs, qs, gam = problems.box_qp_problems(B, n, seed=7)
    Q, q = (torch.tensor(v, device=DEVICE) for v in (Qs, qs))
    Lip = torch.tensor(0.95 / gam, device=DEVICE)
    for blocks, expect in ((K, ("pg_step", "pg_k_steps")),
                           (None, ("pg_step",))):
        solve = tb.solve_box_qp_batch if blocks is None else functools.partial(
            tb.solve_box_qp_batch_blocked, iter_block=blocks)
        add(sharded_pair(
            f"sharded_solve_box_qp_batch {(B, n)} iter_block={blocks}",
            lambda: sharded_solve_box_qp_batch(
                Q, q, -1.0, 1.0, Lip, 1e-4, mesh=mesh, maxit=10_000,
                iter_block=blocks),
            lambda: solve(Q, q, -1.0, 1.0, Lip, 1e-4, maxit=10_000),
            card, expect)[0])
    del Q, q, Lip
    Bt, H, W = TV_SHAPES[1]
    noisy = torch.tensor(tv_images(Bt, H, W), device=DEVICE)
    add(sharded_pair(
        f"sharded_solve_tv_batch {TV_SHAPES[1]}",
        lambda: sharded_solve_tv_batch(noisy, TV_LAM, TV_TOL, mesh=mesh,
                                       maxit=TV_MAXIT, iter_block=K),
        lambda: tv.solve_tv_batch(noisy, TV_LAM, TV_TOL, maxit=TV_MAXIT,
                                  iter_block=K),
        card, ("cp_k_steps",))[0])
    del noisy
    As_, b_, lams_, Lf_ = shared_problem()
    A1 = torch.tensor(As_, device=DEVICE)
    Bmat = torch.tensor(np.broadcast_to(b_, (len(lams_), len(b_))).copy(),
                        device=DEVICE)
    lam1 = torch.tensor(lams_, device=DEVICE)
    add(sharded_pair(
        f"sharded_solve_lasso_multirhs {As_.shape}, {len(lams_)} lambdas",
        lambda: sharded_solve_lasso_multirhs(A1, Bmat, lam1, Lf_, TOL,
                                             mesh=mesh, maxit=3000),
        lambda: tl.solve_lasso_multirhs(A1, Bmat, lam1, Lf_, TOL,
                                        maxit=3000),
        card, (), lambda z: shared_recheck(As_, b_, lams_, Lf_,
                                           z.cpu().numpy()))[0])
    # the row-sharded operator under PANOC and the consensus, at
    # dryrun_multichip's sizes, against their unsharded runs
    dev = torch.device(DEVICE, 0)
    for name, solve in (("PANOC, A row-sharded over dp",
                         spmd_worker.rows_panoc_solve),
                        ("ConsensusADMM, blocks over dp",
                         spmd_worker.consensus_solve)):
        solve(1, dev, mesh)  # warm-up
        x_s, it_s, dt = solve(1, dev, mesh)
        x_1, it_1, dt_1 = solve(1, dev, None)
        assert it_s == it_1 and torch.equal(x_s, x_1), (name, it_s, it_1)
        print(f"(w) {name}: {it_s} iterations, bit-equal to the unsharded "
              f"run; {dt:.4f} s, unsharded {dt_1:.4f} s  [{card}]")
    graft_entry.dryrun_multichip(1, "cuda")
    print("(w) dryrun_multichip(1): every layout matches its unsharded run")
    return total, packed, dp_tp_one_rank(card)


def dp_tp_one_rank(card):
    """Route (w)'s dp x tp case and route (y)'s reference:
    ``benchmarks/scaling.py --path shared_tp``'s problem (``spmd_worker.
    shared_tp_data``) unplaced on the card, one warm-up and one timed
    solve; then placed at a (1, 1) mesh on the one-rank NCCL group, so that
    the vmap-aware sum runs on NCCL: bit-equal, one all-reduce at init and
    one a step.  Returns the unplaced outputs and wall."""
    from proxtpu_torch.parallel import batched_run_loop, make_mesh
    from proxtpu_torch.parallel.sharded_ops import (
        all_reduce,
        full_tensor,
        sum_over,
    )
    from proxtpu_torch.tools import spmd_worker as w

    A, b, lams, Lf = w.shared_tp_data(w.SHARED_TP_LANES)
    it = w.dp_x_tp_iteration(A, b, lams, Lf, DEVICE)
    args = (w.SHARED_TP_MAXIT, w.SHARED_TP_TOL)

    def unplaced():
        return batched_run_loop(it, *args, check_every=w.SHARED_TP_K)

    unplaced()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = unplaced()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mesh = make_mesh((1, 1), ("dp", "tp"))
    out, wall_11, reduces = w.dp_x_tp_solve(mesh, it, *args, w.SHARED_TP_K)
    assert all(torch.equal(full_tensor(o), r) for o, r in zip(out, ref)), (
        "(w) dp x tp at (1, 1): differs from the unplaced run")
    assert bool(ref[2].all()), f"(w) dp x tp: {int((~ref[2]).sum())} left"
    steps = w.steps_run(ref[1], w.SHARED_TP_K, w.SHARED_TP_MAXIT)
    # what a step's collective costs here: the helper's all-reduce of the
    # step's buffer, and the same through sum_over under vmap
    buf = torch.zeros((len(lams), A.shape[1] + 1), device=DEVICE)
    group = mesh.get_group("tp")
    per_call = {}
    for name, fn in (("all_reduce", lambda: all_reduce(buf, group)),
                     ("sum_over under vmap", lambda: torch.func.vmap(
                         lambda t: sum_over(t, group))(buf))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        per_call[name] = 1e6 * (time.perf_counter() - t0) / 50
    print(f"(w) dp x tp at a (1, 1) mesh on NCCL, {len(lams)} lanes of "
          f"{A.shape}: bit-equal to the unplaced run; {reduces} all-reduces "
          f"over tp = 1 + {steps} steps; iterations mean "
          f"{ref[1].float().mean():.2f} max {int(ref[1].max())}; placed "
          f"{wall_11:.4f} s, unplaced {wall:.4f} s; us a call on "
          f"({len(lams)}, {A.shape[1] + 1}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in per_call.items())
          + f"  [{card}]")
    return ref, wall


TP_ONE_RANK_BUDGET_S = 60.0
# the tp legs' routes by spmd_worker.TP_CARD_ROUTES' name
TP_LEG_NAMES = {"multirhs": "(aa)", "panoc": "(ab)", "zerofpr": "(ab)",
                "adaptive_fista": "(ab)", "logistic_zerofpr": "(ab)",
                "drls": "(ac)"}


def phase_tp_one_rank(card):
    """Routes (aa), (ab) and (ac) unplaced on the card (a warm-up of a few
    steps, then one timed solve each): phase "tp legs"'s reference.  Then
    each at a (1, 1) mesh on a one-rank NCCL group: bit-equal to the
    unplaced run, the route taken and its all-reduces a step or trip
    (``spmd_worker.tp_leg_solve``).  The phase must end within
    TP_ONE_RANK_BUDGET_S.  Returns ``{route: (numpy problem, outputs,
    seconds)}``."""
    from proxtpu_torch.parallel import make_mesh
    from proxtpu_torch.parallel.sharded_ops import full_tensor
    from proxtpu_torch.tools import spmd_worker as w

    t_phase = time.perf_counter()
    out = {}
    with nccl_one_rank():
        mesh = make_mesh((1, 1), ("dp", "tp"))
        for route, data in w.tp_card_data().items():
            name = TP_LEG_NAMES[route]
            warm, kw_warm = w.tp_problem(route, data, DEVICE, 10,
                                         w.SHARED_TP_TOL)
            warm(**kw_warm)
            solve, kw = w.tp_problem(route, data, DEVICE, w.SHARED_TP_MAXIT,
                                     w.SHARED_TP_TOL)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = solve(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got, wall_11, reduces, steps = w.tp_leg_solve(
                mesh, route, solve, kw, w.SHARED_TP_MAXIT)
            assert all(torch.equal(full_tensor(o), r)
                       for o, r in zip(got, ref)), (
                f"{name} {route} at (1, 1): differs from the unplaced run")
            assert bool(ref[2].all()), (
                f"{name} {route}: {int((~ref[2]).sum())} lanes left")
            unit = "steps" if route == "multirhs" else "trips"
            print(f"{name} {route} at a (1, 1) mesh on NCCL, {len(ref[1])} "
                  f"lanes: bit-equal to the unplaced run; {reduces} "
                  f"all-reduces over tp in {steps} {unit}; iterations mean "
                  f"{ref[1].float().mean():.2f} max {int(ref[1].max())}; "
                  f"placed {wall_11:.4f} s, unplaced {wall:.4f} s  [{card}]")
            out[route] = (data, ref, wall)
    dt = time.perf_counter() - t_phase
    print(f"  tp legs at (1, 1): {dt:.1f} s (budget "
          f"{TP_ONE_RANK_BUDGET_S:.0f} s)  [{card}]")
    assert dt <= TP_ONE_RANK_BUDGET_S, (dt, TP_ONE_RANK_BUDGET_S)
    return out


def check_entry(card):
    """``tools/graft_entry.entry()`` with no argument builds on the card:
    its one vmapped FISTA step on the 64 x 128 x 256 batch against the same
    step on a CPU copy of its arguments, within 1e-5 (the card and the CPU
    sum the products in another order, so the bits may differ)."""
    from proxtpu_torch.tools import graft_entry
    from proxtpu_torch.utils.tree import flatten

    def on_cpu(tree):
        leaves, spec = flatten(tree)
        return spec.unflatten([l.cpu() for l in leaves])

    fn, (it, state) = graft_entry.entry()
    assert it.x0.device.type == "cuda", it.x0.device
    got = fn(it, state)
    want = fn(on_cpu(it), on_cpu(state))
    errs = {name: max_err(getattr(got, name).cpu(), getattr(want, name))
            for name in ("x", "z", "res")}
    assert max(errs.values()) <= 1e-5, errs
    print(f"entry(): one vmapped FISTA step on 64 x 128 x 256 on "
          f"{it.x0.device}, against a CPU copy: max|d| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit 1e-5)  [{card}]")


def sharding_two_ranks(card, packed):
    """Route (x): two Gloo ranks sharing the one card through
    ``python -m proxtpu_torch.tools.spmd_worker``, the flagship lanes held
    against route (w)'s unsharded solve."""
    import shutil

    from proxtpu_torch.tools import problems
    from proxtpu_torch.kernels import _build
    from proxtpu_torch.kernels import lasso as tl

    shutil.rmtree(SHARDING_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    subprocess.run(
        [sys.executable, "-m", "proxtpu_torch.tools.spmd_worker", "--ranks",
         str(SHARDING_RANKS), "--backend", "gloo", "--device", "cuda",
         "--cases", "card", "--out", SHARDING_DIR, "--timeout", "90"],
        check=True, timeout=120)
    dt = time.perf_counter() - t0
    with np.load(os.path.join(SHARDING_DIR, "spmd.npz")) as f:
        out = {k: f[k] for k in f.files}
    shutil.rmtree(SHARDING_DIR, ignore_errors=True)
    z, it, done = (out[f"flagship__{k}"] for k in ("z", "it", "done"))
    assert done.all(), f"(x): {int((~done).sum())} lanes left"
    z_w, it_w = packed[0].cpu().numpy(), packed[1].cpu().numpy()
    B, M, N = MAIN_SHAPES[0]
    sms, limit = _build.sm_count(0), _build.max_shared_bytes(0)
    plans = {b: tl.step_plan(b, M, N, sms, limit)
             for b in (B, B // SHARDING_RANKS)}
    apart = np.flatnonzero((it != it_w) | np.any(z != z_w, axis=1))
    worst = recheck(*problems.lasso_problems(problems.BATCH), z)
    if plans[B] == plans[B // SHARDING_RANKS]:
        assert apart.size == 0, f"(x): lanes {apart} differ from (w)"
    assert worst <= 1.1 * TOL, worst
    print(f"(x) {SHARDING_RANKS} Gloo ranks on one card: step_plan at B = "
          f"{B // SHARDING_RANKS} {plans[B // SHARDING_RANKS]}, at {B} "
          f"{plans[B]}; {apart.size} of {B} lanes apart from (w) "
          f"{apart.tolist()}; recheck {worst:.3e}; every lane done; ranks' "
          f"walls {out['flagship__walls'].round(4).tolist()} s, two-rank "
          f"wall {float(out['flagship__both']):.4f} s, fista_step launches "
          f"{out['flagship__launches'].astype(int).tolist()}; the worker "
          f"{dt:.1f} s  [{card}]")


@contextlib.contextmanager
def nccl_one_rank():
    """A one-rank NCCL process group (this process) around the block."""
    import socket

    import torch.distributed as dist

    from proxtpu_torch.parallel import initialize_distributed

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert initialize_distributed(f"localhost:{port}", 1, 0) == 1
    assert dist.get_backend() == "nccl"
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_sharding(card):
    """Routes (w) and (x): the sharding layer on the card; the phase must
    end within SHARDING_BUDGET_S.  Returns the kernel launches of (w) and
    route (y)'s unplaced reference."""
    t_phase = time.perf_counter()
    with nccl_one_rank():
        launches, packed, dp_tp = sharding_one_rank(card)
    sharding_two_ranks(card, packed)
    dt = time.perf_counter() - t_phase
    print(f"  sharding: {dt:.1f} s (budget {SHARDING_BUDGET_S:.0f} s)  "
          f"[{card}]")
    assert dt <= SHARDING_BUDGET_S, (dt, SHARDING_BUDGET_S)
    return launches, dp_tp


DP_TP_BUDGET_S = 120.0
DP_TP_DIR = os.path.join("build", "chip_smoke_dp_tp")
DP_TP_RANKS = 4  # route (y): a (2, 2) mesh of Gloo ranks sharing the card


def shared_residuals64(A, b, lams, Lf, xs):
    """Every lane's float64 FB residual on the shared A at gamma = 1 / Lf
    (the recheck of the JAX package's dp x tp test)."""
    A64, x = A.astype(np.float64), xs.astype(np.float64)
    gam = 1.0 / Lf
    y = x - gam * ((x @ A64.T - b) @ A64)
    z = np.sign(y) * np.maximum(np.abs(y) - gam * lams[:, None], 0.0)
    return np.max(np.abs(x - z), axis=1) / gam


def phase_dp_tp(card, one_rank):
    """Route (y): ``python -m proxtpu_torch.tools.spmd_worker --ranks 4
    --cases shared_tp``, the dp x tp composition of ``benchmarks/
    scaling.py --path shared_tp`` at full width on a (2, 2) mesh of Gloo
    ranks sharing the card (the worker asserts one all-reduce over tp at
    init and a step, none over dp, and tp ranks bit-equal).  Held: every
    lane done; the bits of the stripes' arithmetic emulated in this process
    (``spmd_worker.emulated_dp_x_tp``); against the unplaced run on one rank
    (``one_rank``, route (w)'s), the JAX test's slack: solutions within
    1e-3 and every lane's float64 recheck <= 1.2 tol.  The lanes whose
    count differs from the unplaced run's are printed: at this width a
    float32 sum in another order moves about four lanes in ten by an
    iteration or more (tests/test_torch_dp_tp.py run as a script), so the
    JAX test's 75% of equal counts, set at 16 lanes of 24 x 32, holds at
    that size (tests/test_torch_multiprocess.py) and is not a gate here.
    The phase must end within DP_TP_BUDGET_S."""
    import shutil

    from proxtpu_torch.tools import spmd_worker as w

    t_phase = time.perf_counter()
    shutil.rmtree(DP_TP_DIR, ignore_errors=True)
    subprocess.run(
        [sys.executable, "-m", "proxtpu_torch.tools.spmd_worker", "--ranks",
         str(DP_TP_RANKS), "--backend", "gloo", "--device", "cuda",
         "--cases", "shared_tp", "--out", DP_TP_DIR, "--timeout", "100"],
        check=True, timeout=110)
    dt_worker = time.perf_counter() - t_phase
    with np.load(os.path.join(DP_TP_DIR, "spmd.npz")) as f:
        out = {k.split("__", 1)[1]: f[k] for k in f.files}
    shutil.rmtree(DP_TP_DIR, ignore_errors=True)
    z, it, done = out["z"], out["it"], out["done"]
    A, b, lams, Lf = w.shared_tp_data(w.SHARED_TP_LANES)
    assert done.all(), f"(y): {int((~done).sum())} lanes left"
    emulated = [v.cpu().numpy() for v in w.emulated_dp_x_tp(
        A, b, lams, Lf, DEVICE, (DP_TP_RANKS // 2, 2), w.SHARED_TP_MAXIT,
        w.SHARED_TP_TOL, w.SHARED_TP_K)]
    assert all(np.array_equal(g, e) for g, e in zip((z, it, done),
                                                   emulated)), (
        "(y): the placed solve differs from its stripes emulated in one "
        "process")
    (z1, it1, _), wall1 = one_rank
    z1, it1 = z1.cpu().numpy(), it1.cpu().numpy()
    dz = float(np.abs(z - z1).max())
    worst = float(shared_residuals64(A, b, lams, Lf, z).max())
    apart = np.flatnonzero(it != it1)
    assert dz <= 1e-3, dz
    assert worst <= 1.2 * w.SHARED_TP_TOL, worst
    steps, reduces = out["steps"].astype(int), out["reduces"].astype(int)
    print(f"(y) {DP_TP_RANKS} Gloo ranks, (dp, tp) = (2, 2), "
          f"{w.SHARED_TP_LANES} lanes of {A.shape}, check_every "
          f"{w.SHARED_TP_K}: ranks' walls "
          + "; ".join(", ".join(f"{v:.4f}" for v in row)
                      for row in out["walls"])
          + f" s; four-rank walls (barrier to barrier) "
          f"{', '.join(f'{v:.4f}' for v in out['both'])} s; one rank "
          f"unplaced {wall1:.4f} s  [{card}]")
    print(f"(y) bit-equal to the stripes emulated in one process; "
          f"iterations mean {it.mean():.2f} max {int(it.max())} (unplaced "
          f"{it1.mean():.2f} / {int(it1.max())}); {apart.size} of {len(it)} "
          f"lanes apart in count from the unplaced run (max "
          f"{int(np.abs(it.astype(int) - it1).max())} iterations), max|dx| "
          f"{dz:.3e}; worst float64 recheck {worst:.3e} (limit "
          f"{1.2 * w.SHARED_TP_TOL:.1e}); all-reduces by rank "
          f"{reduces.tolist()} over {steps.tolist()} steps (one at init, "
          f"one a step, none over dp); "
          f"{', '.join(f'{v:.1f}' for v in out['reduce_us'])} us a Gloo "
          f"all-reduce of ({w.SHARED_TP_LANES // 2}, {A.shape[1] + 1}) "
          f"float32 on cuda:0; the worker {dt_worker:.1f} s  [{card}]")
    dt = time.perf_counter() - t_phase
    print(f"  dp x tp: {dt:.1f} s (budget {DP_TP_BUDGET_S:.0f} s)  "
          f"[{card}]")
    assert dt <= DP_TP_BUDGET_S, (dt, DP_TP_BUDGET_S)
    return out["walls"]


TP_LEGS_BUDGET_S = 180.0
TP_LEGS_DIR = os.path.join("build", "chip_smoke_tp_legs")


def phase_tp_legs(card, one_rank, y_walls):
    """Routes (aa), (ab) and (ac): ``python -m proxtpu_torch.tools.
    spmd_worker --ranks 4 --cases tp_legs``, the tp layout on the shared-A
    solver, the flat machines and DRLS on the least squares' prox at route
    (y)'s width on a (2, 2) mesh of Gloo ranks sharing the card (the
    worker asserts the route taken, the all-reduces a step or trip, none
    over dp, tp ranks bit-equal).  Held here: every lane done; the bits of
    the stripes emulated in this process (``spmd_worker.emulated_tp``);
    against the unplaced run on one rank (``one_rank``, from phase "tp
    legs at (1, 1)"), solutions within 1e-3 and every lane's float64 recheck <= 1.2 tol at
    the route's step (1 / Lf; the line searches' and DRLS's 0.95 / Lf: at a
    step gamma the recheck of z is the Douglas-Rachford residual ``||u -
    v|| / gamma`` at the point ``x = z + gamma grad f(z)``, whose ``u =
    prox_f(x)`` is z).  The logistic route is held, both runs, to the
    families' float64 gate, and its distance from the unplaced run is
    printed: two certified float32 answers of that problem sit a few 1e-3
    apart (on the CPU the unplaced run is 2.5e-3 from the float64 optimum,
    |x| up to 11.9).  The lanes apart in count are printed, not gated:
    float32 sums in another order (ROADMAP queue 3 watch item 1).
    ``y_walls``: route (y)'s ranks' walls, for (aa)'s ratio.  The phase
    must end within TP_LEGS_BUDGET_S."""
    import shutil

    from proxtpu_torch.tools import families as fam
    from proxtpu_torch.tools import spmd_worker as w

    t_phase = time.perf_counter()
    shutil.rmtree(TP_LEGS_DIR, ignore_errors=True)
    subprocess.run(
        [sys.executable, "-m", "proxtpu_torch.tools.spmd_worker", "--ranks",
         str(DP_TP_RANKS), "--backend", "gloo", "--device", "cuda",
         "--cases", "tp_legs", "--out", TP_LEGS_DIR, "--timeout", "150"],
        check=True, timeout=160)
    dt_worker = time.perf_counter() - t_phase
    with np.load(os.path.join(TP_LEGS_DIR, "spmd.npz")) as f:
        out = {k.split("__", 1)[1]: f[k] for k in f.files}
    shutil.rmtree(TP_LEGS_DIR, ignore_errors=True)
    for route, (data, (z1, it1, _), wall1) in one_rank.items():
        z, it, done = (out[f"{k}_{route}"] for k in ("z", "it", "done"))
        name = TP_LEG_NAMES[route]
        assert done.all(), f"{name} {route}: {int((~done).sum())} lanes left"
        emulated = [v.cpu().numpy() for v in w.emulated_tp(
            route, data, DEVICE, (DP_TP_RANKS // 2, 2), w.SHARED_TP_MAXIT,
            w.SHARED_TP_TOL)]
        assert all(np.array_equal(g, e) for g, e in zip((z, it, done),
                                                       emulated)), (
            f"{name} {route}: the placed solve differs from its stripes "
            "emulated in one process")
        z1, it1 = z1.cpu().numpy(), it1.cpu().numpy()
        dz = float(np.abs(z - z1).max())
        if route == "logistic_zerofpr":
            worst = max(float(fam.logistic_recheck(data, x).max())
                        for x in (z, z1))
            limit = 2 * fam.LOG_TOL
        else:
            A, b, lams, Lf = data
            step = 0.95 if route in ("panoc", "zerofpr", "drls") else 1.0
            worst = float(shared_residuals64(A, b, lams, Lf / step, z).max())
            limit = 1.2 * w.SHARED_TP_TOL
            assert dz <= 1e-3, (route, dz)
        apart = np.flatnonzero(it != it1)
        assert worst <= limit, (route, worst, limit)
        unit = "steps" if route == "multirhs" else "trips"
        walls = out[f"walls_{route}"]
        steps = out[f"steps_{route}"].astype(int).tolist()
        print(f"{name} {route}, {DP_TP_RANKS} Gloo ranks, (dp, tp) = (2, 2), "
              f"{len(it)} lanes: ranks' walls "
              f"{', '.join(f'{v:.4f}' for v in walls)} s; four-rank wall "
              f"{float(out[f'both_{route}']):.4f} s; one rank unplaced "
              f"{wall1:.4f} s; {unit} {steps}, all-reduces by rank "
              f"{out[f'reduces_{route}'].astype(int).tolist()} "
              f"({w.TP_ROUTES[route]} a {unit[:-1]}, none over dp)  [{card}]")
        print(f"{name} {route}: bit-equal to the stripes emulated in one "
              f"process; iterations mean {it.mean():.2f} max {int(it.max())} "
              f"(unplaced {it1.mean():.2f} / {int(it1.max())}); {apart.size} "
              f"of {len(it)} lanes apart in count from the unplaced run (max "
              f"{int(np.abs(it.astype(int) - it1).max())} iterations), max|dx|"
              f" {dz:.3e}; worst float64 recheck {worst:.3e} (limit "
              f"{limit:.1e})")
    aa, y = float(np.mean(out["walls_multirhs"])), float(np.mean(y_walls))
    print(f"(aa) against (y) on the same stripes: a rank's wall {aa:.4f} s "
          f"against {y:.4f} s, ratio {aa / y:.3f}  [{card}]")
    print("tp legs: us a Gloo all-reduce over tp on cuda:0, by rank: "
          + "; ".join(f"({lanes}, {n}) float32 "
                      + ", ".join(f"{v:.1f}" for v in us)
                      for (lanes, n), us in zip(out["reduce_sizes"],
                                                out["reduce_us"]))
          + f"; the worker {dt_worker:.1f} s  [{card}]")
    dt = time.perf_counter() - t_phase
    print(f"  tp legs: {dt:.1f} s (budget {TP_LEGS_BUDGET_S:.0f} s)  "
          f"[{card}]")
    assert dt <= TP_LEGS_BUDGET_S, (dt, TP_LEGS_BUDGET_S)


LILIN_BUDGET_S = 45.0
LILIN_TOL, LILIN_MAXIT = 1e-4, 2000
# route (b)'s lanes on which Li-Lin cycles in float64, the same in both
# packages at this cap (tests/test_torch_li_lin_batch.py run as a script)
LILIN_F64_CYCLING = [5, 7, 8, 10, 12, 17, 18, 20, 21, 30, 31, 34, 35, 36,
                     37, 38, 39, 42, 43, 47, 52, 56, 61, 63]


def phase_li_lin(card):
    """Route (z): ``BatchedAlgorithm(make_li_lin_iteration)`` on route (b)'s
    64 nonconvex box QPs of n = 512, float32, tol 1e-4, as the JAX
    package's ``benchmarks/families_bench.py`` runs it: one solve of every
    lane (Li-Lin's monitor accepts limit cycles on some lanes of this
    family, in float64 and in both packages; those lanes run to the cap and
    are printed beside the float64 ones), every lane it reports done
    rechecked <= 2 tol; then the lanes done, solved as their own batch,
    every lane done and rechecked <= 2 tol; the single-problem solver on
    lanes 0-7 beside the batched counts.  No kernel lies on this path.
    The phase must end within LILIN_BUDGET_S."""
    from proxtpu_torch import BatchedAlgorithm, LiLin, make_li_lin_iteration
    from proxtpu_torch.prox import IndBox, Quadratic
    from proxtpu_torch.tools import problems

    t_phase = time.perf_counter()
    counters = launch_counters()
    launches = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
    B, n = BOX_SHAPES[0]
    Qs, qs, gam = problems.box_qp_problems(B, n, seed=7)

    def solve(lanes):
        t0 = time.perf_counter()
        xs, iters, done = BatchedAlgorithm(
            make_li_lin_iteration, maxit=LILIN_MAXIT, tol=LILIN_TOL)(
            x0=torch.zeros(len(lanes), n, device=DEVICE),
            f=Quadratic(torch.tensor(Qs[lanes], device=DEVICE),
                        torch.tensor(qs[lanes], device=DEVICE)),
            g=IndBox(-1.0, 1.0), gamma=torch.tensor(gam[lanes],
                                                    device=DEVICE))
        torch.cuda.synchronize()
        return (xs.cpu().numpy(), iters.cpu().numpy(), done.cpu().numpy(),
                time.perf_counter() - t0)

    every = np.arange(B)
    solve(every[:4])  # warm-up (lanes that converge within 200 steps)
    xs, iters, done, dt_all = solve(every)
    res = box_residuals(Qs, qs, gam, xs)
    kept = np.flatnonzero(done)
    assert kept.size and np.isfinite(xs).all(), kept
    assert res[kept].max() <= 2 * LILIN_TOL, res[kept].max()
    xs_k, it_k, done_k, dt_k = solve(kept)
    res_k = box_residuals(Qs[kept], qs[kept], gam[kept], xs_k)
    assert done_k.all() and res_k.max() <= 2 * LILIN_TOL, (
        int((~done_k).sum()), res_k.max())
    print(f"(z) batched Li-Lin, box QP {(B, n)}, cap {LILIN_MAXIT}: "
          f"{kept.size}/{B} lanes done in {dt_all:.4f} s, worst recheck of "
          f"those {res[done].max():.3e} (limit {2 * LILIN_TOL:.0e}); not "
          f"done {np.flatnonzero(~done).tolist()} (float64, both packages: "
          f"{LILIN_F64_CYCLING}); the {kept.size} done lanes as their own "
          f"batch: all done in {dt_k:.4f} s, iterations mean "
          f"{it_k.mean():.2f} max {int(it_k.max())}, worst recheck "
          f"{res_k.max():.3e}, {int((it_k != iters[kept]).sum())} counts "
          f"apart from the first solve  [{card}]")
    singles, dt_s = [], time.perf_counter()
    for i in range(8):
        x, k = LiLin(tol=LILIN_TOL, maxit=LILIN_MAXIT)(
            x0=torch.zeros(n, device=DEVICE),
            f=Quadratic(torch.tensor(Qs[i], device=DEVICE),
                        torch.tensor(qs[i], device=DEVICE)),
            g=IndBox(-1.0, 1.0), gamma=float(gam[i]))
        r = float(box_residuals(Qs[i:i + 1], qs[i:i + 1], gam[i:i + 1],
                                x.cpu().numpy()[None])[0])
        assert k >= LILIN_MAXIT or r <= 2 * LILIN_TOL, (i, k, r)
        singles.append(k)
    dt_s = time.perf_counter() - dt_s
    print(f"(z) lanes 0-7: batched {iters[:8].tolist()}, single-problem "
          f"LiLin {singles} ({dt_s:.4f} s for the eight)  [{card}]")
    now = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
    assert now == launches, "(z): a kernel launched on the Li-Lin path"
    dt = time.perf_counter() - t_phase
    print(f"  batched Li-Lin: {dt:.1f} s (budget {LILIN_BUDGET_S:.0f} s)  "
          f"[{card}]")
    assert dt <= LILIN_BUDGET_S, (dt, LILIN_BUDGET_S)


EXAMPLES_BUDGET_S = 120.0
SVD_LIMIT = 5e-6  # LAPACK's float32 accuracy, against float64 on the host
COMPLEX_LASSO = (4, 24, 32)  # B, M, N (ROADMAP queue 3 fault 1's probe)


def _counts_text(counts):
    """A script's iteration counts, every 8th of a long list."""
    if isinstance(counts, dict):
        return "{" + ", ".join(f"{k}: {_counts_text(v)}"
                               for k, v in counts.items()) + "}"
    if isinstance(counts, list) and len(counts) > 16:
        return f"lanes 0, 8, ..: {counts[::8]}"
    return str(counts)


def _example_facts(name, out):
    """The numbers each script prints, for its line."""
    if name == "lasso_path":
        return (f"nnz lanes 0, 8, ..: {out['nnz'][::8].tolist()}, multirhs "
                f"against the batched drive {out['multirhs_gap']:.3e}")
    if name == "svm_path":
        return f"train accuracy {out['train_acc'][0]:.3f} .. " \
            f"{out['train_acc'][-1]:.3f}"
    if name == "multitask_lasso":
        return f"selected {out['selected'].tolist()} (the true support)"
    if name == "convergence_curves":
        return ", ".join(f"{k} last residual {float(v['curve'][-1]):.3e}"
                         for k, v in out.items())
    if name == "reference_tolerances":
        return f"worst float64 recheck {out['worst_residual']:.3e}"
    if name == "tv_denoise":
        return (f"PSNR {out['psnr_noisy']:.2f} -> "
                f"{out['psnr_denoised']:.2f} dB")
    if name == "tv1d_denoising":
        return f"SNR {out['snr_noisy']:.2f} -> {out['snr_denoised']:.2f} dB"
    if name == "isotonic_regression":
        return (f"MSE {out['mse_noisy']:.4f} -> {out['mse_vs_truth']:.4f}, "
                "both fits monotone")
    if name == "leading_eigenvector":
        return (f"rayleigh - lam_max {out['rayleigh'] - out['lam_max']:.3e}"
                f", 1 - align {1 - out['align']:.3e}")
    if name == "graphical_lasso":
        return (f"KKT diag {out['kkt_diag']:.3e}, nonzero "
                f"{out['kkt_nz']:.3e}, min eig {out['min_eig']:.4f}, no "
                "false edge on the path")
    if name == "portfolio_cvar":
        return (f"CVaR {out['cvar_opt']:.5f} against equal weights "
                f"{out['cvar_equal_weight']:.5f}, sum w - 1 "
                f"{np.sum(out['weights']) - 1:.3e}")
    if name == "phase_retrieval":
        return f"relative error {out['rel_error']:.3e}"
    if name == "robust_pca":
        return (f"rank {out['rank']} (true {out['true_rank']}), "
                f"{int(out['support_hat'].sum())} sparse entries, every "
                "corruption hit")
    if name == "sparse_linear_regression":
        return (f"selected {[n for n, _ in out['selected']]}, test MSE "
                f"{out['test_mse']:.2f}")
    return ""


def examples_svd(card, rpca):
    """A2: ``NuclearNorm(0.25).prox`` at gamma 1 / 2 on the card, float32,
    against the same prox by LAPACK in float64 on the host, at robust PCA's
    ``L + S`` (the card's last iterate) and a normal 60 x 50 (numpy rng
    0); each within SVD_LIMIT."""
    from proxtpu_torch.prox import NuclearNorm
    from proxtpu_torch.tools import svd_ways

    inputs = {"L + S of robust_pca": rpca["L"] + rpca["S"],
              "a normal 60 x 50": np.random.default_rng(0).standard_normal(
                  (60, 50)).astype(np.float32)}
    errs = {}
    for name, X in inputs.items():
        Z, _ = NuclearNorm(svd_ways.LAM).prox(
            torch.tensor(X, device=DEVICE), svd_ways.GAMMA)
        errs[name] = float(np.abs(Z.double().cpu().numpy()
                                  - svd_ways.host_prox(X)).max())
    print("  SVD of the nuclear-norm prox on the card, float32 against "
          "float64 LAPACK on the host: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit {SVD_LIMIT:.0e})  [{card}]")
    assert max(errs.values()) <= SVD_LIMIT, errs


def examples_complex_lasso(card):
    """A1: a complex64 lasso through ``BatchedAlgorithm`` with the default
    ``use_kernels`` takes the generic driver: no kernel launches, bit-equal
    to ``use_kernels=False``."""
    from proxtpu_torch import BatchedAlgorithm, \
        make_fast_forward_backward_iteration
    from proxtpu_torch.prox import LeastSquaresLoss, NormL1

    B, M, N = COMPLEX_LASSO
    rng = np.random.default_rng(3)
    A = ((rng.standard_normal((B, M, N)) + 1j * rng.standard_normal(
        (B, M, N))) / np.sqrt(2 * M)).astype(np.complex64)
    b = ((rng.standard_normal((B, M)) + 1j * rng.standard_normal((B, M)))
         / np.sqrt(2)).astype(np.complex64)
    lam = (0.1 * np.max(np.abs(np.einsum("bmn,bm->bn", A.conj(), b)),
                        axis=1)).astype(np.float32)
    Lf = np.array([np.linalg.norm(a, 2) ** 2 for a in A], np.float32)
    counters = launch_counters()

    def solve(use_kernels):
        return BatchedAlgorithm(
            make_fast_forward_backward_iteration, maxit=5000, tol=1e-5,
            use_kernels=use_kernels)(
            x0=torch.zeros(B, N, dtype=torch.complex64, device=DEVICE),
            f=LeastSquaresLoss(torch.tensor(A, device=DEVICE),
                               torch.tensor(b, device=DEVICE)),
            g=NormL1(torch.tensor(lam, device=DEVICE)),
            Lf=torch.tensor(Lf, device=DEVICE))

    before = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
    t0 = time.perf_counter()
    x, it, done = solve("auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
    x_g, it_g, done_g = solve(False)
    assert after == before, "a kernel launched on the complex lasso"
    assert bool(done.all()), it
    assert torch.equal(x, x_g) and torch.equal(it, it_g) and torch.equal(
        done, done_g), "the default route differs from use_kernels=False"
    print(f"  complex64 lasso {COMPLEX_LASSO} through BatchedAlgorithm, "
          f"default use_kernels: no kernel launched, bit-equal to "
          f"use_kernels=False, iterations {it.tolist()}, {wall:.3f} s  "
          f"[{card}]")


def phase_examples(card):
    """The JAX package's example scripts and its guides' code on the card
    (``proxtpu_torch/examples``): each of the 14 scripts' ``main`` at the
    script's size, seed, dtype and cap, held to the script's own oracle
    (``examples.check``), its wall and iterations printed beside the JAX
    package's counts on the CPU (``examples.JAX_ITERATIONS``) and how far
    they are apart (not held: the card sums in another order); the ten
    guide blocks (``examples/guides.py``), each held to what its block
    claims; the SVD check of the nuclear-norm prox (:func:`examples_svd`);
    the complex lasso on the default route (:func:`examples_complex_lasso`).
    The phase must end within EXAMPLES_BUDGET_S."""
    import importlib

    from proxtpu_torch import examples as ex
    from proxtpu_torch.examples import guides

    t_phase = time.perf_counter()
    counters = launch_counters()
    before = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
    walls, rpca = {}, None
    for name in ex.SCRIPTS:
        mod = importlib.import_module(f"proxtpu_torch.examples.{name}")
        t0 = time.perf_counter()
        out = mod.main(device=DEVICE)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        again = mod.main(device=DEVICE) if name == "multitask_lasso" else None
        ex.check(name, out, again)
        got, want = ex.iterations(name, out), ex.JAX_ITERATIONS[name]
        g, w = (np.array(ex.flat_counts(c), np.int64) for c in (got, want))
        apart = (f"{int((g != w).sum())} of {g.size} counts apart from the "
                 f"JAX package's, by at most {int(np.abs(g - w).max())}"
                 if g.size else "no count")
        print(f"  {name} ({ex.DTYPES[name]}): {walls[name]:.3f} s, "
              f"iterations {_counts_text(got)} (JAX on the CPU: "
              f"{_counts_text(want)}); {apart}; {_example_facts(name, out)}"
              f"  [{card}]")
        if name == "robust_pca":
            rpca = out
    t_guides = time.perf_counter()
    lines = []
    for key, fn in guides.BLOCKS.items():
        t0 = time.perf_counter()
        out = fn(device=DEVICE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        guides.check(key, out)
        label = f"{key[0]}:{key[1]}"
        jax_it = ex.GUIDES_JAX_ITERATIONS.get(label)
        its = ("" if jax_it is None else
               f", iterations {out['iterations']} (JAX {jax_it})")
        lines.append(f"{label} {dt:.3f} s{its}")
    print(f"  the guides' ten blocks on the card, float64: "
          + "; ".join(lines) + f"  [{card}]")
    dt_guides = time.perf_counter() - t_guides
    examples_svd(card, rpca)
    examples_complex_lasso(card)
    after = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    dt = time.perf_counter() - t_phase
    print(f"  examples: {dt:.1f} s (budget {EXAMPLES_BUDGET_S:.0f} s); the "
          f"14 scripts {sum(walls.values()):.1f} s, the guides "
          f"{dt_guides:.1f} s; kernel launches {launched or 'none'}  "
          f"[{card}]")
    assert dt <= EXAMPLES_BUDGET_S, (dt, EXAMPLES_BUDGET_S)


SCALING_BUDGET_S = 90.0
# block 7's cap at "high" and "default", where the solve may stall short of
# tol (at "highest" the block's own 2000)
SCALING_REDUCED_MAXIT = 500
# the blocks of docs/tpu_scaling.md that reach the kernels: 9
# (solve_lasso_batch: fb_step, then fista_step) and 11
# (solve_lasso_batch_packed under stream_solve: fista_step from the first
# step, the packed kernel's port)
SCALING_KERNELS = {9: {"fb_step", "fista_step"}, 11: {"fista_step"}}


def _stats(iters):
    it = torch.as_tensor(iters).double()
    return f"max {int(it.max())}, mean {float(it.mean()):.1f}"


def _apart(a, b):
    d = (torch.as_tensor(a).cpu().long()
         - torch.as_tensor(b).cpu().long()).abs()
    return f"{int((d > 0).sum())} of {d.numel()} apart, by at most " \
        f"{int(d.max())}"


def _scaling_facts(i, out, outs):
    """What block ``i`` of docs/tpu_scaling.md did and what it was held
    to, for its line."""
    from proxtpu_torch.examples import SCALING_POWER_JAX_WORST
    from proxtpu_torch.examples import scaling_guide as sg

    if i == 1:
        k = len(out["iters_single"])
        return (f"{out['iters'].numel()} lanes float64 (batch_problems "
                f"and the solve {out['wall']:.3f} s), iterations "
                f"{_stats(out['iters'])}, every lane done, worst recheck "
                f"{float(out['recheck'].max()):.3e} (2 tol "
                f"{2 * out['tol']:.0e}); lanes 0-{k - 1} alone through "
                f"FastForwardBackward: iterations {out['iters_single']}, "
                f"{_apart(out['iters_single'], out['iters'][:k])} from the "
                f"batch, recheck {float(out['recheck_single'].max()):.3e}")
    if i == 2:
        return (f"{out['iters'].numel()} lanes, torch.equal to block 1 (xs, "
                f"iters, done); block 1 {outs[1]['wall']:.3f} s")
    if i == 3:
        return (f"{out['iters'].numel()} lanes float64, backtrack_limit 32, "
                f"iterations {_stats(out['iters'])}, every lane done")
    if i == 4:
        rel = (out["Lfs"] - out["Lfs_exact"]).abs() / out["Lfs_exact"]
        loop = out["Lfs_looped"]
        gap = (out["Lfs"][:loop.numel()] - loop).abs() / loop
        return (f"{rel.numel()} lanes, 50 iterations: worst relative error "
                f"{float(rel.max()):.4e}, {int((rel > sg.OPNORM_CLAIM).sum())}"
                f" lanes past the text's 0.5% (held to the JAX block's own "
                f"worst on these As, {SCALING_POWER_JAX_WORST:.4e}); lanes "
                f"0-{loop.numel() - 1} against their unvmapped calls "
                f"{float(gap.max()):.1e}")
    if i in (5, 6):
        extra = ("" if i == 5 else
                 f", blocks {out['blocks']}, all-reduces "
                 f"{out['all_reduces']} "
                 f"({out['all_reduces'] // out['iterations']} an iteration: "
                 "the mean and the residual's max)")
        return (f"one-rank NCCL group, {out['iterations']} iterations in "
                f"{out['wall']:.3f} s, bit-equal to the unsharded run "
                f"({out['iterations_unsharded']}){extra}")
    if i == 7:
        runs = "; ".join(
            f"{k}: {r['wall']:.3f} s, {int(r['done'].sum())}/"
            f"{r['done'].numel()} lanes done (maxit {r['maxit']}), "
            f"iterations {_stats(r['iters'])}, worst recheck "
            f"{float(r['recheck'].max()):.3e}"
            for k, r in out["runs"].items())
        return (f"set_matmul_precision(\"default\") as written, then "
                f"{out['runs']['highest']['iters'].numel()} lanes float32 on "
                f"the generic driver, tol {out['tol']:.0e}: {runs} (the "
                "doc's \"stalls around 1e-3\" at \"default\" is a TPU "
                "figure, not held); the setting and the flags put back; "
                "allow_tf32 on at \"highest\": the solve raised "
                "RuntimeError, the flag restored")
    if i == 8:
        return (f"{out['iters'].numel()} lambdas float64 tol "
                f"{out['tol']:.0e}: warm iterations {_stats(out['iters'])} in "
                f"{out['wall']:.3f} s, cold {_stats(out['iters_cold'])} in "
                f"{out['wall_cold']:.3f} s "
                f"({out['wall_cold'] / out['wall']:.2f}x); recheck "
                f"{float(out['recheck'].max()):.3e} (1.05 tol), "
                f"warm - cold "
                f"{float((out['xs'] - out['xs_cold']).abs().max()):.3e} "
                "(50 tol)")
    if i == 9:
        return (f"{out['iters'].numel()} lanes float32, iterations "
                f"{_stats(out['iters'])}, recheck "
                f"{float(out['recheck'].max()):.3e} (2 tol); use_kernel=False "
                f"{_apart(out['iters'], out['iters_plain'])}")
    if i == 10:
        return (f"{out['iters'].numel()} lambdas float32, iterations "
                f"{_stats(out['iters'])}, recheck "
                f"{float(out['recheck'].max()):.3e} (2 tol); stacked copies "
                f"on the generic driver {out['wall_stacked']:.3f} s, "
                f"{_apart(out['iters'], out['iters_stacked'])}")
    if i == 11:
        p = out["problems"]
        worst = max(float(r.max()) for r in out["rechecks"])
        iters = torch.cat([o[1] for o in out["streamed"]])
        return (f"{len(out['streamed'])} payloads of "
                f"{p // len(out['streamed'])} lanes float32, depth 2: "
                f"{p / out['wall']:.0f} problems/s streamed, fenced one at a "
                f"time {out['wall_fenced']:.3f} s "
                f"({p / out['wall_fenced']:.0f} problems/s), torch.equal, "
                f"in order; iterations "
                f"{_stats(iters)}, recheck {worst:.3e} (2 tol)")
    if i == 12:
        return (f"{out['ranks']} Gloo ranks sharing the card ran "
                "dryrun_multichip: every sharded layout equals its unsharded "
                "run")
    raise KeyError(i)


# the rounding unit of each matmul precision's inputs: float32, TF32 (10
# bits kept) and bfloat16 (7 bits kept).  A float32 product's largest
# distance from the float64 one, over the largest magnitude of that, is
# held in its setting's band: ("high", "default") in [unit / 8, unit],
# "highest" under TF32's band
PRECISION_UNIT = {"highest": 2.0 ** -24, "high": 2.0 ** -11,
                  "default": 2.0 ** -8}
# the products held: the generic driver's batched matvec at MAIN_SHAPES[0]
# (pmatvec) and a square product (pdot)
PRECISION_SQUARE = 4096


def precision_products(card):
    """``pmatvec`` at MAIN_SHAPES[0] and ``pdot`` at PRECISION_SQUARE
    squared, float32, at each matmul precision: the time of one call, the
    largest distance from float64 over its largest magnitude, and the bits
    against ``"highest"``'s, printed.  Held: PyTorch's ``allow_tf32`` and
    float32 matmul precision are the caller's after every call; at
    ``"default"`` each product is the full-float32 product of its operands
    rounded to bfloat16, within float32 rounding (``2 K u`` times the
    product of the magnitudes, K the summed length, u = 2^-24: any two
    orders of the sum sit that close); the square's error lies in its
    setting's band (PRECISION_UNIT), the matvec's at ``"default"`` too.
    At ``"high"`` the matvec is not held to a band (printed: whether it
    keeps ``"highest"``'s bits)."""
    from proxtpu_torch.utils import precision as pp

    B, M, N = MAIN_SHAPES[0]
    S = PRECISION_SQUARE
    gen = torch.Generator(device=DEVICE).manual_seed(B + M + N + S)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE)

    # (product, operands, summed length, the reduced settings held to a
    # band)
    products = {
        f"matvec {B} x {M} x {N}": (pp.pmatvec, normal(B, M, N),
                                    normal(B, N), N, ("default",)),
        f"square {S}": (pp.pdot, normal(S, S), normal(S, S), S,
                        ("high", "default"))}
    flags = torch.backends.cuda.matmul
    caller = (flags.allow_tf32, torch.get_float32_matmul_precision())
    saved = pp.get_matmul_precision()
    try:
        for shape, (fn, a, b, K, banded) in products.items():
            pp.set_matmul_precision("highest")
            exact = fn(a.double(), b.double())
            scale = float(exact.abs().max())
            r16 = [t.to(torch.bfloat16).float() for t in (a, b)]
            want16 = fn(*r16)
            room16 = 2 * K * PRECISION_UNIT["highest"] * fn(
                *(t.double().abs() for t in r16))
            first, line = None, []
            for setting in ("highest", "high", "default"):
                pp.set_matmul_precision(setting)
                got = fn(a, b)
                ms = statistics.median(time_ms(lambda: fn(a, b), reps=10,
                                               inner=5))
                pp.set_matmul_precision("highest")
                kept = (flags.allow_tf32,
                        torch.get_float32_matmul_precision()) == caller
                assert kept, (shape, setting, "flags not put back")
                err = float((got.double() - exact).abs().max()) / scale
                first = got if first is None else first
                same = bool(torch.equal(got, first))
                line.append(f"{setting} {ms:.4f} ms, error {err:.3e}"
                            + ("" if setting == "highest" else
                               f", bits of highest {same}"))
                unit = PRECISION_UNIT[setting]
                if setting == "highest":
                    assert err < PRECISION_UNIT["high"] / 8, (shape, err)
                elif setting in banded:
                    assert unit / 8 <= err <= unit, (shape, setting, err)
                if setting == "default":
                    off = (got.double() - want16.double()).abs()
                    assert bool((off <= room16).all()), (
                        shape, float((off / room16).max()))
                    line.append("the product of the bfloat16-rounded "
                                "operands within float32 rounding "
                                f"(at most {float((off / room16).max()):.3e}"
                                f" of 2Ku|a||b|, bit-equal "
                                f"{bool(torch.equal(got, want16))})")
            print(f"  precision, {shape} float32: " + "; ".join(line)
                  + f"; flags put back  [{card}]")
    finally:
        pp.set_matmul_precision(saved)


def kernels_ignore_precision(card):
    """One ``fb_step`` and one ``fista_step`` at MAIN_SHAPES[0] give the
    same bits under ``set_matmul_precision("default")`` as under
    ``"highest"``: the hand-written kernels do not read the setting.
    These launches compare a kernel with itself and are in no count."""
    import proxtpu_torch as pt
    from proxtpu_torch.kernels import lasso as tl

    B, M, N = MAIN_SHAPES[0]
    d = step_inputs(B, M, N, seed=B + M + N)

    def steps():
        fb = tl.fused_fb_prox_grad(d["A"], d["b"], d["x"], d["gamma"],
                                   d["thr"])
        fista = tl.fused_fista_full_step(
            d["A"], d["b"], d["x"].clone(), d["z_prev"].clone(), d["beta"],
            d["gamma"], d["thr"], torch.zeros_like(d["done"]))
        torch.cuda.synchronize()
        return {"fb_step": fb, "fista_step": fista}

    want = steps()
    saved = pt.set_matmul_precision("default")
    try:
        got = steps()
    finally:
        pt.set_matmul_precision(saved)
    same = {k: all(torch.equal(g, w) for g, w in zip(got[k], want[k]))
            for k in want}
    print(f"  under set_matmul_precision(\"default\") against \"highest\" "
          f"at {(B, M, N)}: " + ", ".join(
              f"{k} {'the same bits' if v else 'DIFFERENT bits'}"
              for k, v in same.items()) + f"  [{card}]")
    assert all(same.values()), same


def start_dryrun():
    """Block 12 of docs/tpu_scaling.md (two Gloo ranks sharing the card in
    ``dryrun_multichip``) started in a thread: its processes run beside
    the phases that hold the kernels to their plain versions, which time
    nothing, and most of their wall is starting up.  The caller waits for
    the future before it times anything on the card."""
    import concurrent.futures

    from proxtpu_torch.examples import scaling_guide as sg

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(sg.BLOCKS[("tpu_scaling.md", 12)], device=DEVICE)
    pool.shutdown(wait=False)
    return future


def start_scaling_data():
    """Block 1's 4096 lanes and their Lipschitz constants
    (``scaling_guide.lassos``) made in a thread while phase "examples"
    runs: numpy's generator and the host's LAPACK leave the interpreter
    free, and the two take seconds of the host each."""
    import concurrent.futures

    from proxtpu_torch.examples import scaling_guide as sg

    def make():
        t0 = time.perf_counter()
        sg.lassos(sg.LANES)
        return time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(make)
    pool.shutdown(wait=False)
    return future


def phase_scaling_guide(card, data, dryrun):
    """The code blocks of docs/tpu_scaling.md on the card
    (``proxtpu_torch/examples/scaling_guide.py``), in order, each at the
    scale its own text gives and held to what its paragraph claims
    (``scaling_guide.check``); blocks 5 and 6 on a one-rank NCCL group,
    block 12 on two Gloo ranks of its own, run before (``dryrun``: its
    output, from :func:`start_dryrun`).  Each
    block's wall, lanes, iterations, what it was held to and its kernel
    launches are printed; block 9 launches fb_step and fista_step, block
    11 fista_step, no other block a kernel.  The phase must end within
    SCALING_BUDGET_S.  Returns the launches.  ``data``:
    :func:`start_scaling_data`'s future."""
    from proxtpu_torch.examples import scaling_guide as sg

    t_phase = time.perf_counter()
    made = data.result()
    print(f"  block 1's lasso_data({sg.LANES}, {sg.M}, {sg.N}) in float64 "
          f"and its Lipschitz constants: made in a thread in {made:.1f} s, "
          f"waited "
          f"{time.perf_counter() - t_phase:.1f} s  [{card}]")
    counters = launch_counters()
    outs, walls, total = {}, {}, {}
    group = contextlib.ExitStack()  # one NCCL group for blocks 5 and 6
    for key, fn in sg.BLOCKS.items():
        i = key[1]
        kw = ({"scenario": outs[1]} if i == 2 else
              {"reduced_maxit": SCALING_REDUCED_MAXIT} if i == 7 else {})
        before = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
        if i == 5:
            group.enter_context(nccl_one_rank())
        if i == 12:
            out = dryrun
            walls[i] = out["wall"]
        else:
            out, walls[i] = timed(functools.partial(fn, device=DEVICE, **kw))
        if i == 6:
            group.close()
        after = {k: getattr(wr, a) for k, (wr, a) in counters.items()}
        launched = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        sg.check(key, out)
        print(f"  tpu_scaling.md:{i} {fn.__name__}: {walls[i]:.3f} s; "
              f"{_scaling_facts(i, out, outs)}; kernel launches "
              f"{launched or 'none'}  [{card}]")
        assert set(launched) == SCALING_KERNELS.get(i, set()), (i, launched)
        for k, n in launched.items():
            total[k] = total.get(k, 0) + n
        outs[i] = out
    sg._lassos.cache_clear()
    sg.prepare.cache_clear()
    del outs
    kernels_ignore_precision(card)
    precision_products(card)
    dt = time.perf_counter() - t_phase
    print(f"  scaling guide: {dt:.1f} s (budget {SCALING_BUDGET_S:.0f} s); "
          "blocks " + ", ".join(f"{i} {w:.1f}" for i, w in walls.items())
          + f"  [{card}]")
    assert dt <= SCALING_BUDGET_S, (dt, SCALING_BUDGET_S)
    return total


def kernel_bounds():
    """``{kernel: (shape, ms, by)}``: the bound of each kernel at the shape
    its times in the JSON line are taken at.  Bytes: every operand read
    once, every result written once, float32.  Operations: see
    :func:`lasso_bound` (the box-QP kernels likewise, one product per
    step), :func:`cp_bound`, :func:`read_bound`."""
    B, M, N = MAIN_SHAPES[0]
    Bk, Mk, Nk = BLOCKED_SHAPES[0]
    Bq, n = BOX_SHAPES[0]
    Bt, H, W = TV_SHAPES[1]

    def box(B, n, steps):
        return bound(4 * (B * n * n + 3 * B * n + 5 * B),
                     steps * B * (2 * n * n + 6 * n))

    return {
        "fb_step": ((B, M, N),
                    *lasso_bound(B, M, N, *STEP_OPERANDS["fb_step"], 1)),
        "fista_step": ((B, M, N),
                       *lasso_bound(B, M, N, *STEP_OPERANDS["fista_step"], 1)),
        # the bfloat16-A instances: A at 2 bytes an entry
        "fb_step_bf16": ((B, M, N), *lasso_bound(
            B, M, N, *STEP_OPERANDS["fb_step"], 1, a_bytes=2)),
        "fista_step_bf16": ((B, M, N), *lasso_bound(
            B, M, N, *STEP_OPERANDS["fista_step"], 1, a_bytes=2)),
        # A, b, x, z_prev, t, gamma, thr, done -> x, z_prev, t, res
        "fista_k_steps": ((Bk, Mk, Nk), *lasso_bound(Bk, Mk, Nk, 4, 6, K)),
        # Q, q, x, gamma, lo, hi, done -> x, res
        "pg_step": ((Bq, n), *box(Bq, n, 1)),
        "pg_k_steps": ((Bq, n), *box(Bq, n, K)),
        "cp_k_steps": ((Bt, H, W), *cp_bound(Bt, H, W)),
        "read_reduce": ((B, M, N), *read_bound(B, M, N)),
        "read_reduce_bf16": ((B, M, N), *read_bound(B, M, N, 2)),
    }


def main():
    started = time.perf_counter()
    seconds = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    card = phase("identify", phase_identify)
    phase("build", phase_build)
    dryrun = start_dryrun()
    print("kernel vs plain on the card:")
    worst = phase("check f32", check_kernels)
    worst.update(phase("check k-steps, box QP", check_new_kernels))
    worst["cp_k_steps"] = phase("check TV", check_tv_kernel)
    worst["read_reduce"], worst["read_reduce_bf16"] = phase(
        "check read_reduce", check_read_reduce)
    worst.update(phase("check bf16", check_bf16_kernels))
    dryrun = phase("wait for block 12", dryrun.result)
    times, pace = phase("time one-step", time_kernels, card)
    bf16_times, bf16_library, bf16_floor_launches = phase(
        "time bf16", time_bf16_kernels, card, pace)
    times.update(bf16_times)
    box_times, box_pace = phase("time k-steps, box QP", time_new_kernels,
                                card)
    times.update(box_times)
    pace.update(box_pace)
    tv_times, tv_pace = phase("time TV", time_tv_kernel, card)
    pace.update(tv_pace)
    times["cp_k_steps"] = tv_times[TV_SHAPES[1]]
    print("read floor, read_reduce vs A.sum(dim=(1, 2)):")
    floors, floor_launches = phase("read floor", phase_read_floor, card)
    times["read_reduce"] = floors[MAIN_SHAPES[0]]
    print("cross-path contract at the reference test shapes:")
    phase("contract", check_contract_small)
    phase("TV contract", check_tv_contract_small)
    launches = phase("main path", phase_main_path, card, pace)
    print("library route, BatchedAlgorithm -> match_kernel_solver:")
    for k, n in phase("routes (a)-(d)", phase_routes, card, pace).items():
        launches[k] = launches.get(k, 0) + n
    print("the rest of the lasso family, routes (g) to (j):")
    for k, n in phase("routes (g)-(j)", phase_lasso_rest, card,
                      pace).items():
        launches[k] = launches.get(k, 0) + n
    print("TV route, BatchedAlgorithm -> match_tv_solver:")
    for k, n in phase("routes (e), (f)", phase_tv_routes, card,
                      pace).items():
        launches[k] = launches.get(k, 0) + n
    print("reference suite, benchmarks/run_benchmarks.py's ten "
          "configurations on lasso_medium:")
    phase("reference suite", phase_reference_suite, card)
    print("application families, the benchmark scripts' six families at "
          "their published sizes:")
    logistic = phase("application families", phase_families, card)
    print("flat machines and the warm start, routes (m)-(p):")
    for k, n in phase("flat machines", phase_flat, card, logistic).items():
        launches[k] = launches.get(k, 0) + n
    print("the drivers' remaining surface, routes (q)-(v):")
    for k, n in phase("drivers", phase_drivers, card).items():
        launches[k] = launches.get(k, 0) + n
    print("batched Li-Lin, route (z):")
    phase("batched Li-Lin", phase_li_lin, card)
    print("the sharding layer, routes (w) and (x):")
    sharded, dp_tp = phase("sharding", phase_sharding, card)
    for k, n in sharded.items():
        launches[k] = launches.get(k, 0) + n
    print("the dp x tp composition, route (y):")
    y_walls = phase("dp x tp", phase_dp_tp, card, dp_tp)
    print("the tp layout on the shared-A solver, the flat machines and "
          "DRLS, routes (aa), (ab), (ac):")
    tp_legs = phase("tp legs at (1, 1)", phase_tp_one_rank, card)
    phase("tp legs", phase_tp_legs, card, tp_legs, y_walls)
    phase("entry", check_entry, card)
    scaling_data = start_scaling_data()
    print("the examples and the guides' code on the card:")
    phase("examples", phase_examples, card)
    print("the code blocks of docs/tpu_scaling.md on the card:")
    for k, n in phase("scaling guide", phase_scaling_guide, card,
                      scaling_data, dryrun).items():
        launches[k] = launches.get(k, 0) + n
    launches["read_reduce"] = floor_launches
    launches["read_reduce_bf16"] = bf16_floor_launches
    kernels = {
        "fista_step": ("lasso_step.cu", "proxtpu/kernels/lasso.py:156"),
        "fb_step": ("lasso_step.cu", "proxtpu/kernels/lasso.py:37"),
        "fista_step_bf16": ("lasso_step.cu", "proxtpu/kernels/lasso.py:156"),
        "fb_step_bf16": ("lasso_step.cu", "proxtpu/kernels/lasso.py:37"),
        "fista_k_steps": ("lasso_step.cu", "proxtpu/kernels/lasso.py:768"),
        "pg_step": ("box_qp_step.cu", "proxtpu/kernels/box_qp.py:31"),
        "pg_k_steps": ("box_qp_step.cu", "proxtpu/kernels/box_qp.py:174"),
        "cp_k_steps": ("tv_step.cu", "proxtpu/kernels/tv.py:76"),
        "read_reduce": ("probe.cu", "benchmarks/trip_overhead_bench.py:83"),
        "read_reduce_bf16": ("probe.cu",
                             "benchmarks/trip_overhead_bench.py:83"),
    }
    assert all(launches[k] > 0 for k in kernels), launches
    bounds = kernel_bounds()
    # the one PyTorch call that computes a kernel's function, where there
    # is one: read_reduce's plain version is that call; its bf16 instance's
    # is A16.sum(dim=(1, 2), dtype=torch.float32)
    library = {"read_reduce": times["read_reduce"][1],
               "read_reduce_bf16": bf16_library}
    print(f"chip_smoke: {time.perf_counter() - started:.1f} s, the build "
          f"included; by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"  [{card}]")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"proxtpu_torch/csrc/{source}", "replaces": replaces,
         "shape": list(bounds[name][0]), "launches": launches[name],
         "max_abs_err": worst[name], "ms": times[name][0],
         "plain_ms": times[name][1], "bound_ms": bounds[name][1],
         "bound_by": bounds[name][2], "library_ms": library.get(name)}
        for name, (source, replaces) in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
