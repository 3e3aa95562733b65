#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sr_for_cfd_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each ending in `torch.cuda.synchronize()` so that a fault shows
where it happened; any failure ends the run with a non-zero exit code and
no result line:

1. build: compile `sr_for_cfd_tpu_torch/csrc/*.cu`, one nvcc per source,
   all started together (ptxas report printed), link and load the library.
2. kernels: each CUDA kernel against its plain PyTorch version on the same
   seeded inputs on the card: the red-black SOR pressure loop at 12x12 (the
   hybrid's coarse grid, the one-warp route) and 402x402 (the two-launch
   route; max_iter 64), the one-warp kernel also bit-equal (field, count,
   rms) to the single-block loop it replaced in both update modes at 64
   sweeps and on a solve the stall policy ends, both calls and both C
   entries alone timed in turns (new, old, old, new), device kernels per
   call counted with torch.profiler; the V-cycle loop at
   400x400 with the BFS spacing (3 cycles), and the whole-step kernel in
   five gates: design (a) on the BFS 10x10 coarse settings (K=500) and a
   16x16 QUICK cavity (K=4), design (b) forced on a 64x64 QUICK cavity,
   at 400x400 BFS in multigrid mode (K=10) and in point-iteration mode
   (K=1, omega 1.0), each design (b) gate also bit-equal to its staged
   form (a launch per momentum half-sweep with a host read per check, a
   launch per stage), whose call is timed too. The fused momentum pass
   (rows 3 and 4): one pass bit-equal (field and rms) to the staged
   half-sweeps and within REL_TOL of the plain version at 2048x2048
   (QUICK, 3 sweeps, the old field interior) and 402x402 (the north
   star's UPWIND, 1 sweep, the old field padded), each alone timed
   against the staged form; the big-grid momentum wrapper's pass and a
   10-pass solve against the plain version and bit-equal to the staged
   (host-exit) loop, also cut by max_iter at 1, 2, 5 and 9 passes; a k
   past the pass's shared memory (14) on the staged form; the fused
   step's device-exit momentum loop bit-equal to its host-exit loop at
   every batch position and on a north-star solve, both loops timed with
   their launches and host reads. The streamed V-cycle at 2048x2048:
   pass A, level-1 correction and pass B each alone against the plain
   versions, the fused passes (rows 6 and 7, one launch each) bit-equal to
   their staged forms (11 and 9 launches; pass A's x, level-1 right-hand
   side and entry rms, pass B's x) and timed against them in turns (fused,
   staged, staged, fused); one forced streamed cycle and a 5-cycle
   streamed solve against the plain loop (equal cycle counts) and bit-equal
   to the loop on the staged passes. The tiled red-black sweep (row 5) at
   2048x2048 (omega 1.9), the device-exit loop (the fused kernel, the
   exit state on the card, batches of 8 launches, one host read per
   batch) bit-equal to the plain version and to the host-exit
   loop (the one-sweep kernel, a finalize and a host read per sweep): one
   sweep, also on either tile side of the fused kernel (32 or 64 cells), a
   solve to a tolerance reached in 63 sweeps, max_iter at every position
   of a batch, and a 34x30 solve that the stall policy ends; the 63-sweep
   solve through the SOR kernel's two-launch form (row 1, divide form, a
   check every sweep); ms per sweep of each tile side and of the one-sweep
   kernel alone, of the two loops, of the plain version and of the
   two-launch form, host reads per solve. The V-cycle of rows 2 and 8 as the solvers run it (the levels above the
   tail level t on the stage kernels, levels t.. in one block, one CUDA
   graph replay per cycle) bit-equal, with equal counts, to its eager
   launches and to the stage form (every level on the stage kernels, one
   launch at a time: the cycle before the redesign) and to the stage form
   captured as a graph, at 400x400 BFS (3 cycles) and at the 2048x2048
   level-1 correction; the calls of both forms timed in this run, one
   replay of each graph and the tail alone too (CUDA events); t, kernels
   and host launches per cycle printed. The
   per-rank red-black sweep (row 9, the fused form: kb sweeps and the sum
   in one launch) on the seeded 2048x2048 field cut as 8 ranks' 256-row
   bands (omega 1.9, kb 1 and 8): own rows and residual sum bit-equal to
   the staged form (kb one-sweep launches and the sum) and to the plain
   version on every rank, the 8 bands stitched against kb whole-grid
   sweeps within 1e-6 of max|p|; bit-equal too at the blocks the one-rank
   main paths 5c and 5d give it (the 400x400 block at kb 8, every sharded
   level of the 2048x2048 V-cycle at kb 4, built as those paths build
   them); a kb past the fused form's shared memory (34, on the one-sweep
   form) bit-equal too; both forms' calls timed in this run, launches per
   call. Row 3's
   own time: the 400x400 multigrid gate's call less its V-cycles at one
   row 2 cycle's call time. Max abs
   difference against the stated tolerance, counts, kernel and plain
   times (CUDA events) and bounds.
3. non-fused main path: `run_hybrid_experiment` for the BFS Re=400 hybrid
   at full width with `use_pallas=True, fused_step=False` (10x10 coarse on
   the SOR kernel, the shipped 10->400 autoencoder, warm and cold 400x400
   fine solves on the V-cycle kernel), budgets 500 / 50 / 50. Every SOR
   call must take the one-warp route; the histogram of its sweeps per call
   is printed, and row 1 is timed again (call and C entry, in turns) at
   the mean count, from which its Lost is worked out.
4. fused main path: the JAX demos' `bfs_north_star` configuration
   (`scripts/run_demos.py:65-98, 187-208, 233-263`): fused coarse phase,
   500 steps per launch, design (a); fused fine phases in multigrid mode,
   10 steps per call, design (b), with RRE. Cut to budgets 2000 / 300 /
   300, RRE every 40 steps from step 0 in chunks of 280 (one jump per fine
   phase), plateau checks every 100 and the Cauchy check at 300.
5. big-grid main path: `scripts/scaling_bench.py`'s mg_pallas case at
   2048x2048 (lid-driven cavity, Re=1000, QUICK, dt=1e-3, use_pallas,
   multigrid), which the big-grid threshold routes to the tiled momentum
   kernel and the streamed V-cycle, through make_cavity_solver(...).solve:
   200 outer steps from the cold start, as the bench runs them.
5b. tiled main path: `scripts/scaling_bench.py`'s tiled case at 2048x2048
   (lid-driven cavity, Re=1000, QUICK, dt=1e-3, pressure_solver="tiled",
   pressure_sor=1.9) through create_lid_driven_cavity: 200 outer steps from
   the cold start in one chunk; the pressure must run on the tiled sweep
   kernel and never on the SOR kernel.
5c. SPMD sweeps path: `SpmdSolver(case, group)` (the row-decomposed
   solver over torch.distributed, one rank: an NCCL group of world size 1
   through a file:// store, made after the build and destroyed at the
   end) on the 400x400 cavity of `__graft_entry__.py:148-152` (Re=1000,
   QUICK, dt=1e-3, float32) with use_pallas=True and
   pressure_solver="sweeps": the pressure on the per-rank sweep, 100 steps
   from the cold start.
5d. SPMD multigrid path: the same solver on the 2048x2048 cavity of
   `scripts/scaling_bench.py` with use_pallas=True and
   pressure_solver="multigrid" (the sharded V-cycle, its smoother on the
   per-rank sweep), the bench's 200 steps.
   In 3, 4, 5, 5b, 5c and 5d the launch counters are set to 0 just before
   and read just after; each kernel of the path must have launched in its
   phases, and each fine phase of 4 must have attempted an RRE jump. 4
   prints design (b)'s launches and momentum host reads per fine step and
   5 the momentum launches and host reads per step, both the histogram of
   sweeps per device-exit momentum solve; 5 also passes A's and B's
   launches per step, and fails unless each launched one kernel per
   V-cycle. 5c
   and 5d print ms/iter, inner counts, row 9 launches and collectives per
   step.
6. references: the non-fused configuration of 3 and the fused one of 4 (with
   design (b) forced everywhere) at a small size (BFS 10x10 coarse, bicubic
   SR, 32x32 fine), the 48x48 cavity with mg_slab_rows=16 (the big-grid
   path at a small size) and the 48x48 tiled cavity (QUICK, Re=1000,
   dt=1e-3, 60 steps), on the card and with the plain PyTorch path on the
   CPU, and the SpmdSolver cavities of 5c at 32x32 (40 steps) and of 5d
   at 64x64 (20 steps; their CPU side on a gloo group of the same rank);
   iteration counts must be equal and fields within 1e-4 relative.
7. sweep and train. Gates first: row 3's batched launch (design (a) over a
   case axis, one block per case) at 10x10 and 50x50, 8 cases (Re
   100..800, the sweep's double-lid QUICK cavity, dt 1e-3, float32, K=500,
   each from its own seeded field) with case 5 masked out: every listed
   case bit-equal (fields, fluxes, res, counts) to its single design (a)
   launch, the masked case's inputs unchanged; at K=4 (inner tolerance
   1e-3) within REL_TOL of the plain version with equal counts, both
   timed. Then the main path, counters set to 0 before and read after:
   `batched_cavity_solve` over Re 100..800 at 10x10 and 50x50 with
   fused_step (the batched route, auto K=500, to the 100000-step budget:
   float32 never meets the 1e-6 criteria) and at 400x400 in the multigrid
   mode (design (b), a loop over the cases; cut to 300 steps); per size
   the iterations per case, batched launches (must be ceil(max count /
   K)) and host reads, s and ms per step; the 10x10 and 400x400 fields
   paired in memory as `load_paired_reynolds_multi` pairs them (the card
   has no h5py), Re 800 held out, `standardize_train_test`,
   `train_sr_autoencoder` at the reference's widths (10 -> 400, latent 50,
   batch 8, Adam 1e-3; cut to 50 epochs, logged every 10): s per epoch,
   samples/s, first and last loss (the loss must fall), best epoch;
   `evaluate_for_re(800)` (MAE and NMAE of a cut run); `export_models` to
   a temporary directory, the combined file reloaded by
   `SRModel.from_checkpoint` with bit-equal weights, predicting bit-equal
   under deterministic cuDNN (two predictions in the default mode
   compared too, printed). After it: one K=500
   launch of all 8 cases from each sweep's final fields timed in turns
   with one single-case launch, the 10x10 Re 400 case bit-equal to a solo
   `make_cavity_solver(..., steps_per_kernel=500)` solve, and one
   training step on the card against the CPU (TF32 off; loss within 1e-4
   relative, weights within 1e-5 of the largest) and twice on the card
   (bit-equal or not, printed).
8. CLI and persistence, after 6; its launches are printed on a line of
   their own and not added to the kernels line. 8a: `cli.main(["hybrid",
   ...])` for the BFS Re=400 hybrid at full width (the shipped 10->400
   autoencoder, `--fused --pressure-solver multigrid --steps-per-kernel
   10` on every phase, budgets 2000 / 300 / 300, output to a temporary
   directory), its results JSON parsed: row 3 must launch in every phase
   and row 2 in both fine phases; then `run_hybrid_experiment` with the
   same arguments; both under deterministic cuDNN. The coarse and cold
   iteration counts must be equal; the warm phase's iterations, V-cycle
   replays and momentum host reads of both runs are printed. Each
   phase's two .dat files must be written, and where h5py or matplotlib
   is missing one skip line per skipped writer printed (and none of its
   files written); the seconds of each `_full.dat` write are printed
   beside the phases' solve seconds. 8b: the 400x400 BFS on the same
   fused multigrid configuration (chunk 100) solved to 200 steps with
   `snapshot_every=100` and `profile_dir`: the snapshot bit-equal to the
   solver's state at 200, a new solver `resume_from` it starting at 200
   and running to 300 with finite fields and rows 2 and 3 launched, the
   trace naming fused-step and V-cycle kernels; the same at 48x48 (cavity,
   60 + 60 steps) on the card and on the CPU's plain path: equal counts,
   fields within 1e-4 relative. 8c: `SRModel.from_parts` on the shipped
   .msgpack parts predicting bit-equal to `from_checkpoint` of the
   combined file under deterministic cuDNN, and on the .h5 parts raising
   an ImportError that names h5py where h5py is missing (loading
   bit-equal where it is installed).
9. the native .dat writer and the decomposed workflow, after 8, on the
   one-rank NCCL group. 9b: `run_hybrid_experiment` for the BFS Re=400
   hybrid in the non-fused configuration of 3 (row 1 on the 10x10 coarse
   phase, the shipped 10->400 autoencoder) with both 400x400 fine phases
   behind `SpmdWorkflowAdapter` on `make_mesh(1, "x")`, built by the
   workflow's own `hybrid._decomposed` (the sharded V-cycle with row 9 as
   its smoother, as the workflow runs them for spmd_devices > 1), budgets
   500 / 30 / 30, under deterministic cuDNN, the artifacts written;
   counters set to 0 before and read after: row 1 must launch in the
   coarse phase, row 9 in both fine phases and row 2 in neither; each fine phase bit-equal, with equal counts, to the
   same SpmdSolver driven bare (warm from the same SR fields, and cold);
   ms/iter, row 9 launches per step, warm against cold iterations. 9a: the
   warm phase's 400x400 `_full.dat` through the native writer
   (`io/native_io.py`, g++ at first use; it must be the writer that ran)
   byte-identical to the Python writer, both timed in turns, and phase 8a's
   `_full.dat` writes (now native) against the solves they end. 9c:
   `batched_spmd_cavity_solve` on a 1x1 case x x mesh, the sweep's 8 Re at
   400x400 (double lid, QUICK, multigrid, plain PyTorch as in the JAX
   package), cut to 6 steps, each case bit-equal to its solo SpmdSolver
   run. 9d: `train_sr_autoencoder(mesh=make_mesh(1))` (an all_reduce a
   step) against mesh=None under deterministic cuDNN on 21 smooth seeded
   10->400 samples for 20 epochs: loss history and weights bit-equal, s
   per epoch. 9b's launches join the kernels line.

The last lines are a `{"kernels": [...]}` line, the card's name and power
limit as nvidia-smi prints them, and `{"ok": true, "device": {...}}`.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MODEL_FILE = "artifacts/vanilla_superres_10to400_swish_tpu_bfs.msgpack"
STATS_FILE = "artifacts/standardization_stats_10to400_swish_tpu_bfs.txt"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# kernel vs plain version: relative to the largest |value| of the plain
# result. Both run the same float32 arithmetic; they differ in rounding
# (reciprocal multiply vs divide, fused multiply-adds, summation order),
# ~1e-7 per operation, and the iterations are contractive.
REL_TOL = 2e-5

T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps, warm=True):
    """Mean ms per call of fn() over `reps` calls, CUDA events, after one
    warm-up call (`warm=False`: the caller has just run it)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launches_per_call(fn, counter):
    """The launches one call of fn() adds to `counter` (a kernel wrapper):
    the kernels line divides a path's launches by it to count calls."""
    before = counter.launches
    fn()
    return counter.launches - before


def bound_ms(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# floating-point operations per cell of the kernels' stencil updates: the
# volp-scaled Laplacian is 10, the residual b - Ap 1
FLOP_SOR_CELL = 14  # rb_sor.cu: Laplacian, residual, p + sor * r * inv_ap
FLOP_SMOOTH_CELL = 13  # mg_vcycle.cu: omega folded into inv_ap, x + r * inv_ap
FLOP_RESID_CELL = 11  # Laplacian and residual, r written
FLOP_SUMSQ_CELL = 2  # r * r and its sum, where the rms is taken


def wrapper_bytes(nx, ny):
    """Bytes a pressure wrapper must move: p (padded) and the four face
    fluxes (interior) read once, p written once, float32."""
    return 4 * (2 * (nx + 2) * (ny + 2) + 4 * nx * ny)


def rb_sor_work(nx, ny, sweeps, check_every):
    """(bytes, flops) of a red-black SOR solve: every sweep updates every
    interior cell once; the last sweep of each check also sums r^2."""
    checks = sweeps // check_every
    return wrapper_bytes(nx, ny), nx * ny * (FLOP_SOR_CELL * sweeps
                                             + FLOP_SUMSQ_CELL * checks)


def tiled_sweep_work(nx, ny):
    """(bytes, flops) of one tiled red-black sweep: f and b (padded) read
    once and f written once; every interior cell updated and its r^2
    summed."""
    return 3 * 4 * (nx + 2) * (ny + 2), nx * ny * (FLOP_SOR_CELL + FLOP_SUMSQ_CELL)


def mg_work(plan, n_pre, n_post, coarsest_sweeps, cycles):
    """(bytes, flops) of `cycles` V-cycles on `plan`: the wrapper's inputs
    and the band of each transfer matrix (with its [lo, hi) bounds) read
    once, p written once; per cycle every level is smoothed, its residual
    restricted, the correction prolonged, and the fine residual's rms
    taken."""
    sizes = plan.setup.sizes
    n0, m0 = sizes[0]
    mats = [bm for group in (plan.row_restrict, plan.col_restrict,
                             plan.row_prolong, plan.col_prolong)
            for bm in group if bm is not None]
    nbytes = wrapper_bytes(n0, m0) + sum(band_bytes(bm) for bm in mats)
    flops = (FLOP_RESID_CELL + FLOP_SUMSQ_CELL) * n0 * m0  # the fine rms
    return nbytes, (flops + level_flops(plan, n_pre, n_post, coarsest_sweeps)) * cycles


def band_size(bm):
    """Non-zero entries of a transfer matrix's band."""
    return int((bm.hi - bm.lo).sum().item())


def band_bytes(bm):
    """Bytes of a transfer matrix's band and its [lo, hi) bounds."""
    return 4 * band_size(bm) + 8 * bm.lo.numel()


def level_flops(plan, n_pre, n_post, coarsest_sweeps, start=0):
    """Flops of one V-cycle on the levels from `start` down: each level
    smoothed, its residual restricted, the correction prolonged."""
    sizes = plan.setup.sizes
    band = {id(bm): band_size(bm) for group in (
        plan.row_restrict, plan.col_restrict, plan.row_prolong, plan.col_prolong)
        for bm in group if bm is not None}
    flops = 0
    for lvl, (n, m) in enumerate(sizes):
        if lvl < start:
            continue
        if lvl + 1 == len(sizes):
            flops += FLOP_SMOOTH_CELL * n * m * coarsest_sweeps
            continue
        nc, mc = sizes[lvl + 1]
        flops += FLOP_SMOOTH_CELL * n * m * (n_pre + n_post)
        flops += FLOP_RESID_CELL * n * m
        mode = plan.row_mode[lvl]
        if mode == 1:  # exact-2x rows: 6 flops per restricted value, 3 per
            flops += 6 * nc * m + 3 * n * m  # prolonged one
        elif mode == 0:
            flops += 2 * m * (band[id(plan.row_restrict[lvl])]
                              + band[id(plan.row_prolong[lvl])])
        if plan.col_restrict[lvl] is not None:
            flops += 2 * nc * band[id(plan.col_restrict[lvl])]
            flops += 2 * nc * band[id(plan.col_prolong[lvl])]
        flops += nc * mc + n * m  # restriction scale, correction add
    return flops


def momentum_work(nx, ny, scheme, sweeps, passes):
    """(bytes, flops) of a tiled momentum solve: the padded field read and
    written once, the old field and four fluxes read once; every sweep
    updates every interior cell, the last sweep of each pass sums r^2."""
    cells = nx * ny
    nbytes = 4 * (2 * (nx + 2) * (ny + 2) + 5 * cells)
    return nbytes, cells * (FLOP_MOM_CELL[scheme] * sweeps + FLOP_SUMSQ_CELL * passes)


def stream_work(lv, part):
    """(bytes, flops) of one streamed V-cycle's pass A ("a"), level-1
    correction ("l1") or pass B ("b"), as `ops/stream_kernels.py` computes
    them on `lv`'s hierarchy."""
    from sr_for_cfd_tpu_torch.ops.mg_kernels import plan_hierarchy

    plan = plan_hierarchy(*lv.key, str(lv.device))
    cells, coarse_rows = lv.nf * lv.mf, lv.nc * lv.mf
    if part == "a":
        col = plan.col_restrict[0]
        nbytes = 4 * (3 * cells + lv.nc * lv.mc) + (band_bytes(col) if col else 0)
        flops = (FLOP_SMOOTH_CELL * lv.n_pre * cells  # the sweeps
                 + FLOP_RESID_CELL * cells // 2 + FLOP_SUMSQ_CELL * cells  # entry rms
                 + FLOP_RESID_CELL * cells + 7 * coarse_rows  # residual, rows
                 + (2 * lv.nc * band_size(col) if col else 0))
        return nbytes, flops
    if part == "l1":
        col = plan.col_prolong[0]
        mats = [bm for group in (plan.row_restrict, plan.col_restrict,
                                 plan.row_prolong, plan.col_prolong)
                for bm in group[1:] if bm is not None]
        nbytes = (4 * (lv.nc * lv.mc + coarse_rows) + sum(band_bytes(bm) for bm in mats)
                  + (band_bytes(col) if col else 0))
        flops = level_flops(plan, lv.n_pre, lv.n_post, lv.coarsest_sweeps, start=1)
        return nbytes, flops + (2 * lv.nc * band_size(col) if col else 0)
    return 4 * (3 * cells + coarse_rows), (4 + FLOP_SMOOTH_CELL * lv.n_post) * cells


# per cell of a momentum red-black sweep (fused_step.cu mom_residual and
# the update): 31 float32 operations upwind, 55 QUICK
FLOP_MOM_CELL = {"UPWIND": 31, "QUICK": 55}
# per cell and step outside the inner loops: fluxes and pressure RHS 12,
# projection 8, residual sums 9, Rhie-Chow 20; relaxation 3 per field
FLOP_STEP_CELL = 49
FLOP_RELAX_CELL = 3


def fused_work(case, counts, device):
    """(bytes, flops) of one call of the whole-step kernel with this run's
    inner counts (summed over its steps): the padded u, v, p and the four
    interior flux arrays read once and written once, float32; every sweep
    or V-cycle the counts report, and the per-step work."""
    from sr_for_cfd_tpu_torch.ops.mg_kernels import plan_hierarchy

    mesh, st = case.mesh, case.settings
    nx, ny = mesh.nx, mesh.ny
    cells = nx * ny
    k = st.steps_per_kernel
    nbytes = 2 * 4 * (3 * (nx + 2) * (ny + 2) + 4 * cells)
    mom_checks = (counts[0] + counts[1]) // max(1, st.momentum_check_every)
    flops = cells * (FLOP_MOM_CELL[st.scheme] * (counts[0] + counts[1])
                     + FLOP_SUMSQ_CELL * mom_checks)
    relaxed = sum(st.relax(c) != 1.0 for c in "uvp")
    flops += cells * k * (FLOP_STEP_CELL + FLOP_RELAX_CELL * relaxed)
    if st.pressure_solver == "multigrid":
        plan = plan_hierarchy(nx, ny, mesh.dx, mesh.dy, mesh.volp, st.mg_min_size,
                              str(device))
        flops += mg_work(plan, st.mg_n_pre, st.mg_n_post, st.mg_coarsest_sweeps,
                         counts[2])[1]
    else:
        flops += rb_sor_work(nx, ny, counts[2], max(1, st.pressure_check_every))[1]
    return nbytes, flops


def smooth_fields(seed, nx, ny, scale=0.1):
    """(ny, nx) fields u, v, p: an 8x8 numpy-seeded normal field, bicubic
    upsampled, so that every grid size gets a smooth state."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    out = {}
    for c in "uvp":
        coarse = torch.tensor(rng.standard_normal((1, 1, 8, 8)) * scale)
        out[c] = F.interpolate(coarse, size=(ny, nx), mode="bicubic",
                               align_corners=True)[0, 0].numpy()
    return out


def seeded_problem(rng, nx, ny, lx, ly, device):
    import torch

    from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes

    def field(scale):
        return torch.tensor(rng.standard_normal((nx + 2, ny + 2)) * scale,
                            dtype=torch.float32, device=device)

    u, v, p = field(0.1), field(0.1), field(0.01)
    dx, dy = lx / nx, ly / ny
    return p, face_fluxes(u, v, dx, dy), dict(dx=dx, dy=dy, dt=2e-3, rho=1.0,
                                               volp=dx * dy)


def check_pair(name, out_k, n_k, out_p, n_p, quiet=False, floor=1.0):
    """Max abs difference of kernel and plain outputs; fails beyond REL_TOL
    of max(floor, the plain output's largest |value|) or on unequal
    counts."""
    import torch

    err = float(torch.max(torch.abs(out_k - out_p)).item())
    scale = max(floor, float(torch.max(torch.abs(out_p)).item()))
    ok = math.isfinite(err) and err <= REL_TOL * scale and n_k == n_p
    if not quiet or not ok:
        log(f"  {name}: max_abs_err={err:.3e} (tol {REL_TOL:g} x {scale:.3e}) "
            f"count kernel={n_k} plain={n_p}")
    if not ok:
        fail(f"{name}: kernel and plain version disagree")
    return err


class CountingLib:
    """The kernel library with a count of its calls (host launches)."""

    def __init__(self, lib):
        self.lib, self.calls = lib, 0

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls += 1
            return fn(*args)

        return call


def cycle_forms(name, cyc, run, ref, reads, copies, reps):
    """The V-cycle `cyc` as the solvers run it (tail + CUDA graph) against
    its eager launches and the stage form (no tail, no graph) on the same
    inputs, and against the stage form captured as a graph (no tail):
    `run(c)` returns (output, cycles) on a cycle c, `ref` is run(cyc)'s;
    fails unless bit-equal with equal counts. Times the stage form's call,
    one replay of each graph (does the tail beat the graph nodes it
    replaces?) and the tail alone; counts kernels and host launches per
    cycle (library calls and replays, plus `reads` host reads per cycle;
    `copies` entry copies per call come on top)."""
    import torch

    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops.mg_kernels import _Cycle, _Tally

    forms = {}
    for form, flags in (("eager", dict(_graph=False)),
                        ("stage", dict(_tail=False, _graph=False)),
                        ("stage graph", dict(_tail=False))):
        c = _Cycle(cyc.plan, cyc.device, cyc.n_pre, cyc.n_post, cyc.sor,
                   cyc.coarsest_sweeps, counter=_Tally(), top=cyc.top, **flags)
        c.lib = CountingLib(c.lib)
        before = c.counter.launches
        out, n = run(c)
        torch.cuda.synchronize()
        bit = torch.equal(out, ref[0]) and n == ref[1]
        log(f"  {name}: {form} form bit-equal to the graph form {bit} "
            f"(max_abs_err {float((out - ref[0]).abs().max()):.3e}, cycles {n} / {ref[1]})")
        if not bit:
            fail(f"{name}: the {form} form differs from the graph form")
        forms[form] = (c, (c.counter.launches - before) / n, c.lib.calls / n + reads)
    counter = cyc.counter
    replays, launches = counter.replays, counter.launches
    cyc.lib = CountingLib(cyc.lib)
    try:
        n = run(cyc)[1]
        torch.cuda.synchronize()
        host = (cyc.lib.calls + counter.replays - replays) / n + reads
    finally:
        cyc.lib = cyc.lib.lib
    kernels = (counter.launches - launches) / n
    stage, eager = forms["stage"][0], forms["eager"][0]
    stage_ms = cuda_ms(lambda: run(stage), reps)
    eager.stream = kernel_lib.stream_ptr(cyc.device)
    tail_ms = cuda_ms(eager.tail, 100)
    # one cycle's graph, no host read: with the tail, and the stages alone
    replay_ms = cuda_ms(cyc.run, 50)
    stage_replay_ms = cuda_ms(forms["stage graph"][0].run, 50)
    numbers = dict(tail_level=cyc.t, tail_levels=list(cyc.setup.sizes[cyc.t:]),
                   kernels_per_cycle=kernels, host_launches_per_cycle=host,
                   entry_copies_per_call=copies,
                   stage_ms=stage_ms, stage_kernels_per_cycle=forms["stage"][1],
                   stage_host_launches_per_cycle=forms["stage"][2], tail_ms=tail_ms,
                   replay_ms=replay_ms, stage_replay_ms=stage_replay_ms,
                   bit_equal_stage=True, bit_equal_eager=True)
    log(f"  {name}: tail level t={cyc.t} {numbers['tail_levels']}; per cycle "
        f"{kernels:g} kernels and {host:g} host launches, {copies} entry copies per call "
        f"(stage form {forms['stage'][1]:g} and {forms['stage'][2]:g}); stage form's call "
        f"{stage_ms:.4f} ms; one cycle's graph replay {replay_ms:.5f} ms (the stages "
        f"alone as a graph {stage_replay_ms:.5f}); tail alone {tail_ms:.5f} ms")
    return numbers


def device_kernels_per_call(fn, calls=5):
    """Device kernels per call of fn() in a torch.profiler trace (memory
    copies and memsets not counted) and their names; (None, []) where the
    trace holds no device event at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None, []
    kernels = [n for n in dev if "Memcpy" not in n and "Memset" not in n]
    return len(kernels) / calls, sorted(set(kernels))


def row1_entries(lib, p, ff, geo, sweeps):
    """Launches of row 1's one-warp kernel and of the single-block loop it
    replaced, each C entry alone on buffers made here (the old loop's b
    built once, its field solved on in place), tol 0 and no stall exit:
    `sweeps` sweeps each."""
    import ctypes

    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
        Params,
        _coefficients,
        _padded_rhs,
    )
    from sr_for_cfd_tpu_torch.ops.sweeps import (
        STALL_MIN_CHECKS,
        STALL_RATIO,
        STALL_RESET_RATIO,
    )

    nx2, ny2 = p.shape
    dx2, dy2, sor, inv_ap, ap_d = _coefficients(geo["dx"], geo["dy"], geo["volp"], 1.0,
                                                nx2 - 2, ny2 - 2)
    coef = (dx2, dy2, geo["volp"], sor, inv_ap, ap_d, 0)
    stall = (STALL_RESET_RATIO, STALL_RATIO, 1 << 30, STALL_MIN_CHECKS)
    prm = Params(nx2, ny2, *coef, *stall, geo["rho"] / geo["dt"], 0.0, sweeps, 8)
    out, buf = torch.empty_like(p), p.clone()
    b = _padded_rhs(p, ff, geo["rho"], geo["dt"])
    state = torch.empty(2, dtype=torch.int32, device=p.device)
    stream = kernel_lib.stream_ptr(p.device)
    ptrs = [t.data_ptr() for t in (p, out, *ff, state)]

    def new():
        kernel_lib.check(lib.srcfd_rb_sor_warp(ctypes.addressof(prm), *ptrs, stream),
                         "rb_sor_warp")

    def old():
        kernel_lib.check(lib.srcfd_rb_sor_loop_small(
            buf.data_ptr(), b.data_ptr(), nx2, ny2, *coef, *stall, 0.0, sweeps, 8,
            state.data_ptr(), state.data_ptr() + 4, stream), "rb_sor_loop_small")

    return new, old


def row1_turns(p, ff, geo, sweeps, reps=50):
    """Row 1 at `sweeps` sweeps (tol 0): the wrapper's call (the one-warp
    route) and the old call (the single-block loop with b built and p
    copied on the host, its count read from device memory:
    card_solve(_kernel="block")), then each C entry alone, each pair in
    turns (new, old, old, new; CUDA events over `reps` calls)."""
    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
        card_solve,
        solve_pressure_kernel,
    )

    kw = dict(geo, tol=0.0, max_iter=sweeps, check_every=8, sor=1.0)

    def call():
        return solve_pressure_kernel(p, ff, **kw)

    def old_call():
        return card_solve(p, ff, **kw, _kernel="block")

    entry, old_entry = row1_entries(kernel_lib.load_library(), p, ff, geo, sweeps)
    n = call()[1]
    t = [cuda_ms(call, reps), cuda_ms(old_call, reps), cuda_ms(old_call, reps),
         cuda_ms(call, reps)]
    e = [cuda_ms(entry, reps), cuda_ms(old_entry, reps), cuda_ms(old_entry, reps),
         cuda_ms(entry, reps)]
    log(f"  rb_sor_pressure 12x12, {sweeps} sweeps ({n} run), in turns: the call {t[0]:.5f} / "
        f"{t[3]:.5f} ms (old {t[1]:.5f} / {t[2]:.5f}); the C entry alone {e[0]:.5f} / "
        f"{e[3]:.5f} ms (old {e[1]:.5f} / {e[2]:.5f})")
    return dict(ms=(t[0] + t[3]) / 2, old_ms=(t[1] + t[2]) / 2, turns_ms=t, sweeps_run=n,
                entry_ms=(e[0] + e[3]) / 2, old_entry_ms=(e[1] + e[2]) / 2,
                entry_turns_ms=e)


def row1_forms(p, ff, geo):
    """Row 1's one-warp kernel against the single-block loop it replaces
    on the hybrid's 12x12 coarse problem: field, count and rms bit-equal in
    both update modes at 64 sweeps and on a solve the stall policy ends
    (tol 1e-6, max_iter 1000); both calls and both C entries timed in
    turns at 64 sweeps; device kernels per call of each (torch.profiler)."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
        card_solve,
        solve_pressure_kernel,
    )

    gates = []
    for divide in (False, True):
        for label, stop in (("64 sweeps", dict(tol=0.0, max_iter=64)),
                            ("stall", dict(tol=1e-6, max_iter=1000))):
            name = f"rb_sor_pressure 12x12 {label}{' divide' if divide else ''}"
            kw = dict(geo, check_every=8, sor=1.0, divide=divide, **stop)
            out, n, rms = card_solve(p, ff, **kw, _kernel="warp")
            ref, n_ref, rms_ref = card_solve(p, ff, **kw, _kernel="block")
            torch.cuda.synchronize()
            bit = (torch.equal(out.view(torch.int32), ref.view(torch.int32)) and n == n_ref
                   and np.float32(rms).tobytes() == np.float32(rms_ref).tobytes())
            log(f"  {name}: warp kernel bit-equal to the block loop {bit} (counts {n} / "
                f"{n_ref}, rms {rms!r} / {rms_ref!r})")
            if not bit:
                fail(f"{name}: the one-warp kernel differs from the single-block loop")
            if label == "stall" and not (n < stop["max_iter"] and rms >= np.float32(1e-6)):
                fail(f"{name}: the solve did not end on a stall")
            gates.append(dict(gate=name, counts=n, rms=rms, bit_equal=True))
    turns = row1_turns(p, ff, geo, 64)
    kw = dict(geo, tol=0.0, max_iter=64, check_every=8, sor=1.0)
    per_call, names = device_kernels_per_call(lambda: solve_pressure_kernel(p, ff, **kw))
    old_per_call, old_names = device_kernels_per_call(
        lambda: card_solve(p, ff, **kw, _kernel="block"))
    log(f"  rb_sor_pressure 12x12: device kernels per call {per_call} {names} (old "
        f"{old_per_call}: {old_names})")
    if per_call is None:
        fail("the profiler traced no device kernel of the one-warp route")
    if per_call != 1:
        fail("the one-warp route ran another kernel than its own")
    return dict(turns, gates=gates, device_kernels_per_call=per_call,
                old_device_kernels_per_call=old_per_call)


def row1_at_main_count(device, sweeps):
    """Row 1 at the non-fused coarse phase's mean sweeps per call (a
    multiple of 8), on phase_kernels' 12x12 problem: the calls and C
    entries in turns, and the bound at that count."""
    import numpy as np

    p, ff, geo = seeded_problem(np.random.default_rng(1234), 10, 10, 10.0, 3.0, device)
    turns = row1_turns(p, ff, geo, sweeps)
    b_ms, b_by = bound_ms(*rb_sor_work(10, 10, sweeps, 8))
    return dict(main_sweeps=sweeps, main_ms=turns["ms"], main_old_ms=turns["old_ms"],
                main_entry_ms=turns["entry_ms"], main_old_entry_ms=turns["old_entry_ms"],
                main_bound_ms=b_ms, main_bound_by=b_by)


def phase_kernels(device):
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops.mg_kernels import (
        cached_cycle,
        cycle_solve,
        mg_solve_pressure_kernel,
        plan_hierarchy,
    )
    from sr_for_cfd_tpu_torch.ops.multigrid import MG_SMOOTHER_SOR, mg_solve_pressure
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
        solve_pressure_kernel,
        solve_pressure_plain,
    )

    rng = np.random.default_rng(1234)
    results, problems = {}, {}
    # red-black SOR: the hybrid's coarse grid (10x10 interior, BFS domain;
    # the one-warp route) and a 402x402 padded field (the two-launch
    # route); fixed 64 sweeps
    for label, n in (("12x12", 10), ("402x402", 400)):
        p, ff, geo = seeded_problem(rng, n, n, 10.0, 3.0, device)
        problems[label] = (p, ff, geo)
        kw = dict(geo, tol=0.0, max_iter=64, check_every=8, sor=1.0)
        out_k, n_k = solve_pressure_kernel(p, ff, **kw)
        out_p, n_p = solve_pressure_plain(p, ff, **kw)
        torch.cuda.synchronize()
        err = check_pair(f"rb_sor_pressure {label}", out_k, n_k, out_p, n_p)
        ms = cuda_ms(lambda: solve_pressure_kernel(p, ff, **kw), 20)
        plain = cuda_ms(lambda: solve_pressure_plain(p, ff, **kw), 3)
        nb, fl = rb_sor_work(n, n, n_k, kw["check_every"])
        b_ms, b_by = bound_ms(nb, fl)
        log(f"  rb_sor_pressure {label}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}), {n_k} sweeps")
        results[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by,
                              launches_per_call=launches_per_call(
                                  lambda: solve_pressure_kernel(p, ff, **kw),
                                  solve_pressure_kernel))
    results["12x12"].update(row1_forms(*problems["12x12"]))
    # V-cycle: the fine grid of the hybrid, 400x400 on the 10x3 BFS domain
    p, ff, geo = seeded_problem(rng, 400, 400, 10.0, 3.0, device)
    kw = dict(geo, tol=1e-30, max_cycles=3)
    out_k, n_k = mg_solve_pressure_kernel(p, ff, **kw)
    out_p, n_p = mg_solve_pressure(p, ff, **kw)
    torch.cuda.synchronize()
    err = check_pair("mg_vcycle_pressure 400x400", out_k, n_k, out_p, n_p)
    ms = cuda_ms(lambda: mg_solve_pressure_kernel(p, ff, **kw), 10)
    plain = cuda_ms(lambda: mg_solve_pressure(p, ff, **kw), 3)
    plan = plan_hierarchy(400, 400, geo["dx"], geo["dy"], geo["volp"], 8,
                          str(p.device))
    nb, fl = mg_work(plan, 4, 4, 40, n_k)
    b_ms, b_by = bound_ms(nb, fl)
    log(f"  mg_vcycle_pressure 400x400: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}), {n_k} cycles, levels {plan.setup.sizes}")
    # the cycle the wrapper replays (its cache entry), its eager launches and
    # the stage form, on the same frozen-ghost system
    solve_kw = dict(dt=geo["dt"], rho=geo["rho"], tol=1e-30, max_cycles=3)
    cyc = cached_cycle(400, 400, geo["dx"], geo["dy"], geo["volp"], 8, str(p.device),
                       4, 4, MG_SMOOTHER_SOR, 40)
    forms = cycle_forms("mg_vcycle_pressure 400x400", cyc,
                        lambda c: cycle_solve(c, p, ff, **solve_kw), (out_k, n_k),
                        reads=1, copies=2, reps=10)
    results["400x400"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, cycles=n_k,
                              bound_ms=b_ms, bound_by=b_by, **forms,
                              launches_per_call=launches_per_call(
                                  lambda: mg_solve_pressure_kernel(p, ff, **kw),
                                  mg_solve_pressure_kernel))
    return results


# (label, design, case, solver keywords); the inner tolerances are ones
# the loops reach before the float32 floor, where the stall policy's exits
# are chaotic, so that the counts of kernel and plain version can be held
# equal: 1e-3 except on the 16x16 cavity (1e-6, the default)
FUSED_GATES = [
    ("a BFS 10x10 coarse K=500", "a", "bfs",
     dict(nx=10, ny=10, scheme="UPWIND", pressure_solver="sweeps",
          pressure_sor=1.5, inner_max_iter=64, inner_tolerance=1e-3,
          steps_per_kernel=500)),
    ("a cavity 16x16 QUICK K=4", "a", "cavity",
     dict(Re=100, nx=16, ny=16, dt=2e-3, scheme="QUICK", steps_per_kernel=4)),
    ("b cavity 64x64 QUICK K=2", "b", "cavity",
     dict(Re=100, nx=64, ny=64, dt=2e-3, scheme="QUICK", inner_tolerance=1e-3,
          steps_per_kernel=2)),
    ("b BFS 400x400 multigrid K=10", "b", "bfs",
     dict(nx=400, ny=400, pressure_solver="multigrid", inner_tolerance=1e-3,
          steps_per_kernel=10)),
    ("b BFS 400x400 sweeps K=1", "b", "bfs",
     dict(nx=400, ny=400, pressure_solver="sweeps", pressure_sor=1.0,
          inner_tolerance=1e-3, steps_per_kernel=1)),
]


def phase_fused(device):
    """The whole-step kernel against its plain version on the same seeded
    state: fields within REL_TOL of the largest |value|, equal counts;
    design (b) bit-equal to its staged form (its momentum on the fused
    pass's device-exit loop, its stages folded, against half-sweep
    launches with a host read per check and a launch per stage), whose
    call is timed too."""
    import torch

    from sr_for_cfd_tpu_torch.ops.mg_kernels import mg_solve_pressure_kernel
    from sr_for_cfd_tpu_torch.ops.step_kernels import (
        simple_step_kernel,
        simple_step_plain,
    )
    from sr_for_cfd_tpu_torch.solver.cases import make_bfs_solver, make_cavity_solver

    results = []
    for seed, (label, design, case, kw) in enumerate(FUSED_GATES):
        make = make_bfs_solver if case == "bfs" else make_cavity_solver
        solver = make(device=device, dtype="float32", fused_step=True,
                      chunk_size=kw["steps_per_kernel"], **kw)
        solver.warm_start(smooth_fields(seed, solver.mesh.nx, solver.mesh.ny))
        s, c, prof, nu = solver.state, solver.case, solver.profile, solver._nu

        def kernel():
            return simple_step_kernel(s.u, s.v, s.p, s.ff, c, prof, nu=nu,
                                      _design=design)

        def plain():
            return simple_step_plain(s.u, s.v, s.p, s.ff, c, prof, nu=nu)

        out_k = kernel()
        # the plain call timed as it runs once for the check (CUDA events)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out_p = plain()
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        fields = []  # (err / tol, err, tol) per field and flux array
        for a, b in zip((*out_k[:3], *out_k[3]), (*out_p[:3], *out_p[3])):
            e = check_pair(f"fused_step {label}", a, out_k[5], b, out_p[5], quiet=True)
            tol = REL_TOL * max(1.0, float(torch.max(torch.abs(b)).item()))
            fields.append((e / tol, e, tol))
        worst = max(fields, key=lambda f: f[0])
        err = max(f[1] for f in fields)
        log(f"  fused_step {label}: max_abs_err={err:.3e}; worst field {worst[1]:.3e} "
            f"against its tolerance {worst[2]:.3e} (REL_TOL x max|value|); "
            f"counts kernel={out_k[5]} plain={out_p[5]} (equal)")
        k = kw["steps_per_kernel"]
        reps = 5 if design == "a" or kw["nx"] < 100 else 3
        if design == "b":
            def staged():
                return simple_step_kernel(s.u, s.v, s.p, s.ff, c, prof, nu=nu,
                                          _design="b", _staged=True)

            out_s = staged()
            torch.cuda.synchronize()
            checks = []
            same(checks, f"fused_step {label}, design (b) vs its staged form",
                 (*out_k[:3], *out_k[3], out_k[4]), out_k[5],
                 (*out_s[:3], *out_s[3], out_s[4]), out_s[5])
            # in turns, kernel, staged, staged, kernel: the call is host-bound
            times = [cuda_ms(fn, reps) for fn in (kernel, staged, staged, kernel)]
            ms, staged_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        else:
            ms = cuda_ms(kernel, reps)
        nb, fl = fused_work(c, out_k[5], device)
        b_ms, b_by = bound_ms(nb, fl)
        log(f"  fused_step {label}: kernel {ms:.4f} ms per call ({ms / k:.5f} per step), "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms per call "
            f"({b_ms / k:.3e} per step, {b_by})")
        # the V-cycles (row 2's graph replays) inside one call
        cycles = mg_solve_pressure_kernel.replays
        kernel()
        cycles = mg_solve_pressure_kernel.replays - cycles
        gate = dict(gate=label, design=design, steps=k, counts=out_k[5],
                    vcycles_per_call=cycles,
                    launches_per_call=launches_per_call(kernel, simple_step_kernel),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by)
        if design == "b":
            reads = simple_step_kernel.reads
            kernel()
            reads = simple_step_kernel.reads - reads
            staged_reads = simple_step_kernel.reads
            staged()
            staged_reads = simple_step_kernel.reads - staged_reads
            staged_launches = launches_per_call(staged, simple_step_kernel)
            log(f"  fused_step {label}: staged form {staged_ms:.4f} ms per call (in turns "
                f"with design (b): {', '.join(f'{t:.4f}' for t in times)}), "
                f"{staged_launches} launches and {staged_reads} momentum host reads (design "
                f"(b): {gate['launches_per_call']} and {reads})")
            gate.update(bit_equal_staged=True, staged_ms=staged_ms,
                        staged_launches_per_call=staged_launches,
                        momentum_reads_per_call=reads,
                        staged_momentum_reads_per_call=staged_reads)
        results.append(gate)
    return results


BIG_N = 2048  # the big-grid gates and main path: scaling_bench.py's 2048^2


def max_err(pairs):
    """Largest |kernel - plain| and its ratio to REL_TOL x max|plain| over
    (kernel, plain) output pairs; fails beyond the tolerance."""
    import torch

    err, worst = 0.0, 0.0
    for k, p in pairs:
        e = float(torch.max(torch.abs(k - p)).item())
        tol = REL_TOL * max(1.0, float(torch.max(torch.abs(p)).item()))
        if not (math.isfinite(e) and e <= tol):
            fail(f"kernel and plain version differ by {e:.3e} (tolerance {tol:.3e})")
        err, worst = max(err, e), max(worst, e / tol)
    return err, worst


def phase_big_grid_kernels(device):
    """The streamed V-cycle's kernels against their plain versions at 2048^2
    on the same seeded inputs: pass A, the level-1 correction and pass B
    each alone, the fused passes also bit-equal to their staged forms and
    timed against them in turns; one forced streamed V-cycle and a 5-cycle
    streamed solve, also bit-equal to the loop on the staged passes. (The
    big grid's momentum: phase_momentum_kernels.)"""
    import numpy as np

    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
    from sr_for_cfd_tpu_torch.ops.mg_kernels import _Tally
    from sr_for_cfd_tpu_torch.ops.multigrid import frozen_ghost_rhs

    n = BIG_N
    rows, gates = {}, []

    # the streamed V-cycle on a seeded pressure problem, cavity spacing
    rng = np.random.default_rng(4321)
    p, ff, geo = seeded_problem(rng, n, n, 1.0, 1.0, device)
    lv = sk.StreamLevels(n, n, geo["dx"], geo["dy"], geo["volp"], device)
    inv_dx2, inv_dy2 = lv.setup.spacings[0]
    b = frozen_ghost_rhs(p, ff, geo["dt"], geo["rho"], geo["volp"], inv_dx2,
                         inv_dy2).contiguous()
    x = p[1:-1, 1:-1].contiguous()
    xa, b1, rms = sk.stream_pass_a(x, b, lv)
    xa_p, b1_p, rms_p = sk.stream_pass_a_plain(x, b, lv)
    err, worst = max_err([(xa, xa_p), (b1, b1_p), (rms, rms_p.reshape(1))])
    log(f"  stream_pass_a {n}^2: max_abs_err={err:.3e} ({worst:.3f} of its "
        f"tolerance), entry rms kernel={rms.item():.6e} plain={rms_p.item():.6e}")
    staged = sk.stream_pass_a_staged(x, b, lv, counter=_Tally())
    same(gates, f"stream_pass_a {n}^2 fused vs staged (x, b1, entry rms)", (xa, b1, rms), 1,
         staged, 1)
    rows["stream_pass_a"] = dict(max_abs_err=err, **timed(
        "stream_pass_a", lambda: sk.stream_pass_a(x, b, lv),
        lambda: sk.stream_pass_a_plain(x, b, lv), stream_work(lv, "a"),
        counter=sk.stream_pass_a))
    rows["stream_pass_a"].update(pass_turns(
        "stream_pass_a", lambda: sk.stream_pass_a(x, b, lv),
        lambda c: sk.stream_pass_a_staged(x, b, lv, counter=c)))
    e = sk.level1_correction(b1_p, lv).clone()
    e_p = sk.level1_correction_plain(b1_p, lv)
    err, worst = max_err([(e, e_p)])
    log(f"  stream_level1_correction {n}^2 (levels {lv.setup.sizes[1:]}): "
        f"max_abs_err={err:.3e} ({worst:.3f} of its tolerance)")
    rows["stream_level1"] = dict(max_abs_err=err, **timed(
        "stream_level1_correction", lambda: sk.level1_correction(b1_p, lv),
        lambda: sk.level1_correction_plain(b1_p, lv), stream_work(lv, "l1"),
        counter=sk.level1_correction))
    rows["stream_level1"].update(cycle_forms(
        f"stream_level1_correction {n}^2", lv.cycle,
        lambda c: (c.correction(b1_p), 1), (e, 1), reads=0, copies=1, reps=5))
    xb = sk.stream_pass_b(xa_p, b, e_p, lv)
    xb_p = sk.stream_pass_b_plain(xa_p, b, e_p, lv)
    err, worst = max_err([(xb, xb_p)])
    log(f"  stream_pass_b {n}^2: max_abs_err={err:.3e} ({worst:.3f} of its tolerance)")
    same(gates, f"stream_pass_b {n}^2 fused vs staged (x)", (xb,), 1,
         (sk.stream_pass_b_staged(xa_p.clone(), b, e_p, lv, counter=_Tally()),), 1)
    scratch = xa_p.clone()
    rows["stream_pass_b"] = dict(max_abs_err=err, **timed(
        "stream_pass_b", lambda: sk.stream_pass_b(xa_p, b, e_p, lv),
        lambda: sk.stream_pass_b_plain(xa_p, b, e_p, lv), stream_work(lv, "b"),
        counter=sk.stream_pass_b))
    rows["stream_pass_b"].update(pass_turns(
        "stream_pass_b", lambda: sk.stream_pass_b(xa_p, b, e_p, lv),
        lambda c: sk.stream_pass_b_staged(scratch, b, e_p, lv, counter=c)))
    for gate, cycles in (("one forced cycle", 1), ("5-cycle solve", 5)):
        kw = dict(geo, tol=1e-30, max_cycles=cycles, return_count=True)
        out_k, n_k = sk.stream_mg_solve_pressure(p, ff, **kw)
        # the plain cycle on the card: the same loop with the plain versions
        out_p, n_p = plain_streamed_solve(p, ff, geo, cycles)
        err, worst = max_err([(out_k, out_p)])
        if not n_k == n_p == cycles:
            fail(f"streamed solve {gate}: {n_k} cycles, plain {n_p}")
        out_s, n_s = plain_streamed_solve(p, ff, geo, cycles, staged=True)
        same(gates, f"stream_mg_solve_pressure {gate} {n}^2, fused vs staged passes",
             (out_k,), n_k, (out_s,), n_s)
        log(f"  stream_mg_solve_pressure {gate} {n}^2: max_abs_err={err:.3e} "
            f"({worst:.3f} of its tolerance), cycles kernel={n_k} plain={n_p}")
        ms = cuda_ms(lambda: sk.stream_mg_solve_pressure(p, ff, **kw), 2)
        plain_ms = cuda_ms(lambda: plain_streamed_solve(p, ff, geo, cycles), 1)
        work = [stream_work(lv, part) for part in ("a", "l1", "b")]
        b_ms, b_by = bound_ms(sum(w[0] for w in work) * cycles,
                              sum(w[1] for w in work) * cycles)
        log(f"  stream_mg_solve_pressure {gate}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        gates.append(dict(gate=f"stream_mg_solve_pressure {gate}", cycles=n_k,
                          max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by))
    return rows, gates


def pass_turns(name, fused, staged, reps=100):
    """A fused streamed pass against its staged form, in turns (fused,
    staged, staged, fused; CUDA events over `reps` calls each): the fused
    call's ms (mean of its two turns), the staged form's, and the staged
    form's launches per call."""
    from sr_for_cfd_tpu_torch.ops.mg_kernels import _Tally

    tally = _Tally()
    staged(tally)
    t = [cuda_ms(fused, reps), cuda_ms(lambda: staged(tally), reps)]
    t += [cuda_ms(lambda: staged(tally), reps), cuda_ms(fused, reps)]
    per = tally.launches // (2 * reps + 3)
    log(f"  {name} in turns: fused {t[0]:.5f} / {t[3]:.5f} ms (1 launch), staged "
        f"{t[1]:.5f} / {t[2]:.5f} ms ({per} launches)")
    return dict(turns_ms=t, ms=(t[0] + t[3]) / 2, staged_ms=(t[1] + t[2]) / 2,
                staged_launches_per_call=per)


def timed(name, kernel, plain, work, reps=5, counter=None):
    """ms per call of a kernel's wrapper and of its plain version (CUDA
    events), its bound, and the launches of one call."""
    ms = cuda_ms(kernel, reps)
    plain_ms = cuda_ms(plain, 1)
    b_ms, b_by = bound_ms(*work)
    log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                launches_per_call=launches_per_call(kernel, counter))


def same(gates, name, out, n_out, ref, n_ref):
    """Fail unless two forms' outputs are bit-equal with equal counts."""
    import torch

    bit = all(torch.equal(a, b) for a, b in zip(out, ref)) and n_out == n_ref
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    log(f"  {name}: bit-equal {bit} (max_abs_err {err:.3e}, counts {n_out} / {n_ref})")
    if not bit:
        fail(f"{name}: the forms differ")
    gates.append(dict(gate=name, counts=n_out, bit_equal=True, max_abs_err=0.0))


def pass_forms(name, gates, f0, old, ff, nu, k, quick, coef, plain_out, step_prm=None):
    """One fused pass against the staged form (field and rms bit-equal) and
    the plain version (REL_TOL); ms of each alone (CUDA events over 100
    calls): the fused pass's one launch, the staged form's 2k + 1."""
    import torch

    from sr_for_cfd_tpu_torch.ops import mom_pass

    nx2, ny2 = f0.shape
    staged = mom_pass.StagedPass(f0, old, ff, nu, k, quick, mom_pass.Coef(*coef), step_prm)
    ref = f0.clone()
    staged(ref)
    torch.cuda.synchronize()
    err = check_pair(f"{name} fused pass vs plain", ref, k, plain_out, k, quiet=True)
    one = mom_pass.OnePass(nx2, ny2, f0.device, quick=quick, k=k,
                           old_padded=step_prm is not None, coef=mom_pass.Coef(*coef))
    dst = torch.full_like(f0, float("nan"))
    one(f0, dst, old, ff, nu)
    torch.cuda.synchronize()
    same(gates, f"{name} fused pass ({one.plan.n_tiles} blocks, {one.plan.smem} B) vs "
         f"staged, field and rms", (dst, one.rms), k, (ref, staged.rms), k)
    alone = cuda_ms(lambda: one(f0, dst, old, ff, nu), 100)
    work = f0.clone()
    staged_ms = cuda_ms(lambda: staged(work), 100)
    alone2 = cuda_ms(lambda: one(f0, dst, old, ff, nu), 100)
    log(f"  {name}: one pass of {k} sweeps alone: fused {alone:.5f} / {alone2:.5f} ms "
        f"(1 launch), staged form {staged_ms:.5f} ms ({2 * k + 1} launches); fused vs "
        f"plain max_abs_err {err:.3e}")
    return dict(pass_alone_ms=(alone + alone2) / 2, staged_pass_ms=staged_ms, pass_err=err)


def phase_momentum_kernels(device):
    """The fused momentum pass and both device-exit momentum loops.
    Row 4 at 2048^2 (QUICK, k = 3, the old field interior): one pass on each
    tile side bit-equal to the staged form and within REL_TOL of the plain
    version; the wrapper's pass and a 10-pass solve against the plain
    version and bit-equal to the staged (host-exit) loop, also with the
    exit by max_iter at every batch position; a k past the fused pass's
    shared memory (14) on the staged form, against the plain version.
    Row 3 at 402^2 (the north-star fine grid, UPWIND, k = 1, the old field
    padded): one pass likewise; the device-exit loop bit-equal to the
    host-exit loop at every batch position (dt 0.5, where the rms falls
    ~12% a sweep from 9.8e-4, a new best at each) and on the north-star
    settings' own solve. Times: each
    pass alone, the staged pass, the wrapper's one-pass call with its host
    read against the staged wrapper's; a north-star momentum solve in each
    loop, with its launches and host reads."""
    from dataclasses import replace

    import torch

    from sr_for_cfd_tpu_torch.ops import kernel_lib
    from sr_for_cfd_tpu_torch.ops import momentum_kernels as mk
    from sr_for_cfd_tpu_torch.ops import step_kernels as stk
    from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes
    from sr_for_cfd_tpu_torch.solver.cases import make_bfs_solver

    n = BIG_N
    gates, rows = [], {}
    # row 4: smooth seeded fields on the 2048^2 cavity's spacing
    f = smooth_fields(21, n + 2, n + 2, scale=0.3)
    u, v = (torch.tensor(f[c], dtype=torch.float32, device=device) for c in "uv")
    old = u[1:-1, 1:-1] + 0.01 * torch.tensor(smooth_fields(22, n, n)["u"],
                                              dtype=torch.float32, device=device)
    ff = face_fluxes(u, v, 1.0 / n, 1.0 / n)
    mkw = dict(scheme="QUICK", dx=1.0 / n, dy=1.0 / n, dt=1e-3, nu=1e-3,
               volp=1.0 / n**2, check_every=3)
    nu = torch.full((1,), 1e-3, dtype=torch.float32, device=device)
    inv_dx2, inv_dy2, ap_d = mk._coefficients(mkw["dx"], mkw["dy"], mkw["volp"])
    coef = (mkw["volp"], mkw["volp"] / mkw["dt"], inv_dx2, inv_dy2, ap_d)
    one = dict(mkw, tol=0.0, max_iter=3)
    plain, _ = mk.tiled_solve_momentum_plain(u, old, ff, **one)
    row4 = pass_forms(f"tiled_momentum {n}^2 QUICK", gates, u, old, ff, nu, 3, True, coef,
                      plain)
    # (gate, tol, max_iter): one pass exactly; a solve to a tolerance ten
    # passes away (the rms falls ~0.7x per pass here, from 7.1e-7; 2.80e-8
    # after the tenth), far above the float32 floor; that solve cut by
    # max_iter after 1, 2, 5 and 9 passes (every position of a batch of
    # mk.BATCH passes, and a cap that is not a multiple of 3)
    cuts = [("max_iter %d" % m, 3e-8, m) for m in (3, 5, 13, 27)]
    for gate, tol, max_iter in [("pass k=3", 0.0, 3), ("solve", 3e-8, 60)] + cuts:
        kw = dict(mkw, tol=tol, max_iter=max_iter)
        out_k, n_k = mk.tiled_solve_momentum(u, old, ff, slab_rows=256, return_count=True,
                                             **kw)
        out_s, n_s = mk.tiled_solve_momentum(u, old, ff, slab_rows=256, return_count=True,
                                             _staged=True, **kw)
        torch.cuda.synchronize()
        same(gates, f"tiled_momentum {gate}, device-exit vs host-exit loop",
             (out_k,), n_k, (out_s,), n_s)
        if gate.startswith("max_iter"):
            if n_k != -(-max_iter // 3) * 3:
                fail(f"tiled momentum {gate}: {n_k} sweeps")
            continue
        out_p, n_p = mk.tiled_solve_momentum_plain(u, old, ff, **kw)
        err, worst = max_err([(out_k, out_p)])
        if n_k != n_p:
            fail(f"tiled momentum {gate}: {n_k} sweeps, plain {n_p}")
        log(f"  tiled_momentum {gate} {n}^2 QUICK: max_abs_err={err:.3e} "
            f"({worst:.3f} of its tolerance), sweeps kernel={n_k} plain={n_p}")
        t = timed(f"tiled_momentum {gate}",
                  lambda: mk.tiled_solve_momentum(u, old, ff, slab_rows=256, **kw),
                  lambda: mk.tiled_solve_momentum_plain(u, old, ff, **kw),
                  momentum_work(n, n, "QUICK", n_k, n_k // 3), reps=5,
                  counter=mk.tiled_solve_momentum)
        staged_ms = cuda_ms(lambda: mk.tiled_solve_momentum(
            u, old, ff, slab_rows=256, _staged=True, **kw), 5)
        reads = mk.tiled_solve_momentum.reads
        mk.tiled_solve_momentum(u, old, ff, slab_rows=256, **kw)
        reads = mk.tiled_solve_momentum.reads - reads
        log(f"  tiled_momentum {gate}: the staged (host-exit) loop {staged_ms:.4f} ms; "
            f"host reads per call {reads}")
        gates.append(dict(gate=f"tiled_momentum {gate}", sweeps=n_k, max_abs_err=err,
                          staged_ms=staged_ms, reads_per_call=reads, **t))
        if gate == "pass k=3":
            rows["tiled_momentum"] = dict(max_abs_err=err, staged_call_ms=staged_ms,
                                          reads_per_call=reads, **row4, **t)
    del u, v, old, ff
    # a k past the fused pass's shared memory runs on the staged form
    f = smooth_fields(23, 66, 66, scale=0.3)
    us, vs = (torch.tensor(f[c], dtype=torch.float32, device=device) for c in "uv")
    kw = dict(mkw, dx=1 / 64, dy=1 / 64, volp=1 / 64**2, tol=0.0, max_iter=28,
              check_every=14)
    ffs = face_fluxes(us, vs, 1 / 64, 1 / 64)
    launches = mk.tiled_solve_momentum.launches
    out_k, n_k = mk.tiled_solve_momentum(us, us[1:-1, 1:-1], ffs, slab_rows=256,
                                         return_count=True, **kw)
    launches = mk.tiled_solve_momentum.launches - launches
    out_p, n_p = mk.tiled_solve_momentum_plain(us, us[1:-1, 1:-1], ffs, **kw)
    err = check_pair("tiled_momentum k=14 (past the fused budget) 64^2", out_k, n_k,
                     out_p, n_p)
    if launches != 2 * 29:
        fail(f"tiled momentum k=14: {launches} launches, the staged form makes 58")
    gates.append(dict(gate="tiled_momentum k=14 on the staged form", sweeps=n_k,
                      max_abs_err=err))

    # row 3: the north-star fine grid (400^2 BFS, UPWIND, k = 1)
    lib = kernel_lib.load_library()
    ns = dict(nx=400, ny=400, scheme="UPWIND", dtype="float32", fused_step=True,
              pressure_solver="multigrid", steps_per_kernel=10, chunk_size=10)

    def staged_for(solver, **settings):
        c = solver.case
        c = replace(c, settings=replace(c.settings, **settings))
        prm = stk.step_params(c, solver.profile is not None)
        u_in, below = stk._inlet(solver.profile, solver.state.u)
        nu = stk._nu_tensor(solver._nu, solver.state.u).reshape(1).contiguous()
        return stk._Staged(lib, c, prm, u_in, below, nu, solver.state.u), prm, nu

    for dt in (2e-3, 0.5):
        solver = make_bfs_solver(device=device, dt=dt, **ns)
        solver.warm_start(smooth_fields(31, 400, 400))
        s = solver.state
        if dt == 0.5:
            # the loop against the host-exit loop at every batch position
            for m in range(1, 2 * stk.BATCH + 2):
                st, _, _ = staged_for(solver, inner_max_iter=m, inner_tolerance=0.0)
                out_k, n_k = st.momentum(s.u, s.ff)
                out_h, n_h = st.momentum_host_exit(s.u, s.ff)
                same(gates, f"fused-step momentum 402^2 dt 0.5 max_iter {m} (batch "
                     f"position {(m - 1) % stk.BATCH + 1}), device-exit vs host-exit loop",
                     (out_k,), n_k, (out_h,), n_h)
            continue
        st, prm, nu = staged_for(solver)
        one_case = replace(solver.case, settings=replace(
            solver.case.settings, inner_max_iter=1, inner_tolerance=0.0))
        plain, _ = stk._plain_momentum(s.u, s.ff, one_case, nu[0])
        coef3 = (prm.volp, prm.volp_dt, prm.inv_dx2, prm.inv_dy2, prm.ap_d)
        row3 = pass_forms("fused-step momentum 402^2 UPWIND", gates, s.u, s.u, s.ff, nu,
                          1, False, coef3, plain, step_prm=prm)
        out_k, n_k = st.momentum(s.u, s.ff)
        out_h, n_h = st.momentum_host_exit(s.u, s.ff)
        same(gates, f"fused-step momentum 402^2 north-star solve (tol "
             f"{solver.case.settings.inner_tolerance:g}), device-exit vs host-exit loop",
             (out_k,), n_k, (out_h,), n_h)
        counter = stk.simple_step_kernel
        before = (counter.launches, counter.reads)
        st.momentum(s.u, s.ff)
        fused_lr = (counter.launches - before[0], counter.reads - before[1])
        before = (counter.launches, counter.reads)
        st.momentum_host_exit(s.u, s.ff)
        host_lr = (counter.launches - before[0], counter.reads - before[1])
        loop_ms = cuda_ms(lambda: st.momentum(s.u, s.ff), 20)
        host_ms = cuda_ms(lambda: st.momentum_host_exit(s.u, s.ff), 20)
        log(f"  fused-step momentum 402^2 north-star solve: {n_k} sweeps; device-exit "
            f"loop {loop_ms:.4f} ms ({fused_lr[0]} launches, {fused_lr[1]} host reads), "
            f"host-exit loop {host_ms:.4f} ms ({host_lr[0]} launches, {host_lr[1]} reads)")
        rows["fused_step_momentum"] = dict(solve_sweeps=n_k, loop_ms=loop_ms,
                                           host_exit_ms=host_ms,
                                           loop_launches_reads=fused_lr,
                                           host_exit_launches_reads=host_lr, **row3)
    rows["momentum_gates"] = gates
    return rows


def plain_streamed_solve(p, ff, geo, cycles, staged=False):
    """`cycles` streamed V-cycles (no exit check) with the plain versions,
    on p's device: the reference of the streamed solve gates. With
    `staged`, the passes' staged forms and the level-1 correction's graph
    instead (the fused passes' bit-equality reference)."""
    import torch

    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
    from sr_for_cfd_tpu_torch.ops.mg_kernels import _Tally
    from sr_for_cfd_tpu_torch.ops.multigrid import frozen_ghost_rhs

    nx, ny = p.shape[0] - 2, p.shape[1] - 2
    lv = sk.StreamLevels(nx, ny, geo["dx"], geo["dy"], geo["volp"], p.device)
    inv_dx2, inv_dy2 = lv.setup.spacings[0]
    b = frozen_ghost_rhs(p, ff, geo["dt"], geo["rho"], geo["volp"], inv_dx2, inv_dy2)
    x = p[1:-1, 1:-1]
    if staged:
        lv = sk.stream_levels(nx, ny, geo["dx"], geo["dy"], geo["volp"], str(p.device),
                              4, 4, sk.MG_SMOOTHER_SOR, 8, 40)
        x, b = x.contiguous(), b.contiguous()
    for _ in range(cycles):
        if staged:
            x, b1, _ = sk.stream_pass_a_staged(x, b, lv, counter=_Tally())
            x = sk.stream_pass_b_staged(x, b, sk.level1_correction(b1, lv), lv,
                                        counter=_Tally())
            continue
        x, b1, _ = sk.stream_pass_a_plain(x, b, lv)
        x = sk.stream_pass_b_plain(x, b, sk.level1_correction_plain(b1, lv), lv)
    out = p.clone()
    out[1:-1, 1:-1] = x
    if out.is_cuda:
        torch.cuda.synchronize()
    return out, cycles


# the tiled sweep's gates at 2048^2, omega 1.9 (the tiled cavity's
# pressure_sor): on this seeded problem the rms falls below the solve's
# tolerance at sweep 63, while it still falls by percents per sweep, far
# above the float32 floor and before any stall
TILED_SOR = 1.9
TILED_GATE_TOL = 1.5e-4


def fused_sweep(p, b, plan, coef):
    """One launch of the fused tiled kernel (kb = 1, no loop state: the sum
    to a scratch) between two copies of p, alternating; returns the
    callable and the kernel library."""
    import ctypes

    import torch

    from sr_for_cfd_tpu_torch.ops import kernel_lib, shard_rb

    lib = kernel_lib.load_library()
    nx2, ny2 = p.shape
    bufs = [p.clone(), p.clone()]
    scratch = [torch.zeros(plan.n_sum, device=p.device),
               torch.zeros(1, dtype=torch.int32, device=p.device),
               torch.zeros(1, device=p.device)]
    inv_dx2, inv_dy2, volp, sor, ap_d = coef
    prm = shard_rb.make_params(plan, nx2, ny2, nxg=nx2 - 2, h=1, mode=1, inv_dx2=inv_dx2,
                               inv_dy2=inv_dy2, volp=volp, sor=sor, inv_ap=1.0 / ap_d,
                               ap_d=ap_d, partials=scratch[0].data_ptr(),
                               ticket=scratch[1].data_ptr())
    stream = kernel_lib.stream_ptr(p.device)

    def sweep():
        kernel_lib.check(lib.srcfd_shard_rb_fused(
            ctypes.addressof(prm), bufs[0].data_ptr(), bufs[1].data_ptr() + 4 * ny2,
            b.data_ptr(), scratch[2].data_ptr(), 0, stream), "tiled_rb_fused")
        bufs.reverse()

    sweep.keep = (prm, scratch)  # alive as long as the callable
    return sweep, bufs


# the tile sides of the fused kernel at kb = 1 on the 2050^2 grid
TILED_VARIANTS = (("tile 32", 32), ("tile 64", 64))


def phase_tiled_kernels(device):
    """The tiled red-black sweep (row 5) at 2048^2 on a seeded problem. The
    device-exit loop (`tiled_solve_pressure`: the fused kernel, the exit
    state on the card, batches of BATCH launches, one host read per batch)
    against the plain version and the host-exit loop (the one-sweep
    kernel, a finalize and a host read per sweep): one sweep bit-equal to
    both, on either tile side of the fused kernel too; the
    63-sweep solve and a solve the stall policy ends (a 34x30 grid at tol
    0) and max_iter at every position of a batch, bit-equal fields and
    equal counts; row 1's two-launch form on the 63-sweep solve. Ms per
    sweep of the fused kernel alone (each tile side) and of the one-sweep
    kernel alone, of the device-exit loop, of the host-exit loop, of the
    two-launch form and of the plain version; host reads per solve."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops import kernel_lib, shard_rb
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
        _coefficients,
        solve_pressure_kernel,
        solve_pressure_plain,
    )
    from sr_for_cfd_tpu_torch.ops.tiled_kernels import (
        BATCH,
        _tiled_solve_pressure_host_exit,
        tiled_solve_pressure,
    )

    n = BIG_N
    p, ff, geo = seeded_problem(np.random.default_rng(2048), n, n, 1.0, 1.0, device)
    kw = dict(geo, sor=TILED_SOR)
    plain_kw = dict(kw, check_every=1, divide=True)
    coef = _coefficients(geo["dx"], geo["dy"], geo["volp"], TILED_SOR, n, n)
    coef = (coef[0], coef[1], geo["volp"], coef[2], coef[4])
    b = torch.zeros_like(p)
    b[1:-1, 1:-1] = (geo["rho"] / geo["dt"]) * ff.divergence_sum()
    gates = []

    def same(name, out, n_out, ref, n_ref):
        bit = torch.equal(out, ref) and n_out == n_ref
        log(f"  tiled_rb_pressure {name}: bit-equal {bit} (max_abs_err "
            f"{float((out - ref).abs().max()):.3e}, sweeps {n_out} / {n_ref})")
        if not bit:
            fail(f"tiled_rb_pressure {name}: the forms differ")
        gates.append(dict(gate=name, sweeps=n_out, bit_equal=True, max_abs_err=0.0))

    one = dict(tol=0.0, max_iter=1)
    out_k, n_k = tiled_solve_pressure(p, ff, **kw, **one)
    out_p, n_p = solve_pressure_plain(p, ff, **plain_kw, **one)
    out_h, n_h = _tiled_solve_pressure_host_exit(p, ff, **kw, **one)
    torch.cuda.synchronize()
    # limits: REL_TOL x max|p| (no floor of 1: |p| is ~0.1 here)
    sweep_err = check_pair(f"tiled_rb_pressure one sweep {n}^2", out_k, n_k, out_p, n_p,
                           floor=0.0)
    same("one sweep, device-exit loop vs plain", out_k, n_k, out_p, n_p)
    same("one sweep, device-exit loop vs host-exit loop", out_k, n_k, out_h, n_h)
    variants = {}
    for name, ot in TILED_VARIANTS:
        plan = shard_rb.shard_rb_plan(n + 2, n + 2, 1, 1, ot=ot)
        sweep, bufs = fused_sweep(p, b, plan, coef)
        sweep()
        torch.cuda.synchronize()
        same(f"one sweep, fused {name} (grid {plan.n_tiles}, {plan.smem} B) vs plain",
             bufs[0], 1, out_p, 1)
        variants[name] = (plan, sweep)

    solve = dict(tol=TILED_GATE_TOL, max_iter=200)
    out_k, n_k = tiled_solve_pressure(p, ff, **kw, **solve)
    out_p, n_p = solve_pressure_plain(p, ff, **plain_kw, **solve)
    out_h, n_h = _tiled_solve_pressure_host_exit(p, ff, **kw, **solve)
    torch.cuda.synchronize()
    err = check_pair(f"tiled_rb_pressure solve tol {TILED_GATE_TOL:g}", out_k, n_k,
                     out_p, n_p, floor=0.0)
    gates.append(dict(gate=f"solve tol {TILED_GATE_TOL:g}", sweeps=n_k, max_abs_err=err))
    same(f"solve tol {TILED_GATE_TOL:g}, device-exit vs host-exit loop", out_k, n_k,
         out_h, n_h)
    out_2, n_2 = solve_pressure_kernel(p, ff, **plain_kw, **solve)
    torch.cuda.synchronize()
    err2 = check_pair("two-launch form (row 1) against the tiled sweep, same solve",
                      out_2, n_2, out_k, n_k, floor=0.0)
    gates.append(dict(gate="row 1 two-launch form vs tiled, same solve", sweeps=n_2,
                      max_abs_err=err2))
    # the exit by max_iter at every position of a batch (before the
    # tolerance's sweep 63)
    for max_iter in range(6 * BATCH + 1, 7 * BATCH + 1):
        out_k, n_k = tiled_solve_pressure(p, ff, **kw, tol=TILED_GATE_TOL, max_iter=max_iter)
        out_h, n_h = _tiled_solve_pressure_host_exit(p, ff, **kw, tol=TILED_GATE_TOL,
                                                     max_iter=max_iter)
        torch.cuda.synchronize()
        if n_k != max_iter:
            fail(f"tiled_rb_pressure max_iter {max_iter}: {n_k} sweeps")
        same(f"max_iter {max_iter} (batch position {(max_iter - 1) % BATCH + 1}), "
             f"device-exit vs host-exit loop", out_k, n_k, out_h, n_h)
    # a solve that the stall policy ends: tol 0 on a 34x30 grid, whose rms
    # reaches the float32 floor
    ps, ffs, gs = seeded_problem(np.random.default_rng(64), 34, 30, 1.0, 1.0, device)
    out_k, n_k = tiled_solve_pressure(ps, ffs, **gs, sor=TILED_SOR, tol=0.0, max_iter=20000)
    out_h, n_h = _tiled_solve_pressure_host_exit(ps, ffs, **gs, sor=TILED_SOR, tol=0.0,
                                                 max_iter=20000)
    torch.cuda.synchronize()
    if not n_k < 20000:
        fail("tiled_rb_pressure: the stall policy did not end the tol-0 solve")
    same("34x30 solve ended by the stall policy, device-exit vs host-exit loop",
         out_k, n_k, out_h, n_h)

    # times per sweep
    lib = kernel_lib.load_library()
    stream = kernel_lib.stream_ptr(p.device)
    inv_dx2, inv_dy2, volp, sor, ap_d = coef
    bufs = [p.clone(), p.clone()]
    partials = torch.empty(lib.srcfd_shard_rb_partials(n + 2, n + 2), device=p.device)

    def old_sweep():
        kernel_lib.check(lib.srcfd_tiled_rb_sweep(
            bufs[0].data_ptr(), bufs[1].data_ptr(), b.data_ptr(), partials.data_ptr(),
            n + 2, n + 2, inv_dx2, inv_dy2, volp, sor, ap_d, stream), "tiled_rb")
        bufs.reverse()

    default = shard_rb.shard_rb_plan(n + 2, n + 2, 1, 1)
    fused_ms = {}
    old = cuda_ms(old_sweep, 200)
    for name, (plan, sweep) in variants.items():
        fused_ms[name] = cuda_ms(sweep, 200)
    old2 = cuda_ms(old_sweep, 200)
    ms = next(fused_ms[nm] for nm, ot in TILED_VARIANTS if ot == default.ot)
    sweeps = 100
    loop = cuda_ms(lambda: tiled_solve_pressure(p, ff, **kw, tol=0.0, max_iter=sweeps),
                   3) / sweeps
    host_exit = cuda_ms(lambda: _tiled_solve_pressure_host_exit(
        p, ff, **kw, tol=0.0, max_iter=sweeps), 3) / sweeps
    two = cuda_ms(lambda: solve_pressure_kernel(p, ff, **plain_kw, tol=0.0,
                                                max_iter=sweeps), 3) / sweeps
    plain = cuda_ms(lambda: solve_pressure_plain(p, ff, **plain_kw, tol=0.0,
                                                 max_iter=10), 2) / 10
    reads = tiled_solve_pressure.reads
    tiled_solve_pressure(p, ff, **kw, tol=0.0, max_iter=sweeps)
    reads = tiled_solve_pressure.reads - reads
    b_ms, b_by = bound_ms(*tiled_sweep_work(n, n))
    log(f"  tiled_rb_pressure {n}^2, ms per sweep: fused kernel alone "
        + ", ".join(f"{nm} {v:.5f}" for nm, v in fused_ms.items())
        + f" (the loop's plan: tile {default.ot}); the one-sweep "
        f"kernel alone {old:.5f} / {old2:.5f}; device-exit loop {loop:.5f} (batches of "
        f"{BATCH} launches); host-exit loop "
        f"{host_exit:.5f}; plain {plain:.5f}; row 1's two-launch form {two:.5f}; bound "
        f"{b_ms:.6f} ({b_by}); host reads per {sweeps}-sweep solve {reads} (host-exit "
        f"{sweeps})")
    per_call = launches_per_call(
        lambda: tiled_solve_pressure(p, ff, **kw, tol=0.0, max_iter=1), tiled_solve_pressure)
    return dict(max_abs_err=sweep_err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                launches_per_call=per_call, bound_by=b_by,
                plan=dict(ot=default.ot, grid=default.n_tiles),
                fused_ms_by_tile=fused_ms, one_sweep_kernel_ms=(old + old2) / 2,
                loop_ms_per_sweep=loop,
                host_exit_loop_ms_per_sweep=host_exit, two_launch_ms_per_sweep=two,
                host_reads_per_100_sweeps=reads, gates=gates)


def finite_fields(solver):
    import torch

    s = solver.state
    return all(bool(torch.isfinite(t).all().item()) for t in (s.u, s.v, s.p))


def reset_counters():
    from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
    from sr_for_cfd_tpu_torch.ops.extrapolate import rre_extrapolate
    from sr_for_cfd_tpu_torch.ops.mg_kernels import mg_solve_pressure_kernel
    from sr_for_cfd_tpu_torch.ops.momentum_kernels import tiled_solve_momentum
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import solve_pressure_kernel
    from sr_for_cfd_tpu_torch.ops.step_kernels import (
        simple_step_kernel,
        simple_step_small_batched,
    )
    from sr_for_cfd_tpu_torch.ops.tiled_kernels import tiled_solve_pressure
    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import shard_rb_sweep

    for fn in (solve_pressure_kernel, mg_solve_pressure_kernel, simple_step_kernel,
               tiled_solve_momentum, sk.stream_pass_a, sk.level1_correction,
               sk.stream_pass_b, tiled_solve_pressure, shard_rb_sweep):
        fn.launches = 0
    solve_pressure_kernel.routes = dict.fromkeys(solve_pressure_kernel.routes, 0)
    mg_solve_pressure_kernel.replays = sk.level1_correction.replays = 0
    tiled_solve_pressure.reads = tiled_solve_pressure.sweeps = 0
    tiled_solve_momentum.reads = tiled_solve_momentum.sweeps = 0
    simple_step_kernel.reads = simple_step_kernel.calls = 0
    simple_step_small_batched.launches = 0
    rre_extrapolate.attempts = rre_extrapolate.taken = 0


# the JAX demos' bfs_north_star arguments (scripts/run_demos.py:233-263 with
# `fine` :187-192 and BFS_FINE_RRE :208); cut: budgets, RRE cadence and
# chunk, detector cadences (see the module docstring)
NORTH_STAR = dict(
    Re=400, lr_dim=10, hr_dim=400, dt=2e-3, scheme="UPWIND", case="bfs",
    blend_factor=0.3, use_aspect_ratio_correction=False,
    use_adaptive_normalization=False, cauchy_tol=1.2e-2,
    pressure_solver="multigrid", fused_step=True, plateau_patience=5,
    steps_per_kernel=10, rre_depth=6, verbose=False, dtype="float32",
    # cuts: one RRE cycle (7 snapshots, 40 apart) per fine phase
    rre_every=40, rre_min_count=0, chunk_size=280,
    cauchy_check_every=300, plateau_check_every=100,
)
# the demo's coarse overrides (run_demos.py:65-98 updated with :253-254)
NORTH_STAR_COARSE = {
    "pressure_solver": "sweeps", "fused_step": True, "pressure_sor": 1.5,
    "chunk_size": 100000, "inner_max_iter": 64, "rre_every": 0,
    "cauchy_tol": 0.0, "cauchy_check_every": 2000, "convergence_hold": 1,
    "steps_per_kernel": 500,
    # cut: the fine phases' plateau cadence of 100 is not a multiple of 500
    "plateau_check_every": 2000,
}
NON_FUSED = dict(
    Re=400, lr_dim=10, hr_dim=400, dt=2e-3, scheme="UPWIND", case="bfs",
    verbose=False, dtype="float32", use_pallas=True,
    pressure_solver="multigrid", fused_step=False,
)
NON_FUSED_COARSE = {"pressure_solver": "sweeps", "use_pallas": True,
                    "fused_step": False}


def run_path(name, device, budgets, kw, coarse):
    """One hybrid run as a user makes it, launch counters set to 0 just
    before and read just after; fails on non-finite fields or a wrong SR
    shape. Returns (results, launches summed over the phases)."""
    import torch

    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    for path in (MODEL_FILE, STATS_FILE):
        if not os.path.exists(path):
            fail(f"missing {path}")
    reset_counters()
    with tempfile.TemporaryDirectory(prefix="srcfd_") as out_dir:
        res = run_hybrid_experiment(
            max_iterations_coarse=budgets[0], max_iterations_ml=budgets[1],
            max_iterations_normal=budgets[2], model_file=MODEL_FILE,
            stats_file=STATS_FILE, output_dir=out_dir, save_results=False,
            coarse_overrides=coarse, device=device, **kw)
    torch.cuda.synchronize()
    launches = res["kernel_launches"]
    for phase in ("coarse", "ml", "normal"):
        n = res[f"{phase}_iterations"]
        t = res[f"{phase}_time"]
        log(f"  {name} phase {phase}: {n} iterations, {t:.3f} s, "
            f"{1e3 * t / max(n, 1):.3f} ms/iter, launches {launches[phase]}")
    solvers = res["solvers"]
    log(f"  {name}: warm (ML) rms {solvers['ml'].state.rms.tolist()}; cold rms "
        f"{solvers['normal'].state.rms.tolist()}; centerline diff warm vs cold "
        f"{res['centerline_diff']}")
    for phase, s in solvers.items():
        if not finite_fields(s):
            fail(f"{name}: non-finite fields after the {phase} phase")
    if any(res["hr_fields"][c].shape != (400, 400) for c in "uvp"):
        fail(f"{name}: SR output has the wrong shape")
    totals = {k: sum(launches[ph][k] for ph in launches) for k in launches["coarse"]}
    return res, totals


class Row1Counts:
    """Records the sweeps of every SOR solve on the card while it is
    entered (a wrapper around pressure_kernels.card_solve; no launch of
    its own)."""

    def __enter__(self):
        from sr_for_cfd_tpu_torch.ops import pressure_kernels as pk

        self.calls, self.solve = [], pk.card_solve
        calls, solve = self.calls, self.solve

        def counted(*a, **k):
            out = solve(*a, **k)
            calls.append(out[1])
            return out

        pk.card_solve = counted
        return self

    def __exit__(self, *exc):
        from sr_for_cfd_tpu_torch.ops import pressure_kernels as pk

        pk.card_solve = self.solve


def phase_non_fused(device):
    from collections import Counter

    with Row1Counts() as row1:
        res, totals = run_path("non-fused", device, (500, 50, 50), NON_FUSED,
                               NON_FUSED_COARSE)
    launches = res["kernel_launches"]
    coarse = launches["coarse"]
    if coarse["rb_sor_pressure"] <= 0:
        fail("the SOR kernel did not launch in the coarse phase")
    sweeps = row1.calls
    log(f"  non-fused coarse: row 1 calls by route warp {coarse['rb_sor_warp_calls']}, block "
        f"{coarse['rb_sor_block_calls']}, two-launch {coarse['rb_sor_two_launch_calls']}; "
        f"launches {coarse['rb_sor_pressure']}; sweeps per call mean "
        f"{sum(sweeps) / max(1, len(sweeps))} min {min(sweeps, default=0)} max "
        f"{max(sweeps, default=0)}: {dict(sorted(Counter(sweeps).items()))}")
    if not (coarse["rb_sor_warp_calls"] == coarse["rb_sor_pressure"] == len(sweeps)
            == totals["rb_sor_pressure"]):
        fail("a row 1 call of the non-fused path did not take the one-warp route")
    if launches["ml"]["mg_vcycle_pressure"] <= 0 or \
            launches["normal"]["mg_vcycle_pressure"] <= 0:
        fail("the V-cycle kernel did not launch in a fine phase")
    return dict(totals, rb_sor_sweeps=sum(sweeps), rb_sor_sweeps_min=min(sweeps),
                rb_sor_sweeps_max=max(sweeps))


class SolveCounts:
    """Records the sweeps of every device-exit momentum solve while it is
    entered (a wrapper around MomentumLoop.solve; no launch of its own)."""

    def __enter__(self):
        from sr_for_cfd_tpu_torch.ops import mom_pass

        self.counts, self.solve = [], mom_pass.MomentumLoop.solve
        counts, solve = self.counts, self.solve

        def counted(loop, *a, **k):
            out = solve(loop, *a, **k)
            counts.append(out[1])
            return out

        mom_pass.MomentumLoop.solve = counted
        return self

    def __exit__(self, *exc):
        from sr_for_cfd_tpu_torch.ops import mom_pass

        mom_pass.MomentumLoop.solve = self.solve

    def histogram(self):
        from collections import Counter

        return dict(sorted(Counter(self.counts).items()))


def phase_north_star(device):
    with SolveCounts() as solves:
        res, totals = run_path("north star", device, (2000, 300, 300), NORTH_STAR,
                               NORTH_STAR_COARSE)
    log(f"  north star: momentum sweeps per device-exit solve (fine phases) "
        f"{solves.histogram()}")
    launches = res["kernel_launches"]
    for phase in ("coarse", "ml", "normal"):
        if launches[phase]["fused_step"] <= 0:
            fail(f"the fused-step kernel did not launch in the {phase} phase")
    for phase in ("ml", "normal"):
        if launches[phase]["mg_vcycle_pressure"] <= 0:
            fail(f"the V-cycle kernel did not launch in the {phase} phase")
        if launches[phase]["rre_attempts"] <= 0:
            fail(f"no RRE jump was attempted in the {phase} phase")
        n = max(1, res[f"{phase}_iterations"])
        c = launches[phase]
        log(f"  north star {phase} phase, per fine step: {c['fused_step'] / n:.2f} design "
            f"(b) launches, {c['fused_step_reads'] / n:.2f} momentum host reads, "
            f"{c['mg_vcycle_replays'] / n:.2f} V-cycle replays")
    return totals


# the data-generation sweep and the SR training pipeline (sweep.py and
# training.py's defaults): the double-lid cavity over Re 100..800, QUICK,
# dt 1e-3, float32, at the 10 -> 400 autoencoder's widths; cuts: the 400^2
# solves to SWEEP_HR_STEPS steps, the training to TRAIN_EPOCHS epochs
SWEEP_RE = tuple(range(100, 801, 100))
SWEEP = dict(dt=1e-3, scheme="QUICK", double_lid=True, dtype="float32")
SWEEP_MAX_ITER = 100000  # sweep.py's default budget
SWEEP_CHUNK = 1000  # sweep.py's default chunk
SWEEP_K = 500  # the auto-K rule's choice for this chunk and budget
SWEEP_LR, SWEEP_MID, SWEEP_HR = 10, 50, 400  # the sweep's mesh sizes
SWEEP_HR_STEPS = 300  # cut: a 400^2 cavity needs far more to converge
TRAIN_EPOCHS = 50  # cut: the reference trains 500
TRAIN_LOG_EVERY = 10
SWEEP_BC = "double_lid(u_top=1,u_bottom=1)"
PLAIN_K = 4  # steps of the batched launch's gate against the plain version
# the launch counters the sweep's report keeps
SWEEP_COUNTERS = ("fused_step_batched", "fused_step", "fused_step_calls", "fused_step_reads",
                  "mg_vcycle_pressure", "mg_vcycle_replays")


def case_batch(device, n_side, k, seed=None, **extra):
    """The sweep's stacked state at n_side^2 for SWEEP_RE, K steps a launch:
    (first case's solver, u, v, p, ff, nu), each case from the cold start
    or, with a seed, from its own smooth seeded field."""
    import torch

    from sr_for_cfd_tpu_torch.ops.stencil import FaceFluxes
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    solvers = []
    for i, re in enumerate(SWEEP_RE):
        s = make_cavity_solver(Re=float(re), nx=n_side, ny=n_side, fused_step=True,
                               steps_per_kernel=k, chunk_size=k, device=device,
                               **SWEEP, **extra)
        if seed is not None:
            s.warm_start(smooth_fields(seed + i, n_side, n_side))
        solvers.append(s)
    st = [s.state for s in solvers]
    u, v, p = (torch.stack([getattr(x, c) for x in st]).contiguous() for c in "uvp")
    ff = FaceFluxes(*(torch.stack([x.ff[i] for x in st]).contiguous() for i in range(4)))
    nu = torch.tensor([1.0 / re for re in SWEEP_RE], dtype=torch.float32, device=device)
    return solvers[0], u, v, p, ff, nu


def one_case(t, b):
    """Case b of a stacked (u, v, p, ff) tuple."""
    from sr_for_cfd_tpu_torch.ops.stencil import FaceFluxes

    return t[0][b], t[1][b], t[2][b], FaceFluxes(*(f[b] for f in t[3]))


def batched_work(case, counts, listed, device):
    """(bytes, flops) of a batched launch: the single launch's fused_work
    for each listed case with its own inner counts."""
    nb = fl = 0
    for b in listed:
        w = fused_work(case, [int(x) for x in counts[b].tolist()], device)
        nb, fl = nb + w[0], fl + w[1]
    return nb, fl


def phase_sweep_kernels(device):
    """Row 3's batched launch (design (a) over a case axis): at 10^2 and
    50^2, 8 cases from their own seeded fields, K = 500, the sweep's
    settings, case 5 masked out: each listed case's fields, fluxes, res and
    counts bit-equal to its single design (a) launch, the masked case's
    inputs unchanged; then within REL_TOL of the plain version with equal
    counts (K = PLAIN_K, inner tolerance 1e-3: a tolerance the loops reach
    before the float32 floor, so that the counts can be equal), the
    batched launch and the plain version timed there on the same inputs."""
    import torch

    from sr_for_cfd_tpu_torch.ops.step_kernels import (
        simple_step_kernel,
        simple_step_plain,
        simple_step_small_batched,
    )

    masked = 5
    listed = [b for b in range(len(SWEEP_RE)) if b != masked]
    gates, row = [], {}
    for n_side in (SWEEP_LR, SWEEP_MID):
        s0, *t = case_batch(device, n_side, SWEEP_K, seed=100 * n_side)
        case, prof, nu = s0.case, s0.profile, t[4]
        out = simple_step_small_batched(*t[:4], case, prof, nu, listed)
        torch.cuda.synchronize()
        for b in listed:
            one = simple_step_kernel(*one_case(t, b), case, prof, nu=nu[b], _design="a")
            got = (*one_case(out, b)[:3], *one_case(out, b)[3], out[4][b])
            same(gates, f"batched {n_side}^2 K={SWEEP_K} case {b} (Re {SWEEP_RE[b]}) vs its "
                 "single launch", got, out[5][b].tolist(), (*one[:3], *one[3], one[4]), one[5])
        unchanged = all(torch.equal(a[masked], b[masked])
                        for a, b in zip((*out[:3], *out[3]), (*t[:3], *t[3])))
        log(f"  batched {n_side}^2: masked case {masked} unchanged {unchanged}, its res "
            f"{out[4][masked].tolist()} counts {out[5][masked].tolist()}")
        if not unchanged or out[4][masked].any() or out[5][masked].any():
            fail(f"batched {n_side}^2: the masked case was touched")
        # the plain version, on the same inputs at K = PLAIN_K
        s0, *t = case_batch(device, n_side, PLAIN_K, seed=100 * n_side, inner_tolerance=1e-3)
        case, prof, nu = s0.case, s0.profile, t[4]

        def kernel():
            return simple_step_small_batched(*t[:4], case, prof, nu, listed)

        out = kernel()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = {b: simple_step_plain(*one_case(t, b), case, prof, nu=nu[b]) for b in listed}
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        err = max(check_pair(f"batched {n_side}^2 K={PLAIN_K} case {b}", a, out[5][b].tolist(), r,
                             ref[b][5], quiet=True)
                  for b in listed
                  for a, r in zip((*one_case(out, b)[:3], *one_case(out, b)[3]),
                                  (*ref[b][:3], *ref[b][3])))
        ms = cuda_ms(kernel, 5)
        per_call = launches_per_call(kernel, simple_step_small_batched)
        if per_call < 1:
            fail(f"batched {n_side}^2: the gate's call counted {per_call} launches")
        b_ms, b_by = bound_ms(*batched_work(case, out[5], listed, device))
        log(f"  batched {n_side}^2 K={PLAIN_K}, {len(listed)} cases: max_abs_err {err:.3e} against the "
            f"plain version (equal counts), kernel {ms:.4f} ms ({per_call} launch a call), plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.3e} ms ({b_by})")
        gates.append(dict(gate=f"batched {n_side}^2 K={PLAIN_K} vs plain", max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          launches_per_call=per_call))
        if n_side == SWEEP_LR:
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       launches_per_call=per_call, cases_per_launch=len(listed),
                       steps_per_launch=PLAIN_K)
    row["gates"] = gates
    return row


def batched_turns(device, fields, n_side, reps=3):
    """One batched launch of all 8 cases (K = 500) against one single launch
    of case 0, from the sweep's final fields, in turns (batched, single,
    single, batched; CUDA events); returns (batched ms, single ms, bound ms
    of the batched launch, its bound)."""
    import torch

    from sr_for_cfd_tpu_torch.ops.step_kernels import (
        simple_step_kernel,
        simple_step_small_batched,
    )

    s0, *t = case_batch(device, n_side, SWEEP_K)
    for b, re in enumerate(SWEEP_RE):  # the final fields as a warm start
        s0.warm_start(fields[float(re)])
        for dst, src in zip((*t[:3], *t[3]), (s0.state.u, s0.state.v, s0.state.p,
                                               *s0.state.ff)):
            dst[b].copy_(src)
    case, prof, nu = s0.case, s0.profile, t[4]
    every = range(len(SWEEP_RE))

    def batched():
        return simple_step_small_batched(*t[:4], case, prof, nu, every)

    def single():
        return simple_step_kernel(*one_case(t, 0), case, prof, nu=nu[0], _design="a")

    counts = batched()[5]
    times = [cuda_ms(fn, reps) for fn in (batched, single, single, batched)]
    b_ms, b_by = bound_ms(*batched_work(case, counts, every, device))
    torch.cuda.synchronize()
    return (times[0] + times[3]) / 2, (times[1] + times[2]) / 2, b_ms, b_by, times


def pair_in_memory(lr_fields, hr_fields, lr_dim, hr_dim, bc_type):
    """The sweep's fields paired as io/hdf5.load_paired_reynolds_multi pairs
    a file's groups: Re sorted, then u, v, p; (x_lr, x_hr, res, comps,
    bcs)."""
    import numpy as np

    xs_lr, xs_hr, res, comps, bcs = [], [], [], [], []
    for re in sorted(set(lr_fields) & set(hr_fields)):
        for c in "uvp":
            xs_lr.append(lr_fields[re][c].astype(np.float32).reshape(lr_dim, lr_dim))
            xs_hr.append(hr_fields[re][c].astype(np.float32).reshape(hr_dim, hr_dim))
            res.append(re)
            comps.append(c)
            bcs.append(bc_type)
    return (np.asarray(xs_lr, dtype=np.float32)[..., None],
            np.asarray(xs_hr, dtype=np.float32)[..., None],
            np.asarray(res), np.asarray(comps), np.asarray(bcs))


def training_step_gate(device, module, x_lr, x_hr):
    """One training step on the card against the CPU from the same weights,
    Adam state and batch, TF32 off: the loss within 1e-4 relative, the
    weights after the step within 1e-5 of the largest |weight|. The Adam
    moments come from 3 steps first (from fresh moments Adam's first
    update is nearly lr * sign(g), which a rounding can flip). Then the
    same step twice on the card from the same state: bit-equal or not
    (cuDNN's algorithm choice), printed."""
    import copy

    import torch

    from sr_for_cfd_tpu_torch.sr.inference import _no_tf32
    from sr_for_cfd_tpu_torch.workflow import training as tr

    module = copy.deepcopy(module)
    opt = tr.Adam(list(module.parameters()))
    xb, yb = (torch.as_tensor(a[:8], device=device) for a in (x_lr, x_hr))
    with _no_tf32():
        for _ in range(3):
            tr.train_step(module, opt, xb, yb)

        def step(on):
            m = copy.deepcopy(module).to(on)
            o = opt.to(on)
            loss = tr.train_step(m, o, xb.to(on), yb.to(on))
            return float(loss), [p.detach() for p in m.parameters()]

        loss_c, p_c = step("cpu")
        loss_g, p_g = step(device)
        loss_g2, p_g2 = step(device)
    torch.cuda.synchronize()
    scale = max(float(p.abs().max()) for p in p_c)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(p_g, p_c))
    rel = abs(loss_g - loss_c) / abs(loss_c)
    repeat = loss_g == loss_g2 and all(torch.equal(a, b) for a, b in zip(p_g, p_g2))
    log(f"  training step card vs CPU: loss {loss_g:.8f} / {loss_c:.8f} (rel {rel:.2e}, "
        f"limit 1e-4); weights max_abs_err {err:.3e} (limit 1e-5 x {scale:.4f}); the same "
        f"step twice on the card bit-equal: {repeat}")
    if not (rel <= 1e-4 and err <= 1e-5 * scale):
        fail("the training step on the card disagrees with the CPU")
    return dict(gate="training step card vs CPU", loss_rel_err=rel, max_abs_err=err,
                weight_scale=scale, card_repeat_bit_equal=repeat)


def phase_sweep_train(device):
    """The data-generation sweep and the SR training at full width, launch
    counters set to 0 just before and read just after: batched_cavity_solve
    at 10^2 and 50^2 (the batched route, to the budget), at 400^2 in the
    multigrid mode (design (b), a loop over the cases; cut), the 10^2 and
    400^2 fields paired in memory (the card has no h5py), the Re 800 hold
    out, standardization, train_sr_autoencoder at the reference's widths
    (cut), evaluate_for_re, export_models and a reload."""
    import contextlib
    import io

    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.models.autoencoder import param_count
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver
    from sr_for_cfd_tpu_torch.sr.inference import SRModel
    from sr_for_cfd_tpu_torch.workflow import sweep as sw
    from sr_for_cfd_tpu_torch.workflow import training as tr
    from sr_for_cfd_tpu_torch.workflow.hybrid import kernel_launch_counts

    t_phase = time.perf_counter()
    reset_counters()
    sw.batched_cavity_solve.reads = 0
    fields, report = {}, {}
    for n_side, kw in ((SWEEP_LR, {}), (SWEEP_MID, {}),
                       (SWEEP_HR, dict(pressure_solver="multigrid",
                                       max_iterations=SWEEP_HR_STEPS))):
        kw = dict(dict(max_iterations=SWEEP_MAX_ITER), **kw)
        before, reads = kernel_launch_counts(), sw.batched_cavity_solve.reads
        printed = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            fields[n_side], iters = sw.batched_cavity_solve(
                SWEEP_RE, n_side, n_side, fused_step=True, chunk_size=SWEEP_CHUNK,
                device=device, **SWEEP, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        lines = printed.getvalue().splitlines()
        after = kernel_launch_counts()
        d = {k: after[k] - before[k] for k in after}
        reads = sw.batched_cavity_solve.reads - reads
        steps = int(iters.max())
        log(f"  sweep {n_side}^2: {lines[0] if lines[0].startswith('[sweep]') else 'no notice'}; "
            f"last line: {lines[-1].strip()}")
        log(f"  sweep {n_side}^2: iterations per case {iters.tolist()}; {secs:.3f} s, "
            f"{1e3 * secs / steps:.4f} ms per step of all {len(SWEEP_RE)} cases; batched "
            f"launches {d['fused_step_batched']}, host reads {reads}, design (b) launches "
            f"{d['fused_step'] - d['fused_step_batched']}, V-cycle replays "
            f"{d['mg_vcycle_replays']}")
        if len(fields[n_side]) != len(SWEEP_RE):
            fail(f"sweep {n_side}^2: a case diverged")
        for f in fields[n_side].values():
            if any(not np.isfinite(f[c]).all() or f[c].shape != (n_side, n_side) for c in "uvp"):
                fail(f"sweep {n_side}^2: non-finite fields or a wrong shape")
        report[n_side] = dict(iterations=iters.tolist(), seconds=secs,
                              ms_per_step=1e3 * secs / steps, host_reads=reads,
                              launches={k: d[k] for k in SWEEP_COUNTERS})
        if n_side < SWEEP_HR:
            expect = -(-steps // SWEEP_K)
            if not (d["fused_step_batched"] == expect == reads and d["fused_step_calls"]
                    == expect and d["mg_vcycle_pressure"] == 0):
                fail(f"sweep {n_side}^2: {d['fused_step_batched']} batched launches and "
                     f"{reads} host reads, expected {expect} each and no other step launch")
        elif d["fused_step_batched"] or d["fused_step"] <= 0 or d["mg_vcycle_pressure"] <= 0:
            fail(f"sweep {SWEEP_HR}^2: the multigrid mode did not run on design (b) and the "
                 "V-cycle")
    log(f"  sweep cut: {SWEEP_HR}^2 solves to {SWEEP_HR_STEPS} steps (a 400^2 cavity needs far "
        f"more to converge)")

    # training at the reference's widths on the 10^2 -> 400^2 pairs
    x_lr, x_hr, res, comps, bcs = pair_in_memory(
        fields[SWEEP_LR], fields[SWEEP_HR], SWEEP_LR, SWEEP_HR, SWEEP_BC)
    train, test = tr.split_by_reynolds_config(res, bcs)
    z_lr, z_hr, stats = tr.standardize_train_test(x_lr, x_hr, comps, train, SWEEP_LR, SWEEP_HR)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = tr.train_sr_autoencoder(
            z_lr[train], z_hr[train], SWEEP_LR, SWEEP_HR, epochs=TRAIN_EPOCHS, batch_size=8,
            log_every=TRAIN_LOG_EVERY, seed=0, device=device)
    hist = result.loss_history
    n_train = int(train.sum())
    steps = max(1, n_train // 8)
    log(f"  train {SWEEP_LR}->{SWEEP_HR} ({param_count(result.model)} weights, latent 50, batch 8, Adam 1e-3; "
        f"cut to {TRAIN_EPOCHS} epochs, the reference 500): {n_train} samples, {steps} steps "
        f"an epoch, {result.seconds:.3f} s, {result.seconds / TRAIN_EPOCHS:.4f} s per epoch, "
        f"{TRAIN_EPOCHS * steps * 8 / result.seconds:.1f} samples/s; loss {hist[0]:.6f} -> "
        f"{hist[-1]:.6f}, best epoch {result.best_epoch} ({result.best_loss:.6f}); "
        f"{len(printed.getvalue().splitlines())} log lines")
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        fail("training: the loss did not fall")
    ev = tr.evaluate_for_re(800, result.model, None, z_lr[test], z_hr[test], res[test],
                            comps[test], stats, SWEEP_LR, SWEEP_HR, verbose=False)
    log("  evaluate Re 800 (a cut run's numbers, not a quality claim): " + ", ".join(
        f"{r['component']} MAE {r['mae']:.5f} NMAE {r['nmae_pct']:.3f}%"
        for r in ev["per_sample"]))
    with tempfile.TemporaryDirectory(prefix="srcfd_export_") as out_dir:
        with contextlib.redirect_stdout(io.StringIO()):
            paths = tr.export_models(result, stats, SWEEP_LR, SWEEP_HR, "smoke",
                                     out_dir=out_dir)
        model = SRModel.from_checkpoint(paths["combined"], SWEEP_LR, SWEEP_HR, device=device)
    x = torch.as_tensor(z_lr[test], device=device)
    # cuDNN may pick algorithms whose sums run in another order from call
    # to call (the transposed convolutions' backward-data kernels): the
    # reload is compared with deterministic algorithms, and how far two
    # calls of the default mode differ is printed
    weights_equal = all(torch.equal(a, b) for a, b in zip(model.params.values(),
                                                          result.params.values()))
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        reload_equal = torch.equal(model.predict(x), SRModel(
            SWEEP_LR, SWEEP_HR, result.model).predict(x))
    finally:
        cudnn.deterministic = saved
    a, b = model.predict(x), model.predict(x)
    log(f"  export: {sorted(paths)}; the reloaded weights bit-equal {weights_equal}, its "
        f"prediction bit-equal to the trained module's (deterministic cuDNN): {reload_equal}; "
        f"two predictions in the default mode bit-equal: {torch.equal(a, b)} (max_abs_err "
        f"{float((a - b).abs().max()):.3e})")
    if not (weights_equal and reload_equal):
        fail("export: the reloaded model differs")
    torch.cuda.synchronize()
    launches = kernel_launch_counts()
    log(f"  sweep and train main path: {time.perf_counter() - t_phase:.1f} s")

    # outside the counted path: the final state's launch timing, a solo
    # solve and the training-step gate
    for n_side in (SWEEP_LR, SWEEP_MID):
        ms, single_ms, b_ms, b_by, times = batched_turns(device, fields[n_side], n_side)
        log(f"  batched launch {n_side}^2, 8 cases, K={SWEEP_K}, from the sweep's final fields: "
            f"{ms:.3f} ms against one single-case launch {single_ms:.3f} ms (in turns: "
            f"{', '.join(f'{t:.3f}' for t in times)}); bound {b_ms:.4f} ms ({b_by})")
        report[n_side].update(batched_ms=ms, single_ms=single_ms, batched_bound_ms=b_ms,
                              batched_bound_by=b_by)
    solo = make_cavity_solver(Re=400.0, nx=SWEEP_LR, ny=SWEEP_LR, fused_step=True, steps_per_kernel=SWEEP_K,
                              max_iterations=SWEEP_MAX_ITER, chunk_size=SWEEP_CHUNK,
                              device=device,
                              **SWEEP)
    solo.solve(verbose=False, save_results=False)
    solo_equal = all(np.array_equal(solo.interior_fields()[c], fields[SWEEP_LR][400.0][c])
                     for c in "uvp")
    log(f"  sweep {SWEEP_LR}^2 Re 400 bit-equal to a solo make_cavity_solver solve ({solo.state.count} "
        f"steps, K={SWEEP_K}): {solo_equal}")
    if not solo_equal:
        fail(f"sweep {SWEEP_LR}^2: a case differs from its solo solve")
    step_gate = training_step_gate(device, result.model, z_lr[train], z_hr[train])
    return launches, dict(report=report, train=dict(
        epochs=TRAIN_EPOCHS, seconds=result.seconds, first_loss=hist[0], last_loss=hist[-1],
        best_epoch=result.best_epoch, weights=param_count(result.model), evaluate=ev),
        gates=[step_gate, dict(gate=f"sweep {SWEEP_LR}^2 vs solo solve", bit_equal=True),
               dict(gate="export reload", bit_equal=True)])


# scripts/scaling_bench.py's mg_pallas case at its 2048^2 grid
# (:16, :25-30, :41-45), which the big-grid threshold routes to the tiled
# momentum kernel and the streamed V-cycle: BIG_GRID_STEPS outer steps from
# the cold start, as the bench runs them
BIG_GRID = dict(Re=1000.0, nx=BIG_N, ny=BIG_N, dt=1e-3, scheme="QUICK",
                dtype="float32", use_pallas=True, pressure_solver="multigrid")
BIG_GRID_STEPS = 200
BIG_GRID_KERNELS = ("tiled_momentum", "stream_pass_a", "stream_level1",
                    "stream_pass_b")


def phase_big_grid(device):
    """The 2048^2 cavity through make_cavity_solver(...).solve, launch
    counters set to 0 just before and read just after; each step's inner
    counts are recorded on the way (simple_step with_counts)."""
    import torch

    from sr_for_cfd_tpu_torch.config import big_grid_kernels
    from sr_for_cfd_tpu_torch.solver import simple as tsimple
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver
    from sr_for_cfd_tpu_torch.workflow.hybrid import kernel_launch_counts

    solver = make_cavity_solver(device=device, max_iterations=BIG_GRID_STEPS,
                                chunk_size=BIG_GRID_STEPS, **BIG_GRID)
    if not big_grid_kernels(solver.settings, solver.mesh):
        fail("the 2048^2 cavity is not routed to the big-grid kernels")
    solver.precompile()
    step, counts = tsimple.simple_step, []

    def counted_step(*a, **k):
        state, c = step(*a, with_counts=True, **k)
        counts.append(c)
        return state

    tsimple.simple_step = counted_step
    try:
        with SolveCounts() as solves:
            reset_counters()
            iters, elapsed = solver.solve(verbose=False, save_results=False)
            torch.cuda.synchronize()
            launches = kernel_launch_counts()
    finally:
        tsimple.simple_step = step
    log(f"  big-grid cavity: momentum sweeps per device-exit solve {solves.histogram()}")
    if iters != BIG_GRID_STEPS or len(counts) != iters:
        fail(f"big-grid cavity ran {iters} steps, expected {BIG_GRID_STEPS}")
    if not finite_fields(solver):
        fail("big-grid cavity: non-finite fields")
    for name in BIG_GRID_KERNELS:
        if launches[name] <= 0:
            fail(f"the {name} kernel did not launch on the big-grid path")
    mean = {c: sum(x[c] for x in counts) / iters for c in "uvp"}
    cycles = sum(x["p"] for x in counts)
    if launches["stream_pass_a"] != cycles or launches["stream_pass_b"] != cycles:
        fail(f"big-grid cavity: passes A and B launched {launches['stream_pass_a']} and "
             f"{launches['stream_pass_b']} kernels in {cycles} V-cycles, not one each")
    log(f"  big-grid cavity: {cycles} V-cycles; launches per step: pass A "
        f"{launches['stream_pass_a'] / iters:.2f}, pass B "
        f"{launches['stream_pass_b'] / iters:.2f} (one each per V-cycle)")
    if any(x["u"] % 3 or x["v"] % 3 for x in counts):
        fail("big-grid cavity: momentum sweeps are not multiples of 3")
    log(f"  big-grid cavity {BIG_N}^2 Re=1000 QUICK: {iters} steps in {elapsed:.3f} s, "
        f"{1e3 * elapsed / iters:.3f} ms/iter; mean per step: u sweeps {mean['u']:.2f}, "
        f"v sweeps {mean['v']:.2f}, p cycles {mean['p']:.2f}; launches per step "
        f"{ {k: round(launches[k] / iters, 2) for k in BIG_GRID_KERNELS} }; momentum "
        f"host reads per step {launches['tiled_momentum_reads'] / iters:.2f}; "
        f"rms {solver.state.rms.tolist()}")
    return {k: v for k, v in launches.items() if not k.startswith("rre")}


# scripts/scaling_bench.py's tiled case at its 2048^2 grid (:25-31, :50-52):
# the pressure on the tiled sweep kernel, the momentum on the plain sweeps;
# TILED_STEPS outer steps from the cold start in one chunk, as the bench runs
# them
TILED = dict(Re=1000, nx=BIG_N, ny=BIG_N, dt=1e-3, scheme="QUICK", dtype="float32",
             pressure_solver="tiled", pressure_sor=TILED_SOR)
TILED_STEPS = 200


def phase_tiled(device):
    """The 2048^2 tiled cavity through create_lid_driven_cavity, after the
    library is loaded by a solver's precompile(); launch counters set to 0
    just before and read just after, each step's inner counts recorded on
    the way (simple_step with_counts)."""
    import torch

    from sr_for_cfd_tpu_torch import create_lid_driven_cavity
    from sr_for_cfd_tpu_torch.solver import simple as tsimple
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver
    from sr_for_cfd_tpu_torch.workflow.hybrid import kernel_launch_counts

    make_cavity_solver(device=device, **TILED).precompile()
    step, counts = tsimple.simple_step, []

    def counted_step(*a, **k):
        state, c = step(*a, with_counts=True, **k)
        counts.append(c)
        return state

    tsimple.simple_step = counted_step
    try:
        reset_counters()
        solver, iters, elapsed = create_lid_driven_cavity(
            **TILED, max_iterations=TILED_STEPS, chunk_size=TILED_STEPS,
            save_results=False, verbose=False, device=device)
        torch.cuda.synchronize()
        launches = kernel_launch_counts()
    finally:
        tsimple.simple_step = step
    if iters != TILED_STEPS or len(counts) != iters:
        fail(f"tiled cavity ran {iters} steps, expected {TILED_STEPS}")
    if not finite_fields(solver):
        fail("tiled cavity: non-finite fields")
    if launches["tiled_rb_pressure"] <= 0:
        fail("the tiled sweep kernel did not launch on the tiled path")
    if launches["rb_sor_pressure"] != 0:
        fail("the tiled path launched the SOR kernel (row 1)")
    mean = {c: sum(x[c] for x in counts) / iters for c in "uvp"}
    per_step = {k: round(v / iters, 2) for k, v in launches.items()
                if v and not k.startswith("rre")}
    # where the step's time goes: the plain momentum sweeps, timed on a u
    # solve from the final state (the pressure's share follows from the
    # sweep counts and the row 5 gate's ms per sweep in the loop)
    s, mom = solver.state, tsimple._momentum_solver(solver.case)
    n_mom = mom(s.u, s.u_old, s.ff, solver._nu)[1]
    mom_ms = cuda_ms(lambda: mom(s.u, s.u_old, s.ff, solver._nu), 3, warm=False)
    log(f"  tiled cavity: one plain u momentum solve from the final state, "
        f"{n_mom} sweeps: {mom_ms:.3f} ms ({mom_ms / max(n_mom, 1):.3f} per sweep)")
    log(f"  tiled cavity {BIG_N}^2 Re=1000 QUICK omega {TILED_SOR}: {iters} steps in "
        f"{elapsed:.3f} s, {1e3 * elapsed / iters:.3f} ms/iter; mean per step: pressure "
        f"sweeps {mean['p']:.2f} (min {min(x['p'] for x in counts)}, max "
        f"{max(x['p'] for x in counts)}), u sweeps {mean['u']:.2f}, v sweeps "
        f"{mean['v']:.2f}; launches per step {per_step}; rms {solver.state.rms.tolist()}")
    return {k: v for k, v in launches.items() if not k.startswith("rre")}


def small_reference(name, device, kw, coarse):
    """A hybrid configuration at a small size on the card (kernels) and on
    the CPU (plain PyTorch): equal iteration counts, fields within 1e-4 of
    the largest |value|."""
    import numpy as np

    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    kw = dict(kw, lr_dim=10, hr_dim=32, save_results=False)
    gpu = run_hybrid_experiment(device=device, coarse_overrides=coarse, **kw)
    cpu = run_hybrid_experiment(device="cpu", coarse_overrides=coarse, **kw)
    worst = {}
    for phase in ("coarse", "ml", "normal"):
        if gpu[f"{phase}_iterations"] != cpu[f"{phase}_iterations"]:
            fail(f"{name} reference: {phase} iteration counts differ")
        a = gpu["solvers"][phase].interior_fields()
        b = cpu["solvers"][phase].interior_fields()
        worst[phase] = 0.0
        for c in "uvp":
            err = float(np.max(np.abs(a[c] - b[c])))
            scale = max(1.0, float(np.max(np.abs(b[c]))))
            worst[phase] = max(worst[phase], err / scale)
            if not (np.all(np.isfinite(a[c])) and err <= 1e-4 * scale):
                fail(f"{name} reference: {phase} {c} differs by {err:.3e}")
    log(f"  {name} small hybrid card vs CPU: iterations "
        f"{[gpu[f'{ph}_iterations'] for ph in ('coarse', 'ml', 'normal')]}, "
        f"worst relative field difference per phase (limit 1e-4) "
        f"{ {ph: f'{w:.3e}' for ph, w in worst.items()} }")


def phase_reference(device):
    from sr_for_cfd_tpu_torch.ops.step_kernels import simple_step_kernel

    budgets = dict(max_iterations_coarse=100, max_iterations_ml=20,
                   max_iterations_normal=20)
    non_fused = {k: v for k, v in NON_FUSED.items() if k not in ("lr_dim", "hr_dim")}
    small_reference("non-fused", device, dict(non_fused, **budgets),
                    NON_FUSED_COARSE)
    fused = {k: v for k, v in NORTH_STAR.items() if k not in ("lr_dim", "hr_dim")}
    fused.update(max_iterations_coarse=1000, max_iterations_ml=100,
                 max_iterations_normal=100, rre_every=10, chunk_size=70,
                 plateau_check_every=50, cauchy_check_every=100)
    simple_step_kernel.force_design = "b"
    try:
        small_reference("fused, design (b)", device, fused, NORTH_STAR_COARSE)
    finally:
        simple_step_kernel.force_design = None
    big_grid_reference(device)
    tiled_reference(device)


def tiled_reference(device):
    """The 48^2 tiled cavity (QUICK, Re=1000, dt=1e-3, float32, 60 steps,
    the 2048^2 case's settings at a small size) on
    the card (the tiled sweep kernel) and on the CPU (its plain version):
    equal counts in the first 3 steps and over the solve, fields within
    1e-4 of the largest |value|."""
    import numpy as np

    from sr_for_cfd_tpu_torch.solver import simple as tsimple
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    # omega 1.9 as in the 2048^2 case, clamped here to optimal_sor(48, 48)
    kw = dict(TILED, nx=48, ny=48, chunk_size=60, max_iterations=60)
    runs = {}
    for dev in (device, "cpu"):
        solver = make_cavity_solver(device=dev, **kw)
        s, counts = solver.state, []
        for _ in range(3):
            s, c = tsimple.simple_step(s, solver.case, solver.profile,
                                       nu=solver._nu, with_counts=True)
            counts.append(c)
        iters, _ = solver.solve(verbose=False, save_results=False)
        runs[dev] = (counts, iters, solver.interior_fields())
    (ck, ik, fk), (cp, ip, fp) = runs[device], runs["cpu"]
    if ck != cp or ik != ip:
        fail(f"tiled reference: counts differ, card {ck} {ik}, CPU {cp} {ip}")
    worst = 0.0
    for c in "uvp":
        err = float(np.max(np.abs(fk[c] - fp[c])))
        scale = max(1.0, float(np.max(np.abs(fp[c]))))
        worst = max(worst, err / scale)
        if not (np.all(np.isfinite(fk[c])) and err <= 1e-4 * scale):
            fail(f"tiled reference: {c} differs by {err:.3e}")
    log(f"  tiled 48x48 cavity card vs CPU: {ik} steps, inner counts of the first 3 "
        f"steps {ck} (equal), worst relative field difference {worst:.3e} (limit 1e-4)")


def big_grid_reference(device):
    """The 48^2 cavity with mg_slab_rows=16, which forces the big-grid
    path at any size, on the card (kernels) and on the CPU (plain
    versions): equal outer and inner counts, fields within 1e-4 of the
    largest |value|."""
    import numpy as np

    from sr_for_cfd_tpu_torch.solver import simple as tsimple
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    kw = dict(Re=500, nx=48, ny=48, dt=2e-3, scheme="QUICK", dtype="float32",
              pressure_solver="multigrid", chunk_size=30, max_iterations=60,
              use_pallas=True, mg_slab_rows=16)
    runs = {}
    for dev in (device, "cpu"):
        solver = make_cavity_solver(device=dev, **kw)
        s, counts = solver.state, []
        for _ in range(3):
            s, c = tsimple.simple_step(s, solver.case, solver.profile,
                                       nu=solver._nu, with_counts=True)
            counts.append(c)
        iters, _ = solver.solve(verbose=False, save_results=False)
        runs[dev] = (counts, iters, solver.interior_fields())
    (ck, ik, fk), (cp, ip, fp) = runs[device], runs["cpu"]
    if ck != cp or ik != ip:
        fail(f"big-grid reference: counts differ, card {ck} {ik}, CPU {cp} {ip}")
    worst = 0.0
    for c in "uvp":
        err = float(np.max(np.abs(fk[c] - fp[c])))
        scale = max(1.0, float(np.max(np.abs(fp[c]))))
        worst = max(worst, err / scale)
        if not (np.all(np.isfinite(fk[c])) and err <= 1e-4 * scale):
            fail(f"big-grid reference: {c} differs by {err:.3e}")
    log(f"  big-grid 48x48 forced-slab cavity card vs CPU: {ik} steps, inner counts "
        f"of the first 3 steps {ck} (equal), worst relative field difference "
        f"{worst:.3e} (limit 1e-4)")


# phase 8: the command line and persistence. The CLI's hybrid: the shipped
# 10->400 BFS autoencoder, the fused step in multigrid mode on every phase
# (design (b), rows 3 and 2), K = 10, no RRE
CLI_HYBRID = ["hybrid", "--case", "bfs", "--re", "400", "--lr-dim", "10", "--hr-dim", "400",
              "--fused", "--pressure-solver", "multigrid", "--steps-per-kernel", "10",
              "--model-file", MODEL_FILE, "--stats-file", STATS_FILE,
              "--max-iterations", "2000", "--ml-iterations", "300",
              "--normal-iterations", "300"]
# the same run as run_hybrid_experiment's arguments (cli.cmd_hybrid's mapping)
LIB_HYBRID = dict(Re=400.0, lr_dim=10, hr_dim=400, case="bfs", max_iterations_coarse=2000,
                  max_iterations_ml=300, max_iterations_normal=300, stats_file=STATS_FILE,
                  model_file=MODEL_FILE, use_aspect_ratio_correction=True,
                  use_adaptive_normalization=False, blend_factor=0.3, dt=None, scheme=None,
                  dtype="float32", fused_step=True, pressure_sor=1.0,
                  pressure_solver="multigrid", steps_per_kernel=10, use_pallas=False)
# 8b: a 400^2 BFS solve on the same fused multigrid configuration
RESUME = dict(Re=400, nx=400, ny=400, dt=2e-3, scheme="UPWIND", dtype="float32",
              fused_step=True, pressure_solver="multigrid", steps_per_kernel=10,
              chunk_size=100)
RESUME_STEPS = (200, 300)  # snapshot at the end of the first solve; resumed to the second
SNAPSHOT_EVERY = 100
# 8b at a small size on the card and on the CPU (phase 6's rule)
RESUME_SMALL = dict(Re=100, nx=48, ny=48, dt=1e-3, scheme="QUICK", dtype="float32",
                    fused_step=True, pressure_solver="multigrid", steps_per_kernel=10,
                    chunk_size=60)
RESUME_SMALL_STEPS = (60, 120)
PART_FILES = {"msgpack": ("artifacts/vanilla_encoder10_to_400_swish_tpu_bfs.msgpack",
                          "artifacts/vanilla_decoder400_from_10_swish_tpu_bfs.msgpack"),
              "h5": ("artifacts/vanilla_encoder10_to_400_swish_tpu_bfs.h5",
                     "artifacts/vanilla_decoder400_from_10_swish_tpu_bfs.h5")}


def importable(package):
    try:
        importlib.import_module(package)
    except ImportError:
        return False
    return True


class DatWrites:
    """Records the seconds of every `_full.dat` write while it is entered
    (a wrapper around io.datfiles.save_full_field, which
    io.results.save_all_results looks up at each call)."""

    def __enter__(self):
        from sr_for_cfd_tpu_torch.io import datfiles

        self.writes, self.save = [], datfiles.save_full_field
        writes, save = self.writes, self.save

        def timed_save(filename, var, *a, **k):
            t = time.perf_counter()
            save(filename, var, *a, **k)
            writes.append((os.path.basename(filename), var.shape, time.perf_counter() - t))

        datfiles.save_full_field = timed_save
        return self

    def __exit__(self, *exc):
        from sr_for_cfd_tpu_torch.io import datfiles

        datfiles.save_full_field = self.save


def cli_hybrid(device, out_dir):
    """8a's CLI run through `cli.main`, its standard output captured:
    (the results JSON, the output lines, the .dat writes)."""
    import contextlib
    import io

    from sr_for_cfd_tpu_torch import cli

    buf = io.StringIO()
    reset_counters()
    with DatWrites() as dat, contextlib.redirect_stdout(buf):
        cli.main(CLI_HYBRID + ["--out", out_dir, "--device", device])
    text = buf.getvalue()
    start = text.rfind("\n{\n")
    if start < 0:
        fail("the CLI hybrid printed no results JSON")
    return json.loads(text[start + 1:]), text[:start].splitlines(), dat.writes


def phase_cli_hybrid(device):
    """8a: the BFS hybrid through the command line at full width, then
    run_hybrid_experiment with the same arguments; both under
    deterministic cuDNN. Returns the record printed on the phase's line."""
    import torch

    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="srcfd_cli_") as out_dir:
            t = time.perf_counter()
            res, lines, writes = cli_hybrid(device, out_dir)
            cli_s = time.perf_counter() - t
            files = sorted(os.listdir(out_dir))
        with tempfile.TemporaryDirectory(prefix="srcfd_lib_") as out_dir:
            reset_counters()
            lib = run_hybrid_experiment(output_dir=out_dir, verbose=False, device=device,
                                        **LIB_HYBRID)
    finally:
        cudnn.deterministic = saved
    launches = res["kernel_launches"]
    for phase in ("coarse", "ml", "normal"):
        if launches[phase]["fused_step"] <= 0:
            fail(f"CLI hybrid: the fused-step kernel did not launch in the {phase} phase")
    for phase in ("ml", "normal"):
        if launches[phase]["mg_vcycle_pressure"] <= 0:
            fail(f"CLI hybrid: the V-cycle kernel did not launch in the {phase} phase")
    for key in ("coarse_iterations", "normal_iterations"):
        if res[key] != lib[key]:
            fail(f"CLI hybrid: {key} {res[key]} differs from run_hybrid_experiment's "
                 f"{lib[key]}")
    # each phase's two .dat files; where h5py or matplotlib is missing, one
    # skip line per skipped writer and none of its files
    if sum(f.endswith(("_full.dat", "_centerline.dat")) for f in files) != 6:
        fail(f"CLI hybrid: files written {files}")
    for package, (starts, n, ends) in {
            "h5py": (("  (HDF5 group skipped:",), 3, (".h5",)),
            "matplotlib": (("  (plots skipped:", "  (centerline comparison plot skipped:"),
                           4, (".png",))}.items():
        if not importable(package):
            skips = [ln for ln in lines if ln.startswith(starts) and package in ln]
            if len(skips) != n or any(f.endswith(ends) for f in files):
                fail(f"CLI hybrid: {len(skips)} skip lines naming {package}, not {n}, "
                     f"or its files written: {files}")
    phase_s = {ph: res[f"{ph}_time"] for ph in ("coarse", "ml", "normal")}
    warm = {"cli": (res["ml_iterations"], launches["ml"]["mg_vcycle_replays"],
                    launches["ml"]["fused_step_reads"]),
            "library": (lib["ml_iterations"], lib["kernel_launches"]["ml"]["mg_vcycle_replays"],
                        lib["kernel_launches"]["ml"]["fused_step_reads"])}
    log(f"  CLI hybrid: {cli_s:.1f} s in all; iterations coarse / warm / cold "
        f"{res['coarse_iterations']} / {res['ml_iterations']} / {res['normal_iterations']}, "
        f"the library's {lib['coarse_iterations']} / {lib['ml_iterations']} / "
        f"{lib['normal_iterations']}; ms/iter CLI {res['ms_per_iteration']}, library "
        f"{lib['ms_per_iteration']}")
    log(f"  CLI hybrid warm phase (iterations, V-cycle replays, momentum host reads) "
        f"under deterministic cuDNN: CLI {warm['cli']}, library {warm['library']}, "
        f"equal: {warm['cli'] == warm['library']}")
    log(f"  CLI hybrid files: {files}")
    for ln in lines:
        if "skipped:" in ln:
            log(f"  CLI hybrid printed: {ln.strip()}")
    log(f"  CLI hybrid _full.dat writes (file, Var shape, s): {writes}; phase solve s "
        f"{phase_s}")
    return dict(launches={ph: {k: launches[ph][k] for k in
                               ("fused_step", "fused_step_reads", "mg_vcycle_pressure",
                                "mg_vcycle_replays")} for ph in launches},
                iterations=[res[f"{ph}_iterations"] for ph in ("coarse", "ml", "normal")],
                library_iterations=[lib[f"{ph}_iterations"]
                                    for ph in ("coarse", "ml", "normal")],
                warm=warm, full_dat_s=[sec for _, _, sec in writes], phase_s=phase_s,
                ms_per_iteration=res["ms_per_iteration"], seconds=cli_s)


def snapshot_and_resume(device, make, kw, steps, base, profile_dir=None):
    """A solve of make(**kw) to steps[0] with a snapshot every
    SNAPSHOT_EVERY (or at steps[0]) iterations, then a new solver resumed
    from the snapshot to steps[1]. Returns (first solver, snapshot path,
    resumed solver, launches of the resumed solve)."""
    from sr_for_cfd_tpu_torch.io.checkpoint import load_solver_count
    from sr_for_cfd_tpu_torch.workflow.hybrid import _launches_since, kernel_launch_counts

    every = min(SNAPSHOT_EVERY, steps[0])
    first = make(device=device, max_iterations=steps[0], **kw)
    first.precompile()
    first.solve(base, verbose=False, save_results=False, snapshot_every=every,
                profile_dir=profile_dir)
    snap = f"{base}_snapshot.npz"
    if first.state.count != steps[0] or load_solver_count(snap) != steps[0]:
        fail(f"snapshot: count {load_solver_count(snap)}, solver {first.state.count}, "
             f"wanted {steps[0]}")
    resumed = make(device=device, max_iterations=steps[1], **kw)
    resumed.resume_from(snap)
    if resumed.state.count != steps[0]:
        fail(f"resume: starts at {resumed.state.count}, not {steps[0]}")
    before = kernel_launch_counts()
    resumed.solve(verbose=False, save_results=False)
    return first, snap, resumed, _launches_since(before)


def trace_kernels(trace_dir):
    """Names of the device kernels in the torch.profiler trace(s) under
    trace_dir."""
    import glob
    import re

    # Kineto writes each event's "cat" just before its "name"; a search of
    # the text reads a trace of some 100 MiB far faster than json.load
    kernel = re.compile(r'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"')
    names = set()
    for path in glob.glob(os.path.join(trace_dir, "*.json")):
        with open(path) as f:
            names.update(kernel.findall(f.read()))
    return names


def phase_resume(device):
    """8b: snapshot at 200 and resume to 300 on the 400^2 BFS (the solve
    traced), and at 48^2 on the card against the CPU's plain path."""
    import numpy as np

    from sr_for_cfd_tpu_torch.solver.cases import make_bfs_solver, make_cavity_solver

    with tempfile.TemporaryDirectory(prefix="srcfd_snap_") as tmp:
        trace_dir = os.path.join(tmp, "trace")
        t = time.perf_counter()
        first, snap, resumed, launches = snapshot_and_resume(
            device, make_bfs_solver, RESUME, RESUME_STEPS, os.path.join(tmp, "bfs"), profile_dir=trace_dir)
        solve_s = time.perf_counter() - t
        with np.load(snap) as data:
            for k in "uvp":
                if not np.array_equal(data[k], getattr(first.state, k).cpu().numpy()):
                    fail(f"snapshot: {k} is not bit-equal to the solver's state")
        t = time.perf_counter()
        kernels = trace_kernels(trace_dir)
        trace_s = time.perf_counter() - t
        trace_mb = sum(os.path.getsize(os.path.join(trace_dir, f))
                       for f in os.listdir(trace_dir)) / 2**20
    if resumed.state.count != RESUME_STEPS[1] or not finite_fields(resumed):
        fail(f"resume: count {resumed.state.count} or non-finite fields")
    if launches["fused_step"] <= 0 or launches["mg_vcycle_pressure"] <= 0:
        fail(f"resume: rows 3 and 2 did not both launch: {launches}")
    step = sorted(n for n in kernels if n.startswith(("step_", "mom_pass")))
    vcycle = sorted(n for n in kernels if n.startswith("mg_"))
    if not step or not vcycle:
        fail(f"trace: no fused-step or no V-cycle kernel among {sorted(kernels)}")
    log(f"  snapshot at {RESUME_STEPS[0]} bit-equal to the solver's state; resumed "
        f"{RESUME_STEPS[0]} -> {resumed.state.count} with launches "
        f"fused_step {launches['fused_step']}, mg_vcycle_pressure "
        f"{launches['mg_vcycle_pressure']}; both solves {solve_s:.1f} s; trace "
        f"{trace_mb:.1f} MiB read in {trace_s:.1f} s, kernels {step + vcycle}")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="srcfd_snap_") as tmp:
        for dev in (device, "cpu"):
            first, _, resumed, _ = snapshot_and_resume(
                dev, make_cavity_solver, RESUME_SMALL, RESUME_SMALL_STEPS, os.path.join(tmp, dev))
            runs[dev] = (first.interior_fields(), resumed.state.count,
                         resumed.interior_fields())
    worst = 0.0
    for stage, i in (("snapshot", 0), ("resumed", 2)):
        if runs[device][1] != runs["cpu"][1]:
            fail(f"48x48 resume: counts differ, card {runs[device][1]}, CPU {runs['cpu'][1]}")
        for c in "uvp":
            a, b = runs[device][i][c], runs["cpu"][i][c]
            err = float(np.max(np.abs(a - b)))
            scale = max(1.0, float(np.max(np.abs(b))))
            worst = max(worst, err / scale)
            if not (np.all(np.isfinite(a)) and err <= 1e-4 * scale):
                fail(f"48x48 resume: {stage} {c} differs by {err:.3e}")
    log(f"  48x48 snapshot -> resume card vs CPU: counts {RESUME_SMALL_STEPS}, worst "
        f"relative field difference {worst:.3e} (limit 1e-4)")
    return dict(solve_s=solve_s, trace_mb=trace_mb, trace_read_s=trace_s,
                trace_kernels=step + vcycle, resumed_launches=launches,
                small_worst=worst)


def phase_model_parts(device):
    """8c: SRModel.from_parts on the shipped .msgpack parts predicts
    bit-equal to from_checkpoint(MODEL_FILE) under deterministic cuDNN; on
    the .h5 parts it needs h5py."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.sr.inference import SRModel

    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (3, 10, 10, 1)).astype(np.float32)).to(device)
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        whole = SRModel.from_checkpoint(MODEL_FILE, 10, 400, device=device).predict(x)
        parts = SRModel.from_parts(*PART_FILES["msgpack"], 10, 400,
                                   device=device).predict(x)
        if not torch.equal(whole, parts):
            fail("from_parts (.msgpack) does not predict bit-equal to from_checkpoint")
        if not importable("h5py"):
            try:
                SRModel.from_parts(*PART_FILES["h5"], 10, 400, device=device)
            except ImportError as e:
                if "h5py" not in str(e):
                    fail(f"from_parts (.h5) raised without naming h5py: {e}")
                h5 = f"raises: {e}"
            else:
                fail("from_parts (.h5) loaded without h5py")
        else:
            h5_parts = SRModel.from_parts(*PART_FILES["h5"], 10, 400, device=device)
            if not torch.equal(h5_parts.predict(x), whole):
                fail("from_parts (.h5) does not predict bit-equal to from_checkpoint")
            h5 = "loads (h5py installed), bit-equal"
    finally:
        cudnn.deterministic = saved
    log(f"  from_parts: .msgpack parts bit-equal to from_checkpoint; .h5 parts {h5}")
    return dict(msgpack_bit_equal=True, h5=h5)


# the row-decomposed solver (sr_for_cfd_tpu_torch/parallel/): one rank on the
# card, an NCCL group of world size 1 through a file:// store
SPMD_RANKS = 8  # the row 9 gates cut the 2048^2 field as 8 ranks' bands
SHARD_SOR = 1.9  # min(1.9, optimal_sor(2048, 2048)) = 1.9
FLOP_SHARD_CELL = 13  # shard_rb.cu: Laplacian, residual, f + r * inv_ap


def shard_block(p, b, rank, rows, h):
    """(ext, b_ext) of `rank`'s band with an h-row halo, as
    spmd_step.assemble and spmd_kernels.extend_b_halo build them: the
    padded field's rows, the ghost row repeated beyond the domain; the
    interior right-hand side, zero outside the domain and on the y-ghost
    columns."""
    import torch

    nx = p.shape[0] - 2
    gi = torch.arange(rank * rows - h, (rank + 1) * rows + h, device=p.device)
    ext = p[(gi + 1).clamp(0, nx + 1)].contiguous()
    inside = (gi >= 0) & (gi < nx)
    b_ext = torch.zeros_like(ext)
    b_ext[inside, 1:-1] = b[gi[inside]]
    return ext, b_ext


def shard_work(R, W, rows, kb, all_valid=True):
    """(bytes, flops) of one per-rank call: ext and b_ext read once, the own
    rows written once; kb sweeps over the block's valid cells, r^2 summed
    over the own cells."""
    cells = (R if all_valid else rows) * (W - 2)
    return 4 * (2 * R * W + rows * W), kb * FLOP_SHARD_CELL * cells + FLOP_SUMSQ_CELL * rows * (W - 2)


def check_shard(gates, name, ext, b_ext, row0, kw):
    """The per-rank sweep (the fused form, one launch) against the staged
    form (kb one-sweep launches and the sum) and the plain version on one
    block: own rows and residual sum bit-equal, or the run fails. Returns
    the largest own-row difference."""
    import torch

    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import (
        _shard_rb_sweep_staged,
        shard_rb_sweep,
        shard_rb_sweep_plain,
    )

    own_k, ss_k = shard_rb_sweep(ext, b_ext, row0, **kw)
    own_k, ss_k = own_k.clone(), ss_k.clone()
    own_s, ss_s = _shard_rb_sweep_staged(ext, b_ext, row0, **kw)
    own_p, ss_p = shard_rb_sweep_plain(ext, b_ext, row0, **kw)
    torch.cuda.synchronize()
    err = float(torch.max(torch.abs(own_k - own_p)).item())
    bit = torch.equal(own_k, own_p) and torch.equal(ss_k, ss_p)
    bit_staged = torch.equal(own_k, own_s) and torch.equal(ss_k, ss_s)
    log(f"  shard_rb {name}: own rows and ss bit-equal to the plain version {bit}, to the "
        f"staged form {bit_staged} (max_abs_err {err:.3e}, ss {float(ss_k):.9e} / "
        f"{float(ss_p):.9e} / {float(ss_s):.9e})")
    if not (bit and bit_staged):
        fail(f"shard_rb {name}: the fused form, the staged form and the plain version differ")
    gates.append(dict(gate=name, bit_equal=bit, bit_equal_staged=bit_staged,
                      max_abs_err=err))
    return err


def main_path_shard_gates(gates, device):
    """The per-rank sweep at the blocks the two one-rank main paths hand
    it, built as they build them: the 400^2 sweeps path's (400 + 2x16,
    402) block at kb 8 (both ends beyond the domain, the ghost row
    repeated there, as spmd_step.assemble does); every sharded level of
    the 2048^2 multigrid path at the smoother's kb, as
    spmd_mg.smooth_kernel builds it (zero rows beyond the domain, zero
    columns, b through extend_b_halo). Seeded fields; bit-equal or fail."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops.multigrid import MG_SMOOTHER_SOR
    from sr_for_cfd_tpu_torch.ops.sweeps import optimal_sor
    from sr_for_cfd_tpu_torch.parallel import presets
    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import extend_b_halo
    from sr_for_cfd_tpu_torch.parallel.spmd_mg import plan_spmd_mg
    from sr_for_cfd_tpu_torch.parallel.spmd_step import sweep_blocks

    worst = 0.0
    kw = presets.SWEEPS_400
    st = presets.cavity_case(kw, 1).settings
    n = kw["nx"]
    kb = sweep_blocks(st.pressure_check_every, n // 2)[0]
    p, ff, geo = seeded_problem(np.random.default_rng(400), n, n, 1.0, 1.0, device)
    b = (geo["rho"] / geo["dt"]) * ff.divergence_sum()
    ext, b_ext = shard_block(p, b, 0, n, 2 * kb)
    worst = max(worst, check_shard(
        gates, f"{n}^2 sweeps path block, one rank, kb={kb}", ext, b_ext, 0,
        dict(nxg=n, inv_dx2=1.0 / geo["dx"] ** 2, inv_dy2=1.0 / geo["dy"] ** 2,
             volp=geo["volp"], sor=min(st.pressure_sor, optimal_sor(n, n)),
             h=2 * kb, kb=kb)))

    case = presets.cavity_case(presets.MULTIGRID_2048, 1)
    st, m = case.settings, case.mesh
    plan = plan_spmd_mg(m.nx, m.ny, m.dx, m.dy, m.volp, 1, np.dtype(np.float32),
                        min_size=st.mg_min_size)
    g = torch.Generator(device=device).manual_seed(2048)
    for lvl in range(plan.n_shard):
        (nxl, nyl), (inv_dx2, inv_dy2) = plan.setup.sizes[lvl], plan.setup.spacings[lvl]
        kb = sweep_blocks(st.mg_n_pre, max(1, nxl // 2))[0]
        h = 2 * kb
        x = torch.randn((nxl, nyl), generator=g, device=device)
        bl = torch.randn((nxl, nyl), generator=g, device=device)
        zr, zc = x.new_zeros((h, nyl)), x.new_zeros((nxl + 2 * h, 1))
        ext = torch.cat([zc, torch.cat([zr, x, zr]), zc], dim=1)
        worst = max(worst, check_shard(
            gates, f"{m.nx}^2 multigrid level {lvl} ({nxl}x{nyl}), one rank, kb={kb}",
            ext, extend_b_halo(bl, h=h), 0,
            dict(nxg=nxl, inv_dx2=inv_dx2, inv_dy2=inv_dy2,
                 volp=plan.setup.volp_levels[lvl], sor=MG_SMOOTHER_SOR, h=h, kb=kb)))
    return worst


def phase_shard_kernels(device):
    """The per-rank red-black sweep (row 9). On a seeded 2048^2 problem cut
    as 8 ranks' 256-row bands, kb 1 and 8 (h = 2kb): on every rank the
    fused form's own rows and residual sum bit-equal to the staged form and
    to the plain version; the 8 ranks' own rows stitched against kb
    whole-grid red-black sweeps (the plain arithmetic on the whole field,
    ghost ring frozen) within 1e-6 of max|p|. Bit-equal at the one-rank
    main paths' own blocks too (`main_path_shard_gates`). Ms per call of
    the fused and the staged form, each with and without its host read,
    of the fused form's C entry alone and of the plain version, at kb 8
    and kb 1 on rank 3's band; launches per call."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops import kernel_lib, shard_rb
    from sr_for_cfd_tpu_torch.ops.sweeps import optimal_sor
    from sr_for_cfd_tpu_torch.parallel.spmd_kernels import (
        _coefficient,
        _fused_params,
        _shard_rb_sweep_staged,
        shard_rb_sweep,
        shard_rb_sweep_plain,
    )

    n = BIG_N
    rows = n // SPMD_RANKS
    p, ff, geo = seeded_problem(np.random.default_rng(9), n, n, 1.0, 1.0, device)
    b = (geo["rho"] / geo["dt"]) * ff.divergence_sum()
    kw = dict(nxg=n, inv_dx2=1.0 / geo["dx"] ** 2, inv_dy2=1.0 / geo["dy"] ** 2,
              volp=geo["volp"], sor=min(SHARD_SOR, optimal_sor(n, n)))
    gates, worst = [], 0.0
    for kb in (1, 8):
        h = 2 * kb
        for rank in range(SPMD_RANKS):
            ext, b_ext = shard_block(p, b, rank, rows, h)
            worst = max(worst, check_shard(gates, f"kb={kb} rank {rank}", ext, b_ext,
                                           rank * rows, dict(kw, h=h, kb=kb)))
        stitched = torch.cat([
            shard_rb_sweep(*shard_block(p, b, r, rows, h), r * rows, h=h, kb=kb, **kw)[0]
            for r in range(SPMD_RANKS)])
        f = p
        b_whole = torch.zeros((n + 4, n + 2), dtype=p.dtype, device=p.device)
        b_whole[2:-2, 1:-1] = b
        for _ in range(kb):
            inner, _ = shard_rb_sweep_plain(torch.cat([f[:1], f, f[-1:]]), b_whole, 0,
                                            h=2, kb=1, **kw)
            f = torch.cat([f[:1], inner, f[-1:]])
        torch.cuda.synchronize()
        err = float(torch.max(torch.abs(stitched - f[1:-1])).item())
        scale = float(torch.max(torch.abs(f)).item())
        log(f"  shard_rb kb={kb}: 8 ranks stitched vs {kb} whole-grid sweeps, "
            f"max_abs_err {err:.3e} (limit 1e-6 x {scale:.3e})")
        if not err <= 1e-6 * scale:
            fail(f"shard_rb kb={kb}: stitched own rows differ from the whole-grid sweeps")
        gates.append(dict(gate=f"kb={kb} stitched vs whole grid", max_abs_err=err))
    worst = max(worst, main_path_shard_gates(gates, device))
    # a kb past the fused form's shared memory runs on the one-sweep form
    kb = 34
    assert not shard_rb.fits(kb)
    ext, b_ext = shard_block(p, b, 3, rows, 2 * kb)
    call = dict(kw, h=2 * kb, kb=kb)
    worst = max(worst, check_shard(gates, f"kb={kb} rank 3 (past the fused budget)", ext,
                                   b_ext, 3 * rows, call))
    past = launches_per_call(lambda: shard_rb_sweep(ext, b_ext, 3 * rows, **call),
                             shard_rb_sweep)
    if past != kb + 1:
        fail(f"shard_rb kb={kb}: {past} launches a call, expected {kb + 1}")

    # times of one call on rank 3's band: the fused form (the wrapper, and
    # its C entry alone), the staged form, the plain version
    rank = 3
    times = {}
    for kb in (8, 1):
        h = 2 * kb
        ext, b_ext = shard_block(p, b, rank, rows, h)
        call = dict(h=h, kb=kb, **kw)
        t = dict(
            ms=cuda_ms(lambda: shard_rb_sweep(ext, b_ext, rank * rows, **call), 100),
            staged_ms=cuda_ms(lambda: _shard_rb_sweep_staged(ext, b_ext, rank * rows, **call),
                              100),
            ms_with_host_read=cuda_ms(
                lambda: shard_rb_sweep(ext, b_ext, rank * rows, **call)[1].item(), 50),
            staged_ms_with_host_read=cuda_ms(
                lambda: _shard_rb_sweep_staged(ext, b_ext, rank * rows, **call)[1].item(), 50))
        addr = _fused_params(ext.shape[0], ext.shape[1], h, kb, n, kw["inv_dx2"],
                             kw["inv_dy2"], kw["volp"], _coefficient(
                                 kw["inv_dx2"], kw["inv_dy2"], kw["volp"], kw["sor"]),
                             ext.device)[0]
        out = torch.empty((rows, n + 2), device=ext.device)
        lib, stream = kernel_lib.load_library(), kernel_lib.stream_ptr(ext.device)
        ss = torch.empty((), device=ext.device)
        t["kernel_ms"] = cuda_ms(lambda: lib.srcfd_shard_rb_fused(
            addr, ext.data_ptr(), out.data_ptr(), b_ext.data_ptr(), ss.data_ptr(),
            rank * rows, stream), 200)
        t["launches_per_call"] = launches_per_call(
            lambda: shard_rb_sweep(ext, b_ext, rank * rows, **call), shard_rb_sweep)
        t["staged_launches_per_call"] = launches_per_call(
            lambda: _shard_rb_sweep_staged(ext, b_ext, rank * rows, **call),
            _shard_rb_sweep_staged)
        if kb == 8:
            t["plain_ms"] = cuda_ms(lambda: shard_rb_sweep_plain(ext, b_ext, rank * rows,
                                                                 **call), 3)
            t["bound_ms"], t["bound_by"] = bound_ms(*shard_work(rows + 2 * h, n + 2, rows, kb))
        times[kb] = t
    t8, t1 = times[8], times[1]
    log(f"  shard_rb {rows}+2x16 rows x {n + 2}, kb=8: fused call {t8['ms']:.5f} ms "
        f"({t8['launches_per_call']} launch; its C entry alone {t8['kernel_ms']:.5f}), with "
        f"its host read {t8['ms_with_host_read']:.5f}; staged form {t8['staged_ms']:.5f} "
        f"({t8['staged_launches_per_call']} launches), with its host read "
        f"{t8['staged_ms_with_host_read']:.5f}; plain {t8['plain_ms']:.5f}; bound "
        f"{t8['bound_ms']:.6f} ({t8['bound_by']}); kb=1: fused {t1['ms']:.5f} (C entry "
        f"{t1['kernel_ms']:.5f}), staged {t1['staged_ms']:.5f}")
    return dict(max_abs_err=worst, ms=t8["ms"], plain_ms=t8["plain_ms"],
                bound_ms=t8["bound_ms"], bound_by=t8["bound_by"],
                launches_per_call=t8["launches_per_call"], kernel_ms=t8["kernel_ms"],
                ms_with_host_read=t8["ms_with_host_read"], staged_ms=t8["staged_ms"],
                staged_launches_per_call=t8["staged_launches_per_call"],
                staged_ms_with_host_read=t8["staged_ms_with_host_read"],
                kb1=t1, gates=gates)


def run_spmd_path(name, device, kw, steps):
    """SpmdSolver(case, group) on one rank from the cold start; launch
    counters and collective counts set to 0 just before the solve and read
    just after; the per-rank sweep must have launched."""
    import torch

    from sr_for_cfd_tpu_torch import SpmdSolver
    from sr_for_cfd_tpu_torch.parallel import mesh, presets
    from sr_for_cfd_tpu_torch.workflow.hybrid import kernel_launch_counts

    solver = SpmdSolver(presets.cavity_case(kw, steps), device=device)
    torch.cuda.synchronize()
    reset_counters()
    mesh.reset_counts()
    t = time.perf_counter()
    local = solver.solve()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t
    launches = kernel_launch_counts()
    comm = dict(mesh.COUNTS)
    iters = local.count
    if iters != steps or solver.steps_run != steps:
        fail(f"{name}: ran {iters} steps, expected {steps}")
    if not all(bool(torch.isfinite(x).all().item()) for x in (local.u, local.v, local.p)):
        fail(f"{name}: non-finite fields")
    if launches["shard_rb_pressure"] <= 0:
        fail(f"{name}: the per-rank sweep kernel (row 9) did not launch")
    per = {k: round(v / iters, 2) for k, v in solver.inner_counts.items()}
    log(f"  {name}: {iters} steps in {elapsed:.3f} s, {1e3 * elapsed / iters:.3f} ms/iter; "
        f"inner per step {per} (p: {'V-cycles' if kw['pressure_solver'] == 'multigrid' else 'sweeps'}); "
        f"row 9 launches per step {launches['shard_rb_pressure'] / iters:.2f}; collectives "
        f"per step { {k: round(v / iters, 2) for k, v in comm.items()} }; finite fields; "
        f"rms {local.rms.tolist()}")
    return {k: v for k, v in launches.items() if not k.startswith("rre")}


def phase_spmd_sweeps(device):
    from sr_for_cfd_tpu_torch.parallel import presets

    return run_spmd_path("SPMD sweeps 400^2 cavity, 1 rank", device, presets.SWEEPS_400,
                         presets.SWEEPS_400_STEPS)


def phase_spmd_multigrid(device):
    from sr_for_cfd_tpu_torch.parallel import presets

    return run_spmd_path(f"SPMD multigrid {BIG_N}^2 cavity, 1 rank", device,
                         presets.MULTIGRID_2048, presets.MULTIGRID_2048_STEPS)


def spmd_reference(device):
    """The two SPMD routes at a small size through SpmdSolver on the card
    (NCCL, the kernel) and on the CPU (a gloo group of the same rank, the
    plain version): the 32^2 cavity on the sweeps route (40 steps) and the
    64^2 cavity on the multigrid route (20 steps), each with its main
    path's settings (QUICK, Re=1000, dt=1e-3, float32, use_pallas). Equal
    inner counts in the first 3 steps (sweeps, or V-cycles) and an equal
    step count, fields within 1e-4 of the largest |value|."""
    import numpy as np
    import torch.distributed as dist

    from sr_for_cfd_tpu_torch import SpmdSolver
    from sr_for_cfd_tpu_torch.parallel import presets

    gloo = dist.new_group([0], backend="gloo")
    for label, kw, steps in (
            ("32x32 cavity (use_pallas sweeps)", dict(presets.SWEEPS_400, nx=32, ny=32), 40),
            ("64x64 cavity (use_pallas multigrid)",
             dict(presets.MULTIGRID_2048, nx=64, ny=64), 20)):
        runs = {}
        for dev, group in ((device, None), ("cpu", gloo)):
            first = SpmdSolver(presets.cavity_case(kw, steps), group=group, device=dev)
            counts = [first.step() for _ in range(3)]
            solver = SpmdSolver(presets.cavity_case(kw, steps), group=group, device=dev)
            solver.solve()
            runs[dev] = (counts, solver.local.count, solver.interior_fields())
        (ck, ik, fk), (cp, ip, fp) = runs[device], runs["cpu"]
        if ck != cp or ik != ip or ik != steps:
            fail(f"SPMD reference {label}: counts differ, card {ck} {ik}, CPU {cp} {ip}")
        worst = 0.0
        for c in "uvp":
            err = float(np.max(np.abs(fk[c] - fp[c])))
            scale = max(1.0, float(np.max(np.abs(fp[c]))))
            worst = max(worst, err / scale)
            if not (np.all(np.isfinite(fk[c])) and err <= 1e-4 * scale):
                fail(f"SPMD reference {label}: {c} differs by {err:.3e}")
        log(f"  SPMD {label} card vs CPU: {ik} steps, inner counts of the first 3 steps "
            f"{ck} (equal), worst relative field difference {worst:.3e} (limit 1e-4)")
    dist.destroy_process_group(gloo)


# phase 9: the native .dat writer and the decomposed workflow on one rank
# (NCCL world size 1): the hybrid's fine phases behind SpmdWorkflowAdapter,
# the case-batched decomposed sweep and data-parallel training
# the non-fused path's coarse budget; the fine phases cut to 30 steps: on the
# BFS the float32 V-cycle never meets the 1e-6 inner tolerance, so each step
# runs its V-cycles to the stall policy, ~0.5 s a step on one rank
ADAPTER_BUDGETS = (500, 30, 30)
SPMD_SWEEP_N = 400
SPMD_SWEEP_STEPS = 6  # cut: the sweep's budget is 100000 steps
SPMD_SWEEP_CHUNK = 3
DP_SAMPLES = 21  # the paired sweep's train split: 7 Re x 3 components
DP_EPOCHS = 20
DP_LOG_EVERY = 10


class AdapterFine:
    """While entered, the hybrid's fine phases (nx = hr) run behind
    `SpmdWorkflowAdapter` on the one-rank mesh `make_mesh(1, "x")`, built by
    the workflow's own `hybrid._decomposed` (what it builds for
    spmd_devices > 1 over N ranks); the adapters are kept."""

    def __init__(self, device, hr):
        self.device, self.hr, self.made = device, hr, []

    def __enter__(self):
        from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
        from sr_for_cfd_tpu_torch.workflow import hybrid

        self.real = real = hybrid._make_solver
        made, device, hr = self.made, self.device, self.hr

        def make(case, Re, nx, ny, *a, **k):
            solver = real(case, Re, nx, ny, *a, **k)
            if nx != hr:
                return solver
            made.append(hybrid._decomposed(solver, make_mesh(1, "x"), device))
            return made[-1]

        hybrid._make_solver = make
        return self

    def __exit__(self, *exc):
        from sr_for_cfd_tpu_torch.workflow import hybrid

        hybrid._make_solver = self.real


def phase_adapter_hybrid(device):
    """9b: the non-fused BFS hybrid (row 1 coarse, the shipped AE) with its
    fine phases on the adapter (the sharded V-cycle, row 9 its smoother),
    counters set to 0 before and read after; each fine phase bit-equal to
    the same SpmdSolver driven without the adapter."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(prefix="srcfd_adapter_") as out_dir:
            reset_counters()
            with AdapterFine(device, 400) as fine, DatWrites() as dat:
                t = time.perf_counter()
                res = run_hybrid_experiment(
                    max_iterations_coarse=ADAPTER_BUDGETS[0],
                    max_iterations_ml=ADAPTER_BUDGETS[1],
                    max_iterations_normal=ADAPTER_BUDGETS[2], model_file=MODEL_FILE,
                    stats_file=STATS_FILE, output_dir=out_dir, save_results=True,
                    coarse_overrides=NON_FUSED_COARSE, device=device, **NON_FUSED)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t
            files = sorted(os.listdir(out_dir))
    finally:
        cudnn.deterministic = saved
    launches = res["kernel_launches"]
    if len(fine.made) != 2 or res["solvers"]["ml"] is not fine.made[0]:
        fail(f"adapter hybrid: the fine phases did not run on the adapter ({fine.made})")
    if launches["coarse"]["rb_sor_pressure"] <= 0:
        fail("adapter hybrid: row 1 did not launch in the coarse phase")
    for phase in ("ml", "normal"):
        if launches[phase]["shard_rb_pressure"] <= 0:
            fail(f"adapter hybrid: row 9 did not launch in the {phase} phase")
        if launches[phase]["mg_vcycle_pressure"] != 0:
            fail(f"adapter hybrid: row 2 launched in the {phase} phase")
    fine_dat = [f for f in files if f.endswith(("_full.dat", "_centerline.dat"))]
    if len(fine_dat) != 6:
        fail(f"adapter hybrid: files written {files}")
    # the same SpmdSolver, bare: warm from the same SR fields, and cold
    gates = {}
    for phase, warm in (("ml", res["hr_fields"]), ("normal", None)):
        adapter = res["solvers"][phase]
        bare = SpmdSolver(adapter.case, make_mesh(1, "x"), device=device)
        if warm is not None:
            bare.warm_start(warm)
        bare.solve()
        got, want = adapter.interior_fields(), bare.interior_fields()
        same = all(np.array_equal(got[c], want[c]) for c in "uvp")
        counts = (adapter.spmd.local.count, bare.local.count,
                  adapter.spmd.inner_counts, bare.inner_counts)
        if not same or counts[0] != counts[1] or counts[2] != counts[3]:
            fail(f"adapter hybrid: the {phase} phase differs from the bare SpmdSolver "
                 f"(bit-equal {same}, counts {counts})")
        if not all(np.all(np.isfinite(got[c])) for c in "uvp"):
            fail(f"adapter hybrid: non-finite fields in the {phase} phase")
        gates[phase] = dict(bit_equal=True, count=counts[0], inner=counts[2])
    per = {}
    for phase in ("coarse", "ml", "normal"):
        n, secs = res[f"{phase}_iterations"], res[f"{phase}_time"]
        per[phase] = dict(iterations=n, s=secs, ms_per_iter=1e3 * secs / max(n, 1),
                          row9_per_step=launches[phase]["shard_rb_pressure"] / max(n, 1))
        log(f"  adapter hybrid {phase}: {n} iterations, {secs:.3f} s, "
            f"{per[phase]['ms_per_iter']:.3f} ms/iter, row 1 launches "
            f"{launches[phase]['rb_sor_pressure']}, row 9 launches "
            f"{launches[phase]['shard_rb_pressure']} ({per[phase]['row9_per_step']:.2f} a step)")
    log(f"  adapter hybrid: warm {res['ml_iterations']} vs cold {res['normal_iterations']} "
        f"iterations (budgets {ADAPTER_BUDGETS[1:]}); warm inner {gates['ml']['inner']}, cold "
        f"inner {gates['normal']['inner']}; each fine phase bit-equal to the bare "
        f"SpmdSolver with equal counts; run {run_s:.1f} s; .dat writes (file, Var shape, s) "
        f"{dat.writes}")
    totals = {k: sum(launches[ph][k] for ph in launches) for k in launches["coarse"]}
    return totals, dict(phases=per, gates=gates, run_s=run_s, writes=dat.writes,
                        warm_var=res["solvers"]["ml"].Var)


def phase_native_dat(var, phase8):
    """9a: the 400^2 _full.dat through the native writer, byte-identical to
    the Python writer, both timed; phase 8a's writes (now native) against
    the solves they end."""
    import shutil

    from sr_for_cfd_tpu_torch.config import MeshParameters
    from sr_for_cfd_tpu_torch.io import datfiles, native_io

    gxx = shutil.which("g++")
    why = native_io.unavailable()
    if why is not None:
        fail(f"native .dat writer unavailable (g++: {gxx}): {why}")
    mesh = MeshParameters(nx=var.shape[1] - 2, ny=var.shape[2] - 2)
    times = {"native": [], "python": []}
    with tempfile.TemporaryDirectory(prefix="srcfd_dat_") as tmp:
        paths = {k: os.path.join(tmp, f"{k}_full.dat") for k in times}
        for _ in range(2):  # in turns: native, python, python, native
            for k in (("native", "python") if not times["native"] else ("python", "native")):
                before = dict(native_io.used)
                t = time.perf_counter()
                if k == "native":
                    datfiles.save_full_field(paths[k], var, mesh, 400.0, 2e-3)
                else:
                    datfiles.save_full_field_python(paths[k], var, mesh, 400.0, 2e-3)
                times[k].append(time.perf_counter() - t)
                if k == "native" and native_io.used["native"] != before["native"] + 1:
                    fail("the native .dat writer did not write the body")
        with open(paths["native"], "rb") as f:
            native = f.read()
        with open(paths["python"], "rb") as f:
            python = f.read()
    if native != python:
        fail("the native .dat writer's file differs from the Python writer's")
    writes, solves = phase8["full_dat_s"], phase8["phase_s"]
    shares = [w / s for w, s in zip(writes[-2:], (solves["ml"], solves["normal"]))]
    log(f"  native .dat: g++ {gxx}, library {native_io.LIB.name}; 400^2 _full.dat "
        f"({len(native)} bytes) byte-identical; native {times['native']} s, Python "
        f"{times['python']} s; writers used {dict(native_io.used)}; phase 8a's _full.dat "
        f"writes {writes} s, warm and cold write / solve {shares}")
    return dict(gxx=gxx, bytes=len(native), native_s=times["native"],
                python_s=times["python"], phase8_writes=writes, phase8_share=shares,
                used=dict(native_io.used))


def phase_spmd_sweep(device):
    """9c: batched_spmd_cavity_solve on a 1x1 case x x mesh, the sweep's 8
    Re at 400^2 (double lid, QUICK, multigrid; cut to SPMD_SWEEP_STEPS),
    each case bit-equal to its solo SpmdSolver run."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.parallel.spmd_batch import (
        batched_spmd_cavity_solve,
        make_case_x_mesh,
    )
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    kw = dict(max_iterations=SPMD_SWEEP_STEPS, chunk_size=SPMD_SWEEP_CHUNK,
              pressure_solver="multigrid", dtype=SWEEP["dtype"])
    n = SPMD_SWEEP_N
    torch.cuda.synchronize()
    t = time.perf_counter()
    fields, counts = batched_spmd_cavity_solve(
        SWEEP_RE, n, n, make_case_x_mesh(1, 1), dt=SWEEP["dt"], scheme=SWEEP["scheme"],
        double_lid=SWEEP["double_lid"], verbose=False, device=device, **kw)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    if sorted(fields) != [float(r) for r in SWEEP_RE] or list(counts) != [SPMD_SWEEP_STEPS] * 8:
        fail(f"decomposed sweep: cases {sorted(fields)}, counts {list(counts)}")
    t = time.perf_counter()
    for re_val in SWEEP_RE:
        case = make_cavity_solver(Re=re_val, nx=n, ny=n, dt=SWEEP["dt"], scheme=SWEEP["scheme"],
                                  double_lid=SWEEP["double_lid"], device=device, **kw).case
        solo = SpmdSolver(case, make_mesh(1, "x"), device=device)
        solo.solve()
        want = solo.interior_fields()
        if solo.local.count != SPMD_SWEEP_STEPS or not all(
                np.array_equal(fields[float(re_val)][c], want[c]) for c in "uvp"):
            fail(f"decomposed sweep: Re {re_val} is not bit-equal to its solo run")
        if not all(np.all(np.isfinite(want[c])) for c in "uvp"):
            fail(f"decomposed sweep: Re {re_val} has non-finite fields")
    solo_s = time.perf_counter() - t
    log(f"  decomposed sweep {n}^2 (1x1 case x x mesh, plain multigrid): 8 cases x "
        f"{SPMD_SWEEP_STEPS} steps in {batch_s:.3f} s ({1e3 * batch_s / (8 * SPMD_SWEEP_STEPS):.3f} "
        f"ms a case step); each case bit-equal to its solo SpmdSolver run ({solo_s:.3f} s)")
    return dict(n=n, steps=SPMD_SWEEP_STEPS, s=batch_s, solo_s=solo_s)


def phase_dp_training(device):
    """9d: train_sr_autoencoder on make_mesh(1) (an all_reduce a step on the
    NCCL group) against mesh=None, under deterministic cuDNN: the loss
    history and the kept weights bit-equal; s per epoch."""
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh
    from sr_for_cfd_tpu_torch.workflow.training import train_sr_autoencoder

    # smooth seeded samples (each a field of smooth_fields, standardized)
    x_hr = np.stack([smooth_fields(9 + i // 3, 400, 400, scale=1.0)["uvp"[i % 3]]
                     for i in range(DP_SAMPLES)])[..., None].astype(np.float32)
    x_hr = (x_hr - x_hr.mean()) / x_hr.std()
    x_lr = x_hr.reshape(DP_SAMPLES, 10, 40, 10, 40, 1).mean(axis=(2, 4))
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    runs = {}
    try:
        for name, mesh in (("mesh=None", None), ("make_mesh(1)", make_mesh(1)),
                           ("mesh=None again", None)):
            runs[name] = train_sr_autoencoder(x_lr, x_hr, 10, 400, epochs=DP_EPOCHS,
                                              log_every=DP_LOG_EVERY, verbose=False,
                                              device=device, mesh=mesh)
    finally:
        cudnn.deterministic = saved
    a, b = runs["mesh=None"], runs["make_mesh(1)"]
    if a.loss_history != b.loss_history or not all(
            torch.equal(a.params[k], b.params[k]) for k in a.params):
        fail(f"DP training on one rank differs from mesh=None: {a.loss_history} vs "
             f"{b.loss_history}")
    if not np.all(np.isfinite(a.loss_history)):
        fail(f"DP training: non-finite losses: {a.loss_history}")
    per_epoch = {k: r.seconds / DP_EPOCHS for k, r in runs.items()}
    again = runs["mesh=None again"].loss_history == a.loss_history
    log(f"  DP training 10->400 ({DP_SAMPLES} samples, batch 8, {DP_EPOCHS} epochs): loss "
        f"history and weights bit-equal on make_mesh(1) and mesh=None (mesh=None twice "
        f"equal: {again}); first / last loss {a.loss_history[0]:.6f} / "
        f"{a.loss_history[-1]:.6f}; s per epoch {per_epoch}")
    return dict(s_per_epoch=per_epoch, losses=[a.loss_history[0], a.loss_history[-1]])


def main():
    if not os.path.isdir(os.path.join(HERE, "sr_for_cfd_tpu_torch")):
        fail("run from a checkout of the repository (sr_for_cfd_tpu_torch/ not found)")
    os.chdir(HERE)
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"python {sys.version.split()[0]}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"

    from sr_for_cfd_tpu_torch.ops import kernel_lib

    t = time.perf_counter()
    secs = kernel_lib.build(force=True, verbose=True)
    kernel_lib.load_library()
    log(f"phase build: nvcc {secs:.2f} s, load {time.perf_counter() - t - secs:.2f} s")

    # the row-decomposed solver's process group: one rank on this card,
    # NCCL, through a file:// store in a temporary directory (one host, so
    # the loopback interface)
    import shutil

    import torch.distributed as dist

    from sr_for_cfd_tpu_torch.parallel import mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store_dir = tempfile.mkdtemp(prefix="srcfd_nccl_")
    mesh.init_single_rank(device, store_dir)
    log(f"process group: {dist.get_backend()} world size {dist.get_world_size()}")

    t = time.perf_counter()
    kernels = phase_kernels(device)
    fused = phase_fused(device)
    mom_rows = phase_momentum_kernels(device)
    big_rows, big_gates = phase_big_grid_kernels(device)
    tiled_row = phase_tiled_kernels(device)
    shard_row = phase_shard_kernels(device)
    torch.cuda.synchronize()
    log(f"phase kernels: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    batched_row = phase_sweep_kernels(device)
    torch.cuda.synchronize()
    log(f"phase sweep kernels: {time.perf_counter() - t:.1f} s")

    by_path = {}
    for name, phase in (("non_fused", phase_non_fused),
                        ("north_star", phase_north_star),
                        ("big_grid", phase_big_grid),
                        ("tiled", phase_tiled),
                        ("spmd_sweeps", phase_spmd_sweeps),
                        ("spmd_multigrid", phase_spmd_multigrid)):
        t = time.perf_counter()
        by_path[name] = phase(device)
        torch.cuda.synchronize()
        log(f"phase {name} main path: {time.perf_counter() - t:.1f} s, "
            f"launches {by_path[name]}")

    t = time.perf_counter()
    by_path["sweep_train"], sweep_train = phase_sweep_train(device)
    torch.cuda.synchronize()
    log(f"phase sweep_train main path and its gates: {time.perf_counter() - t:.1f} s, "
        f"launches {by_path['sweep_train']}")

    non_fused = by_path["non_fused"]
    mean = non_fused["rb_sor_sweeps"] / non_fused["rb_sor_pressure"]
    row1_main = row1_at_main_count(device, 8 * max(1, round(mean / 8)))
    row1_main.update(main_sweeps_per_call=mean,
                     main_sweeps_min=non_fused["rb_sor_sweeps_min"],
                     main_sweeps_max=non_fused["rb_sor_sweeps_max"])

    t = time.perf_counter()
    phase_reference(device)
    spmd_reference(device)
    torch.cuda.synchronize()
    log(f"phase reference: {time.perf_counter() - t:.1f} s")

    # phase 8: its launches are printed here and kept out of the table
    t = time.perf_counter()
    cli_persistence = dict(cli_hybrid=phase_cli_hybrid(device), resume=phase_resume(device),
                           model_parts=phase_model_parts(device))
    torch.cuda.synchronize()
    log(f"phase CLI and persistence: {time.perf_counter() - t:.1f} s")
    log(f"phase CLI and persistence record: {json.dumps(cli_persistence)}")

    # phase 9: its main path (9b) joins the kernels line's launches
    t = time.perf_counter()
    by_path["adapter_hybrid"], adapter = phase_adapter_hybrid(device)
    decomposed = dict(
        native_dat=phase_native_dat(adapter.pop("warm_var"), cli_persistence["cli_hybrid"]),
        adapter_hybrid=adapter, spmd_sweep=phase_spmd_sweep(device),
        dp_training=phase_dp_training(device))
    torch.cuda.synchronize()
    log(f"phase decomposed workflow: {time.perf_counter() - t:.1f} s, launches "
        f"{by_path['adapter_hybrid']}")
    log(f"phase decomposed workflow record: {json.dumps(decomposed, default=str)}")

    def launches(kernel):
        counts = {path: c[kernel] for path, c in by_path.items()}
        return dict(launches=sum(counts.values()), launches_by_path=counts)

    # the fused row's numbers are the 400x400 multigrid gate's (the fine
    # phases' shape); every gate is under "gates"
    fused_main = next(g for g in fused if g["gate"].startswith("b BFS 400x400 multigrid"))
    rows = [
        dict(name="rb_sor_pressure", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/rb_sor.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_kernels.py:136",
             library_ms=None, **launches("rb_sor_pressure"),
             warp_calls=launches("rb_sor_warp_calls")["launches"], **kernels["12x12"],
             **row1_main),
        # launches: kernels run (a replay counts its graph's kernels);
        # replays: graph launches
        dict(name="mg_vcycle_pressure", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/mg_vcycle.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_mg.py:415",
             library_ms=None, **launches("mg_vcycle_pressure"),
             replays=launches("mg_vcycle_replays")["launches"], **kernels["400x400"]),
        dict(name="fused_step", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/fused_step.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_step.py:414",
             library_ms=None, **launches("fused_step"),
             **{k: fused_main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "launches_per_call",
                                           "vcycles_per_call", "staged_ms",
                                           "staged_launches_per_call",
                                           "momentum_reads_per_call",
                                           "staged_momentum_reads_per_call")},
             momentum_pass=mom_rows["fused_step_momentum"], gates=fused),
        # row 3 over a case axis: ms, plain_ms and bound_ms are the
        # PLAIN_K gate's (7 cases at 10^2, the same inputs); sweep: each size's
        # sweep, with its K=500 launch of all 8 cases timed in turns with
        # one single-case launch
        dict(name="fused_step_batched", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/fused_step.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_step.py:414",
             library_ms=None, **launches("fused_step_batched"), **batched_row, sweep=sweep_train["report"], train=sweep_train["train"],
             path_gates=sweep_train["gates"]),
        # ms: the wrapper's one-pass call with its host read; pass_alone_ms:
        # the fused pass alone (CUDA events over 100 launches)
        dict(name="tiled_momentum", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/mom_pass.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_momentum.py:222",
             library_ms=None, **launches("tiled_momentum"),
             **mom_rows["tiled_momentum"],
             gates=[g for g in mom_rows["momentum_gates"]]),
        # ms: the fused pass's wrapper call; staged_ms: its staged form's
        # (stream_mg.cu and mg_vcycle.cu's stages), timed in turns
        dict(name="stream_pass_a", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/stream_pass.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_stream.py:168",
             library_ms=None, **launches("stream_pass_a"), **big_rows["stream_pass_a"],
             gates=[g for g in big_gates if g["gate"].startswith("stream")]),
        dict(name="stream_pass_b", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/stream_pass.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_stream.py:332",
             library_ms=None, **launches("stream_pass_b"), **big_rows["stream_pass_b"]),
        dict(name="stream_level1_correction", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/mg_vcycle.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_stream.py:298",
             library_ms=None, **launches("stream_level1"),
             replays=launches("stream_level1_replays")["launches"],
             **big_rows["stream_level1"]),
        # ms, plain_ms and bound_ms are per sweep at 2048^2 (kernel alone)
        dict(name="tiled_rb_pressure", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/shard_rb.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_tiled.py:198",
             library_ms=None, **launches("tiled_rb_pressure"), **tiled_row),
        # ms, plain_ms and bound_ms are per call at kb=8 on a 256-row band
        # of the 2048^2 field (8 ranks' split)
        dict(name="shard_rb_pressure", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/shard_rb.cu",
             replaces="sr_for_cfd_tpu/parallel/spmd_pallas.py:93",
             library_ms=None, **launches("shard_rb_pressure"), **shard_row),
    ]
    # calls on the main paths (in the unit of "ms": a path's launches over
    # the launches of the gate's call) and the time they lose against the
    # bound; the order of the next redesign
    for row in rows:
        row["calls"] = row["launches"] / row["launches_per_call"]
        row["lost_s"] = row["calls"] * (row["ms"] - row["bound_ms"]) / 1e3
    # row 1: Lost at the main path's sweeps per call (the gate's 64 is a
    # third of them)
    row = {r["name"]: r for r in rows}
    row1 = row["rb_sor_pressure"]
    row1["lost_s"] = row1["calls"] * (row1["main_ms"] - row1["main_bound_ms"]) / 1e3
    # row 3's own time: its call less the V-cycles (row 2's graph replays)
    # inside it, each at one row 2 cycle's call time from this run; its
    # calls counted, as a gate call's launches (its solves' no-op launches
    # included) need not be a main-path call's
    fused_row, mg = row["fused_step"], kernels["400x400"]
    # the batched launches count as fused-step calls too; they are row 3
    # over a case axis, whose Lost is worked out below
    fused_row["calls"] = sum(c["fused_step_calls"] - c["fused_step_batched"]
                             for c in by_path.values())
    fused_row["lost_s"] = fused_row["calls"] * (fused_row["ms"] - fused_row["bound_ms"]) / 1e3
    cycle_ms = mg["ms"] / mg["cycles"]
    fused_row["vcycle_call_ms"] = cycle_ms
    fused_row["own_ms"] = fused_row["ms"] - fused_row["vcycles_per_call"] * cycle_ms
    fused_row["own_lost_s"] = fused_row["calls"] * (fused_row["own_ms"]
                                                    - fused_row["bound_ms"]) / 1e3
    log(f"  fused_step: {fused_row['vcycles_per_call']} V-cycles per call at {cycle_ms:.5f} "
        f"ms each: own time {fused_row['own_ms']:.5f} of {fused_row['ms']:.5f} ms, own Lost "
        f"{fused_row['own_lost_s']:.4f} s of {fused_row['lost_s']:.4f}")
    # row 4: its calls are the passes run (a batch after the exit adds
    # no-op launches); Lost also for the pass alone
    mom = row["tiled_momentum"]
    mom["sweeps"] = sum(c["tiled_momentum_sweeps"] for c in by_path.values())
    mom["host_reads"] = sum(c["tiled_momentum_reads"] for c in by_path.values())
    mom["calls"] = mom["sweeps"] / 3
    mom["lost_s"] = mom["calls"] * (mom["ms"] - mom["bound_ms"]) / 1e3
    mom["alone_lost_s"] = mom["calls"] * (mom["pass_alone_ms"] - mom["bound_ms"]) / 1e3
    # row 5: its calls are the sweeps run (a batch after the exit adds
    # no-op launches); Lost also at the loop's time per sweep
    # the batched launch's Lost at the sweep's own launches: the K=500
    # launch of 8 cases at 10^2 and 50^2 from the final fields
    batched = row["fused_step_batched"]
    rep = sweep_train["report"]
    batched["lost_s"] = sum(rep[n]["launches"]["fused_step_batched"]
                            * (rep[n]["batched_ms"] - rep[n]["batched_bound_ms"])
                            for n in (SWEEP_LR, SWEEP_MID)) / 1e3
    tiled = row["tiled_rb_pressure"]
    tiled["sweeps"] = by_path["tiled"]["tiled_rb_sweeps"]
    tiled["host_reads"] = by_path["tiled"]["tiled_rb_reads"]
    tiled["calls"] = tiled["sweeps"]
    tiled["lost_s"] = tiled["calls"] * (tiled["ms"] - tiled["bound_ms"]) / 1e3
    tiled["loop_lost_s"] = tiled["calls"] * (tiled["loop_ms_per_sweep"]
                                             - tiled["bound_ms"]) / 1e3
    dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
