#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sr_for_cfd_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, each ending in `torch.cuda.synchronize()` so that a fault shows
where it happened; any failure ends the run with a non-zero exit code and
no result line:

1. build: compile `sr_for_cfd_tpu_torch/csrc/*.cu` with nvcc (ptxas report
   printed) and load the library.
2. kernels: each CUDA kernel against its plain PyTorch version on the same
   seeded inputs on the card: the red-black SOR pressure loop at 12x12 (the
   hybrid's coarse grid) and 402x402 (max_iter 64), the V-cycle loop at
   400x400 with the BFS spacing (3 cycles). Max abs difference, counts,
   kernel and plain times (CUDA events, after a warm-up).
3. main path: `run_hybrid_experiment` for the BFS Re=400 hybrid at full
   width: 10x10 coarse solve (red-black SOR kernel), the shipped 10->400
   autoencoder, warm and cold 400x400 fine solves (V-cycle kernel), with
   iteration budgets of 2000 / 100 / 100. Kernel launch counters are set to
   0 just before and read just after; each kernel must have launched in
   its phase.
4. reference: the same hybrid configuration at a small size (BFS 10x10
   coarse, bicubic SR, 32x32 fine) on the card and with the plain PyTorch
   path on the CPU; the fine fields must agree.

The last lines are a `{"kernels": [...]}` line, the card's name and power
limit as nvidia-smi prints them, and `{"ok": true, "device": {...}}`.
"""

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


def cuda_ms(fn, reps):
    """Mean ms per call of fn() over `reps` calls, CUDA events, after one
    warm-up call."""
    import torch

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
    band = {id(bm): int((bm.hi - bm.lo).sum().item()) for bm in mats}
    nbytes = wrapper_bytes(n0, m0) + sum(4 * band[id(bm)] + 8 * bm.lo.numel()
                                         for bm in mats)
    flops = (FLOP_RESID_CELL + FLOP_SUMSQ_CELL) * n0 * m0  # the fine rms
    for lvl, (n, m) in enumerate(sizes):
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
    return nbytes, flops * cycles


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


def check_pair(name, out_k, n_k, out_p, n_p):
    import torch

    err = float(torch.max(torch.abs(out_k - out_p)).item())
    scale = float(torch.max(torch.abs(out_p)).item())
    ok = math.isfinite(err) and err <= REL_TOL * max(1.0, scale) and n_k == n_p
    log(f"  {name}: max_abs_err={err:.3e} (tol {REL_TOL:g} x {max(1.0, scale):.3e}) "
        f"count kernel={n_k} plain={n_p}")
    if not ok:
        fail(f"{name}: kernel and plain version disagree")
    return err


def phase_kernels(device):
    import numpy as np
    import torch

    from sr_for_cfd_tpu_torch.ops.mg_kernels import (
        mg_solve_pressure_kernel,
        plan_hierarchy,
    )
    from sr_for_cfd_tpu_torch.ops.multigrid import mg_solve_pressure
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import (
        solve_pressure_kernel,
        solve_pressure_plain,
    )

    rng = np.random.default_rng(1234)
    results = {}
    # red-black SOR: the hybrid's coarse grid (10x10 interior, BFS domain)
    # and a 402x402 padded field (the multi-block path); fixed 64 sweeps
    for label, n in (("12x12", 10), ("402x402", 400)):
        p, ff, geo = seeded_problem(rng, n, n, 10.0, 3.0, device)
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
                              bound_ms=b_ms, bound_by=b_by)
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
    results["400x400"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                              bound_ms=b_ms, bound_by=b_by)
    return results


def finite_fields(solver):
    import torch

    s = solver.state
    return all(bool(torch.isfinite(t).all().item()) for t in (s.u, s.v, s.p))


def _main_path(run_hybrid_experiment, out_dir, device):
    """The BFS Re=400 hybrid as a user runs it; launch counters set to 0
    just before."""
    from sr_for_cfd_tpu_torch.ops.mg_kernels import mg_solve_pressure_kernel
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import solve_pressure_kernel

    solve_pressure_kernel.launches = 0
    mg_solve_pressure_kernel.launches = 0
    return run_hybrid_experiment(
        Re=400, lr_dim=10, hr_dim=400, dt=2e-3, scheme="UPWIND", case="bfs",
        max_iterations_coarse=2000, max_iterations_ml=100,
        max_iterations_normal=100, model_file=MODEL_FILE,
        stats_file=STATS_FILE, output_dir=out_dir,
        verbose=False, save_results=False, dtype="float32",
        use_pallas=True, pressure_solver="multigrid", fused_step=False,
        coarse_overrides={"pressure_solver": "sweeps", "use_pallas": True,
                          "fused_step": False},
        device=device,
    )


def phase_main_path(device):
    import torch

    from sr_for_cfd_tpu_torch.ops.mg_kernels import mg_solve_pressure_kernel
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import solve_pressure_kernel
    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    for path in (MODEL_FILE, STATS_FILE):
        if not os.path.exists(path):
            fail(f"missing {path}")
    with tempfile.TemporaryDirectory(prefix="srcfd_") as out_dir:
        res = _main_path(run_hybrid_experiment, out_dir, device)
    torch.cuda.synchronize()
    totals = {"rb_sor_pressure": solve_pressure_kernel.launches,
              "mg_vcycle_pressure": mg_solve_pressure_kernel.launches}
    for phase in ("coarse", "ml", "normal"):
        n = res[f"{phase}_iterations"]
        t = res[f"{phase}_time"]
        log(f"  phase {phase}: {n} iterations, {t:.3f} s, "
            f"{1e3 * t / max(n, 1):.3f} ms/iter, launches {res['kernel_launches'][phase]}")
    solvers = res["solvers"]
    log(f"  warm (ML) final rms {solvers['ml'].state.rms.tolist()}; "
        f"cold rms at {res['normal_iterations']} iterations "
        f"{solvers['normal'].state.rms.tolist()}")
    log(f"  centerline diff warm vs cold: {res['centerline_diff']}")
    for name, s in solvers.items():
        if not finite_fields(s):
            fail(f"non-finite fields after the {name} phase")
    hr = res["hr_fields"]
    if any(hr[c].shape != (400, 400) for c in "uvp"):
        fail("SR output has the wrong shape")
    launches = res["kernel_launches"]
    if launches["coarse"]["rb_sor_pressure"] <= 0:
        fail("the SOR kernel did not launch in the coarse phase")
    if launches["ml"]["mg_vcycle_pressure"] <= 0 or \
            launches["normal"]["mg_vcycle_pressure"] <= 0:
        fail("the V-cycle kernel did not launch in a fine phase")
    return totals


def phase_reference(device):
    """The main path's configuration at a small size on the card (kernels)
    and on the CPU (plain PyTorch): the fine fields must agree."""
    import numpy as np

    from sr_for_cfd_tpu_torch.workflow.hybrid import run_hybrid_experiment

    kw = dict(Re=400, lr_dim=10, hr_dim=32, dt=2e-3, scheme="UPWIND",
              case="bfs", max_iterations_coarse=100, max_iterations_ml=20,
              max_iterations_normal=20, verbose=False, save_results=False,
              dtype="float32", use_pallas=True, pressure_solver="multigrid",
              coarse_overrides={"pressure_solver": "sweeps",
                                "use_pallas": True})
    gpu = run_hybrid_experiment(device=device, **kw)
    cpu = run_hybrid_experiment(device="cpu", **kw)
    worst = 0.0
    for phase in ("coarse", "ml", "normal"):
        if gpu[f"{phase}_iterations"] != cpu[f"{phase}_iterations"]:
            fail(f"reference: {phase} iteration counts differ")
        a = gpu["solvers"][phase].interior_fields()
        b = cpu["solvers"][phase].interior_fields()
        for c in "uvp":
            err = float(np.max(np.abs(a[c] - b[c])))
            scale = max(1.0, float(np.max(np.abs(b[c]))))
            worst = max(worst, err / scale)
            if not (np.all(np.isfinite(a[c])) and err <= 1e-4 * scale):
                fail(f"reference: {phase} {c} differs by {err:.3e}")
    log(f"  small hybrid card vs CPU: worst relative field difference {worst:.3e}")


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

    t = time.perf_counter()
    kernels = phase_kernels(device)
    torch.cuda.synchronize()
    log(f"phase kernels: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches = phase_main_path(device)
    torch.cuda.synchronize()
    log(f"phase main path: {time.perf_counter() - t:.1f} s, launches {launches}")

    t = time.perf_counter()
    phase_reference(device)
    torch.cuda.synchronize()
    log(f"phase reference: {time.perf_counter() - t:.1f} s")

    rows = [
        dict(name="rb_sor_pressure", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/rb_sor.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_kernels.py:136",
             launches=launches["rb_sor_pressure"], library_ms=None,
             **kernels["12x12"]),
        dict(name="mg_vcycle_pressure", route="cuda",
             source="sr_for_cfd_tpu_torch/csrc/mg_vcycle.cu",
             replaces="sr_for_cfd_tpu/ops/pallas_mg.py:415",
             launches=launches["mg_vcycle_pressure"], library_ms=None,
             **kernels["400x400"]),
    ]
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
