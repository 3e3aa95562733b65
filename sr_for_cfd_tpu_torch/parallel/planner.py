"""Decomposition planner: should a case run row-decomposed, and over how many cards? (counterpart of `sr_for_cfd_tpu/parallel/planner.py`)

Halo exchanges and reductions cost link time, and the communication-
avoiding schedule buys fewer collectives with redundant halo-row
recompute that grows as the bands narrow, so more cards is not always
faster. The planner answers without a multi-card node, from:

* the census of the decomposed step's collectives
  (`comm_budget.spmd_chunk_census`: one step run on n ranks; the command
  line runs it on n gloo CPU ranks in child processes, `census_in_ranks`,
  as NCCL takes one rank a card),
* inner trip counts measured on one device (`measured_inner_trips`),
* the recompute factor (`ca_compute_inflation`),
* the link model (`IciParams`, `predict_scaling`).

`plan_case` returns a row per device count (the one-device row always)
and a recommendation; `python -m sr_for_cfd_tpu_torch.cli plan` is the
command line.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Mapping, Optional, Sequence

import torch

from .comm_budget import (
    IciParams,
    LoopCensus,
    ca_compute_inflation,
    measured_inner_trips,
    predict_scaling,
    spmd_chunk_census,
    step_traffic,
)

CENSUS_TIMEOUT = 600  # seconds for each census rank to finish


def measure_single_chip_ms(case, iters: int = 50, reps: int = 3, device="cuda") -> float:
    """Best-of-`reps` single-device ms per outer step: one `iters`-step
    chunk a rep from a freshly perturbed initial state, after one warm-up
    chunk, ending in a synchronize on the card. `iters` is rounded up to a
    multiple of `steps_per_kernel`, which a chunk must be."""
    from ..solver.simple import run_chunk
    from ..solver.state import init_state, inlet_profile, torch_dtype
    from ..utils.device import resolve_device

    device = resolve_device(device)
    k = case.settings.steps_per_kernel
    iters = k * math.ceil(iters / k)
    bench_case = dataclasses.replace(case, settings=dataclasses.replace(
        case.settings, max_iterations=iters, chunk_size=iters, spmd_devices=1))
    profile = inlet_profile(bench_case, device)
    nu = torch.tensor(bench_case.fluid.nu, dtype=torch_dtype(bench_case), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run_chunk(init_state(bench_case, device), profile, bench_case, iters, nu=nu)
    sync()
    best = float("inf")
    nx, ny = case.mesh.nx, case.mesh.ny
    for rep in range(reps):
        fresh = init_state(bench_case, device)
        fresh.u[nx // 2, ny // 2] += 1e-7 * (rep + 1)
        sync()
        t0 = time.perf_counter()
        state = run_chunk(fresh, profile, bench_case, iters, nu=nu)
        sync()
        best = min(best, (time.perf_counter() - t0) / max(state.count, 1) * 1e3)
    return best


def _census_case(case):
    """The row-decomposable twin of `case`: no fused step (the decomposed
    path runs per-rank kernels instead), one step a call, no declared
    decomposition."""
    return dataclasses.replace(case, settings=dataclasses.replace(
        case.settings, fused_step=False, steps_per_kernel=1, spmd_devices=1))


def _census_on_ranks(case) -> LoopCensus:
    from .mesh import make_mesh

    return spmd_chunk_census(case, make_mesh(axis_name="x"), device="cpu")


def census_in_ranks(case, n: int) -> LoopCensus:
    """`spmd_chunk_census` of `case`'s row-decomposable twin on n gloo CPU
    ranks in child processes (`ranks.run_in_ranks`)."""
    from .ranks import run_in_ranks

    return run_in_ranks(_census_on_ranks, n, _census_case(case), timeout=CENSUS_TIMEOUT)


def _dominant_cost(pred: Dict[str, float], n_dev: int) -> str:
    """Which term keeps this row from ideal scaling: the excess compute
    (halo-row recompute and any part that does not decompose), link
    bandwidth or link latency."""
    ideal = pred["predicted_ms_per_step"] * pred["parallel_efficiency"]
    terms = {
        "recompute": pred["compute_ms"] - ideal,
        "ici_bandwidth": pred["ici_bandwidth_ms"],
        "ici_latency": pred["ici_latency_ms"],
    }
    return max(terms, key=lambda k: terms[k])


def plan_case(
    case,
    ms_single: Optional[float] = None,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    params: IciParams = IciParams(),
    trip_window: int = 6,
    trips: Optional[Dict[str, float]] = None,
    censuses: Optional[Mapping[int, LoopCensus]] = None,
    device="cuda",
) -> dict:
    """Predict the decomposed step time for each device count and
    recommend the fastest.

    `ms_single` is the single-device ms per outer step; None measures it
    on `device` (`measure_single_chip_ms`), and the plan's source names the
    device. `censuses` maps a device count to its census (the command line
    runs each on that many gloo CPU ranks, `census_in_ranks`). A count that
    does not divide the interior rows, or has no census, is an infeasible
    row with its reason; the one-device row is always there, so a plan
    always recommends."""
    from ..utils.device import resolve_device

    device = resolve_device(device)
    if trips is None:
        trips = measured_inner_trips(case, n_steps=trip_window, device=device)
    ms_source = "caller-provided"
    if ms_single is None:
        ms_single = measure_single_chip_ms(case, device=device)
        ms_source = "measured live on " + (
            torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")

    ccase = _census_case(case)
    censuses = censuses or {}
    rows = []
    for n_dev in sorted(set(int(n) for n in device_counts) | {1}):
        if n_dev <= 1:
            rows.append({
                "n_devices": 1,
                "feasible": True,
                "predicted_ms_per_step": ms_single,
                "compute_ms": ms_single,
                "ici_bandwidth_ms": 0.0,
                "ici_latency_ms": 0.0,
                "speedup_vs_single": 1.0,
                "parallel_efficiency": 1.0,
                "collective_calls_per_step": 0.0,
                "ca_compute_inflation": 1.0,
                "bound_by": "compute",
            })
            continue
        if case.mesh.nx % n_dev != 0:
            rows.append({
                "n_devices": n_dev, "feasible": False,
                "reason": f"nx={case.mesh.nx} not divisible by {n_dev} "
                          "(interior-row decomposition)",
            })
            continue
        chunk = censuses.get(n_dev)
        if chunk is None:
            rows.append({
                "n_devices": n_dev, "feasible": False,
                "reason": f"no census for {n_dev} ranks (the cli runs it on "
                          f"{n_dev} gloo CPU ranks unless --no-subprocess)",
            })
            continue
        traffic = step_traffic(chunk, trips, ccase)
        inflation = ca_compute_inflation(ccase, n_dev, trips)
        pred = predict_scaling(ms_single, traffic, n_dev, params=params,
                               compute_inflation=inflation)
        rows.append({
            "feasible": True,
            "collective_calls_per_step": traffic["calls_per_step"],
            "halo_calls_per_step": traffic["halo_calls_per_step"],
            "reduce_calls_per_step": traffic["reduce_calls_per_step"],
            "per_rank_bytes_per_step": traffic["bytes_per_step"],
            "halo_bytes_per_step": traffic["halo_bytes_per_step"],
            "reduce_bytes_per_step": traffic["reduce_bytes_per_step"],
            "ca_compute_inflation": round(inflation, 4),
            "bound_by": _dominant_cost(pred, n_dev),
            **pred,
        })

    feasible = [r for r in rows if r.get("feasible")]
    best = min(feasible, key=lambda r: r["predicted_ms_per_step"])
    n_best = best["n_devices"]
    if n_best == 1:
        slow = [r for r in feasible if r["n_devices"] > 1]
        why = (
            "decomposition is predicted to be a net slowdown at this "
            "size" + (
                f" (best multi-chip row: {min(s['n_devices'] for s in slow)}"
                f"+ dev, bound by {slow[0]['bound_by']})" if slow else ""
            )
        )
    else:
        why = (
            f"predicted {best['speedup_vs_single']:.2f}x vs single chip "
            f"at parallel efficiency "
            f"{best['parallel_efficiency'] * 100:.0f}%, bound by "
            f"{best['bound_by']}"
        )
    return {
        "case": {
            "nx": case.mesh.nx, "ny": case.mesh.ny,
            "scheme": case.settings.scheme,
            "pressure_solver": case.settings.pressure_solver,
            "dtype": case.settings.dtype,
        },
        "single_chip_ms_per_step": ms_single,
        "ms_per_step_source": ms_source,
        "trips_per_step": {k: float(v) for k, v in trips.items()},
        "ici_params": params._asdict(),
        "rows": rows,
        "recommended_devices": n_best,
        "recommendation": (
            ("stay single-chip: " if n_best == 1
             else f"decompose over {n_best} devices (--spmd {n_best}): ")
            + why
        ),
    }


def format_plan(plan: dict) -> str:
    """Human-readable table of a `plan_case` result."""
    c = plan["case"]
    lines = [
        f"decomposition plan: {c['nx']}x{c['ny']} {c['scheme']} "
        f"{c['pressure_solver']} {c['dtype']}",
        f"single-chip {plan['single_chip_ms_per_step']:.3f} ms/step "
        f"({plan['ms_per_step_source']})",
        f"{'dev':>4} {'ms/step':>9} {'speedup':>8} {'eff':>6} "
        f"{'coll/step':>10} {'recompute':>10} bound by",
    ]
    for r in plan["rows"]:
        if not r.get("feasible"):
            lines.append(f"{r['n_devices']:>4} infeasible: {r['reason']}")
            continue
        lines.append(
            f"{r['n_devices']:>4} {r['predicted_ms_per_step']:>9.3f} "
            f"{r['speedup_vs_single']:>7.2f}x "
            f"{r['parallel_efficiency'] * 100:>5.0f}% "
            f"{r['collective_calls_per_step']:>10.0f} "
            f"{r['ca_compute_inflation']:>9.2f}x {r['bound_by']}"
        )
    lines.append("-> " + plan["recommendation"])
    return "\n".join(lines)
