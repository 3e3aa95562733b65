"""Collective-traffic census and link model of the row-decomposed solver (counterpart of `sr_for_cfd_tpu/parallel/comm_budget.py`).

One card cannot measure a multi-card link, but the traffic that would
ride it is fixed by the program. Three kinds of evidence, kept apart:

* the census: what the step's collectives move, loop by loop. The JAX
  package reads it from the jaxpr of its compiled chunk; the port has no
  trace, so it runs the step once and records each collective it really
  makes (`parallel/mesh.census`): one outer step with every inner loop cut
  at a few trips, each loop's records divided by its trips. A
  `ring_exchange` counts as JAX's two `ppermute`s, one a direction, each
  with its payload. Where the port makes other reduction calls than JAX
  (the three residual sums in one `all_reduce`, the Cauchy drift and RRE
  reductions only on the steps that use them), the census reports what the
  port does;
* the trip counts: inner sweeps or V-cycles per outer step, measured on
  the single-device solver (`measured_inner_trips`);
* the link: `IciParams`, bandwidth and hop latency, parameters in one
  place (the name and the plan's JSON keys are JAX's, so that a plan reads
  like JAX's; the defaults are the H100's NVLink, not a measurement).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "Site",
    "LoopCensus",
    "spmd_chunk_census",
    "measured_inner_trips",
    "effective_momentum_cadence",
    "step_traffic",
    "ca_compute_inflation",
    "IciParams",
    "predict_scaling",
]

# census trips of each inner loop: enough to show a trip's traffic, which
# is the same on every trip
CENSUS_TRIPS = 2


class Site(NamedTuple):
    """One collective call site, aggregated by payload: `payload_bytes` is
    the per-rank operand size of one call (for `ppermute`, the bytes a rank
    puts on its link), `calls` how often it runs per trip of its loop."""

    name: str
    payload_bytes: int
    calls: int


class LoopCensus(NamedTuple):
    """The collectives of one loop: `sites` run once per trip, `loops` are
    the nested loops of unknown trip count in program order, whose trips
    the caller supplies (measured) to `step_traffic`."""

    sites: Tuple[Site, ...]
    loops: Tuple["LoopCensus", ...]

    def per_trip_bytes(self) -> int:
        """Bytes per trip from this loop's own sites."""
        return sum(s.payload_bytes * s.calls for s in self.sites)

    def per_trip_calls(self) -> int:
        """Collective calls per trip (each at least one hop of latency)."""
        return sum(s.calls for s in self.sites)

    def per_trip_by_kind(self) -> Dict[str, Tuple[int, int]]:
        """(bytes, calls) per trip split into 'halo' (`ppermute`: a
        neighbour exchange, one hop) and 'reduce' (every other collective:
        ring algorithms whose hops and wire bytes grow with the ranks)."""
        out = {"halo": [0, 0], "reduce": [0, 0]}
        for s in self.sites:
            kind = "halo" if s.name.startswith("ppermute") else "reduce"
            out[kind][0] += s.payload_bytes * s.calls
            out[kind][1] += s.calls
        return {k: (v[0], v[1]) for k, v in out.items()}


def _sites(records, trips: int = 1) -> Tuple[Site, ...]:
    """Records (name, bytes) aggregated into sites per trip."""
    counts: Dict[Tuple[str, int], int] = {}
    for key in records:
        counts[key] = counts.get(key, 0) + 1
    sites = []
    for (name, nbytes), n in counts.items():
        if n % trips:
            raise ValueError(
                f"{name} of {nbytes} B ran {n} times in {trips} trips: the "
                "loop's trips differ, so a trip has no fixed traffic")
        sites.append(Site(name, nbytes, n // trips))
    return tuple(sites)


def spmd_chunk_census(case, mesh, axis: str = "x", device="cuda") -> LoopCensus:
    """Census of one `SpmdSolver` chunk loop: its `sites` are the step's
    own collectives (one trip = one outer step), its `loops` the inner
    solves in program order, u-momentum, v-momentum and pressure (sweeps or
    V-cycles), the keys `measured_inner_trips` measures. Every rank of the
    mesh calls it (the step is run once from the initial state)."""
    from . import mesh as ring
    from .spmd_step import SpmdSolver

    solver = SpmdSolver(case, mesh.axis_group(axis), device=device)
    with ring.census(CENSUS_TRIPS) as rec:
        solver.step()
    if len(rec.loops) != 3:
        raise ValueError(
            f"expected 3 inner loops (u, v, p) in a step, found {len(rec.loops)}: "
            "the step's structure changed; update spmd_chunk_census")
    loops = tuple(LoopCensus(_sites(records, trips), ()) for records, trips in rec.loops)
    return LoopCensus(_sites(rec.top), loops)


def measured_inner_trips(case, n_steps: int = 20, state=None,
                         device="cuda") -> Dict[str, float]:
    """Mean inner sweeps (or V-cycles) per outer step of the single-device
    solver over `n_steps` steps from `state` (fresh fields if None). The
    row-decomposed loops exit on the same counts (tests/test_torch_spmd.py),
    so these are the trips of the census's inner loops."""
    from ..solver.simple import simple_step
    from ..solver.state import init_state, inlet_profile, torch_dtype
    from ..utils.device import resolve_device

    device = resolve_device(device)
    profile = inlet_profile(case, device)
    nu = torch.tensor(case.fluid.nu, dtype=torch_dtype(case), device=device)
    if state is None:
        state = init_state(case, device)
    totals = {"u": 0.0, "v": 0.0, "p": 0.0}
    for _ in range(n_steps):
        state, counts = simple_step(state, case, profile, nu, with_counts=True)
        for k in totals:
            totals[k] += float(counts[k])
    return {k: v / n_steps for k, v in totals.items()}


def effective_momentum_cadence(case) -> int:
    """The momentum check cadence the solver runs: the big-grid momentum
    kernel path checks every 3 sweeps at least (`solver/simple.py`), so its
    sweep counts come in multiples of 3."""
    from ..config import big_grid_kernels

    st = case.settings
    if (big_grid_kernels(st, case.mesh) and st.inner_scheme == "redblack"
            and st.dtype == "float32"):
        return max(3, st.momentum_check_every)
    return st.momentum_check_every


def step_traffic(chunk: LoopCensus, trips: Dict[str, float],
                 case=None) -> Dict[str, float]:
    """Per-rank traffic of one outer step: bytes and collective calls,
    split into 'halo' and 'reduce', from `chunk` (`spmd_chunk_census`) and
    `trips` (`measured_inner_trips`, keys 'u', 'v', 'p'). `trips` counts
    sweeps while a census trip covers `check_every` of them, so `case`
    converts (momentum by `effective_momentum_cadence`; V-cycles are
    trips)."""
    if len(chunk.loops) != 3:
        raise ValueError(
            f"expected 3 inner loops (u, v, p), found {len(chunk.loops)}")
    if case is not None:
        st = case.settings
        p_div = st.pressure_check_every if st.pressure_solver == "sweeps" else 1
        m_div = effective_momentum_cadence(case)
        trips = {"u": trips["u"] / m_div, "v": trips["v"] / m_div,
                 "p": trips["p"] / p_div}
    by_loop = {}
    kinds = chunk.per_trip_by_kind()
    halo_bytes, halo_calls = map(float, kinds["halo"])
    reduce_bytes, reduce_calls = map(float, kinds["reduce"])
    for name, loop in zip(("u", "v", "p"), chunk.loops):
        if loop.loops:
            raise ValueError(
                f"inner loop {name!r} has {len(loop.loops)} nested "
                "unknown-trip loops; extend step_traffic with their counts")
        k = loop.per_trip_by_kind()
        by_loop[name] = {
            "bytes": loop.per_trip_bytes() * trips[name],
            "calls": loop.per_trip_calls() * trips[name],
            "trips": trips[name],
        }
        halo_bytes += k["halo"][0] * trips[name]
        halo_calls += k["halo"][1] * trips[name]
        reduce_bytes += k["reduce"][0] * trips[name]
        reduce_calls += k["reduce"][1] * trips[name]
    return {
        "bytes_per_step": halo_bytes + reduce_bytes,
        "calls_per_step": halo_calls + reduce_calls,
        "halo_bytes_per_step": halo_bytes,
        "halo_calls_per_step": halo_calls,
        "reduce_bytes_per_step": reduce_bytes,
        "reduce_calls_per_step": reduce_calls,
        "step_level_bytes": chunk.per_trip_bytes(),
        "inner": by_loop,
    }


def ca_compute_inflation(case, n_dev: int, trips: Dict[str, float]) -> float:
    """Redundant-compute factor of the communication-avoiding halo
    schedule: a k-sweep block updates `rows + 2 (H - d)` rows a sweep
    instead of `rows` (H = 2k + extra), so per-rank work exceeds
    single-device / n_dev by this factor. Momentum and pressure are
    weighted by the sweeps in `trips` at 2:1 per row (QUICK's convection
    against the 5-point Laplacian); multigrid weights each sharded level's
    smoothing by its cells and charges the replicated tail at n_dev times;
    the transfers are not inflated."""
    from .spmd_step import sweep_blocks

    st = case.settings
    nx, ny = case.mesh.nx, case.mesh.ny
    rows = nx // n_dev

    def block_factor(check_every: int, rows_band: int, d: int, extra: int) -> float:
        k_max = max(1, (rows_band - extra) // 2)
        blocks = sweep_blocks(check_every, k_max)
        ext_rows = sum(kb * (rows_band + 2 * (2 * kb + extra) - 2 * d) for kb in blocks)
        return ext_rows / (check_every * rows_band)

    d_m, extra_m = (2, 1) if st.scheme == "QUICK" else (1, 0)
    infl_m = block_factor(st.momentum_check_every, rows, d_m, extra_m)
    w_m = 2.0 * (trips.get("u", 0.0) + trips.get("v", 0.0))

    if st.pressure_solver == "multigrid":
        from .spmd_mg import plan_spmd_mg

        plan = plan_spmd_mg(nx, ny, case.mesh.dx, case.mesh.dy, case.mesh.volp, n_dev,
                            np.dtype(st.dtype), min_size=st.mg_min_size)
        n_smooth = st.mg_n_pre + st.mg_n_post
        w_p, acc = 0.0, 0.0
        for lvl, (nxl, nyl) in enumerate(plan.setup.sizes):
            w = n_smooth * nxl * nyl * trips.get("p", 0.0)
            if lvl < plan.n_shard:
                # the pre-smoother's residual by-product: the deeper
                # (extra = 2) halo
                f = block_factor(max(st.mg_n_pre, 1), nxl // n_dev, 1, 2)
            else:
                f = float(n_dev)  # replicated tail: the whole level on every rank
            w_p += w
            acc += w * f
        infl_p = acc / max(w_p, 1e-30)
    else:
        infl_p = block_factor(st.pressure_check_every, rows, 1, 0)
        w_p = trips.get("p", 0.0)

    total_w = w_m + w_p
    if total_w <= 0:
        return 1.0
    return (w_m * infl_m + w_p * infl_p) / total_w


class IciParams(NamedTuple):
    """The link model: one-way bytes per second per rank, and the latency
    of one dependent collective hop. The name is the JAX package's (its
    plans key on it); the defaults are the H100 SXM's NVLink 4, not a
    measurement (one card cannot measure a link):

    * `link_bytes_per_s`: NVIDIA's H100 SXM datasheet gives NVLink 900 GB/s
      per GPU, both directions together (18 links of 50 GB/s), so 4.5e11
      B/s one way, which an NVSwitch node gives every pair of GPUs;
    * `hop_latency_s`: NVIDIA publishes no NVLink latency; 3 us is an
      assumed order of a small NCCL point-to-point message between two
      GPUs of one node, launch included.

    Set both from a measurement on a real multi-card node."""

    link_bytes_per_s: float = 4.5e11
    hop_latency_s: float = 3.0e-6


def predict_scaling(
    single_chip_ms_per_step: float,
    traffic: Dict[str, float],
    n_devices: int,
    params: IciParams = IciParams(),
    parallel_fraction: float = 1.0,
    compute_inflation: float = 1.0,
) -> Dict[str, float]:
    """Predicted multi-card step time: Amdahl compute plus link time.

    * halo (`ppermute`): the ring sends each rank's two halos to its two
      neighbours at once, so the bandwidth term is half the payload over
      one link, and each exchange costs one hop;
    * reductions: a ring all-reduce over N ranks moves ~2(N-1)/N of the
      local payload a rank and takes ~2(N-1) dependent hops.

    The terms add (the sweeps wait on their halos): a pessimistic bound.
    `parallel_fraction` discounts work that does not decompose;
    `compute_inflation` charges the halo rows' recompute
    (`ca_compute_inflation`)."""
    compute_s = single_chip_ms_per_step / 1e3 * (
        (1 - parallel_fraction) + parallel_fraction * compute_inflation / n_devices)
    halo_b = traffic.get("halo_bytes_per_step", traffic["bytes_per_step"])
    halo_c = traffic.get("halo_calls_per_step", traffic["calls_per_step"])
    red_b = traffic.get("reduce_bytes_per_step", 0.0)
    red_c = traffic.get("reduce_calls_per_step", 0.0)
    ring_wire = 2.0 * (n_devices - 1) / n_devices
    ring_hops = 2.0 * (n_devices - 1)
    bw_s = (halo_b / 2.0 + red_b * ring_wire) / params.link_bytes_per_s
    lat_s = (halo_c + red_c * ring_hops) * params.hop_latency_s
    total_s = compute_s + bw_s + lat_s
    ideal_s = single_chip_ms_per_step / 1e3 / n_devices
    return {
        "n_devices": n_devices,
        "predicted_ms_per_step": total_s * 1e3,
        "compute_ms": compute_s * 1e3,
        "ici_bandwidth_ms": bw_s * 1e3,
        "ici_latency_ms": lat_s * 1e3,
        "speedup_vs_single": single_chip_ms_per_step / (total_s * 1e3),
        "parallel_efficiency": ideal_s / total_s,
    }
