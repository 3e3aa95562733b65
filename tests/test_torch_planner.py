"""The port's link model and planner (`parallel/comm_budget.py`,
`parallel/planner.py`) against the JAX package's, on the same inputs and
without processes: the census is given (`CENSUS`, the port's census of the
32^2 QUICK sweeps step on four ranks; `tests/test_torch_domain.py` holds
such censuses to JAX's), so each function is held to JAX's on its own
arithmetic, to 1e-12. `plan_case` gets its census through the JAX
planner's `spmd_chunk_census` (replaced here by the given census) and the
port's `censuses`. The three faults that `ADVICE.md` records in the JAX
planner are not copied: a plan with no feasible count keeps its
one-device row, a measurement of `iters` steps rounds up to a multiple of
`steps_per_kernel`, and a measured ms/step names where it was measured.
"""

import pytest
import torch

torch.set_num_threads(1)

TRIPS = {"u": 4.0, "v": 4.0, "p": 2.0}
# (name, payload bytes, calls a trip): the step, then the u, v, p loops
CENSUS = ([("ppermute", 1920, 4), ("ppermute", 136, 6), ("ppermute", 1024, 2),
           ("psum", 12, 1)],
          [("ppermute", 408, 2), ("psum", 4, 1)],
          [("ppermute", 408, 2), ("psum", 4, 1)],
          [("ppermute", 1088, 4), ("psum", 4, 1)])
SMALL = dict(nx=32, ny=16, dt=2e-3, scheme="QUICK", dtype="float32", inner_max_iter=8,
             pressure_solver="multigrid")
INFLATION_CASES = {
    "sweeps_400": dict(nx=400, ny=400, Re=1050.0),
    "multigrid_400": dict(nx=400, ny=400, Re=1050.0, pressure_solver="multigrid"),
    "upwind_64_mce3": dict(nx=64, ny=48, scheme="UPWIND", momentum_check_every=3),
}


def _census(module):
    """`CENSUS` as `module`'s LoopCensus (the JAX package's or the port's)."""
    def sites(rows):
        return tuple(module.Site(*r) for r in rows)

    return module.LoopCensus(sites(CENSUS[0]),
                             tuple(module.LoopCensus(sites(r), ()) for r in CENSUS[1:]))


def _cases(**kw):
    """(JAX case, port case) of the lid-driven cavity, built alike and
    without a solver's fields."""
    import sr_for_cfd_tpu.config as jc
    import sr_for_cfd_tpu_torch.config as tc

    pair = []
    for c in (jc, tc):
        k = dict(kw)
        mesh = c.MeshParameters(nx=k.pop("nx"), ny=k.pop("ny"), lx=1.0, ly=1.0)
        fluid = c.FluidProperties(Re=k.pop("Re", 100.0), rho=1.0)
        pair.append(c.CaseConfig.build(mesh, fluid, c.SolverSettings.make(**k),
                                       c.BoundaryConditions.lid_driven_cavity()))
    return pair


def _close(a, b, key=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), key
        for k in a:
            _close(a[k], b[k], f"{key}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), key
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{key}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-12, abs=1e-300), key
    else:
        assert a == b, key


@pytest.mark.parametrize("name", sorted(INFLATION_CASES))
def test_ca_compute_inflation_matches_jax(name):
    import sr_for_cfd_tpu.parallel.comm_budget as jb
    import sr_for_cfd_tpu_torch.parallel.comm_budget as tb

    jcase, tcase = _cases(**INFLATION_CASES[name])
    trips = {"u": 3.0, "v": 3.0, "p": 48.0}
    for n in (1, 2, 4, 8):
        _close(tb.ca_compute_inflation(tcase, n, trips),
               jb.ca_compute_inflation(jcase, n, trips), f"n={n}")


def test_traffic_and_scaling_match_jax():
    """`step_traffic` (with and without the cadence conversion),
    `predict_scaling` at explicit link parameters and each count, and
    `effective_momentum_cadence` on a plain and a big-grid case."""
    import sr_for_cfd_tpu.parallel.comm_budget as jb
    import sr_for_cfd_tpu_torch.parallel.comm_budget as tb

    jcase, tcase = _cases(**SMALL)
    jc, tc = _census(jb), _census(tb)
    assert tc.per_trip_by_kind() == jc.per_trip_by_kind()
    for jcase_n, tcase_n in ((None, None), (jcase, tcase)):
        jt = jb.step_traffic(jc, TRIPS, jcase_n)
        tt = tb.step_traffic(tc, TRIPS, tcase_n)
        _close(tt, jt)
    for n in (2, 4, 8):
        for infl in (1.0, 1.37):
            _close(tb.predict_scaling(0.27, tt, n, tb.IciParams(5e10, 1e-6),
                                      compute_inflation=infl),
                   jb.predict_scaling(0.27, jt, n, jb.IciParams(5e10, 1e-6),
                                      compute_inflation=infl))
    big = dict(nx=3072, ny=3072, use_pallas=True, dtype="float32",
               pressure_solver="multigrid")
    for kw in (SMALL, big, dict(big, momentum_check_every=5)):
        jcase, tcase = _cases(**kw)
        assert tb.effective_momentum_cadence(tcase) == jb.effective_momentum_cadence(jcase)


def test_link_defaults_are_not_the_tpu_s():
    """The port's defaults are the H100's NVLink parameters, not JAX's
    TPU v5e ICI; the fields are JAX's."""
    import sr_for_cfd_tpu.parallel.comm_budget as jb
    import sr_for_cfd_tpu_torch.parallel.comm_budget as tb

    assert tb.IciParams()._fields == jb.IciParams()._fields
    assert tb.IciParams() == (4.5e11, 3e-6)
    assert all(a != b for a, b in zip(tb.IciParams(), jb.IciParams()))


def test_measured_inner_trips_match_jax():
    """float64: the mean inner sweeps per step of the single-device
    solvers, equal."""
    import sr_for_cfd_tpu.parallel.comm_budget as jb
    from sr_for_cfd_tpu.solver.cases import make_cavity_solver as jax_cavity
    import sr_for_cfd_tpu_torch.parallel.comm_budget as tb
    from sr_for_cfd_tpu_torch.solver.cases import make_cavity_solver

    kw = dict(Re=100, nx=16, ny=16, dt=2e-3, scheme="UPWIND", dtype="float64")
    got = tb.measured_inner_trips(make_cavity_solver(device="cpu", **kw).case, n_steps=2,
                                  device="cpu")
    assert got == jb.measured_inner_trips(jax_cavity(**kw).case, n_steps=2)


@pytest.fixture(scope="module")
def plans():
    """(JAX plan, port plan) for ms/step 0.05 and 500 at JAX's link
    parameters and 1.0 at slower ones (a fused case), counts 1, 2 and 4,
    the given census."""
    import dataclasses

    import sr_for_cfd_tpu.parallel.comm_budget as jb
    import sr_for_cfd_tpu.parallel.planner as jp
    import sr_for_cfd_tpu_torch.parallel.comm_budget as tb
    import sr_for_cfd_tpu_torch.parallel.planner as tp

    jcase, tcase = _cases(**SMALL)
    fused_j, fused_t = (dataclasses.replace(c, settings=dataclasses.replace(
        c.settings, fused_step=True)) for c in (jcase, tcase))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "spmd_chunk_census", lambda case, mesh: _census(jb))
        for name, ms, params, (jcase_n, tcase_n) in (
                ("fast", 0.05, tuple(jb.IciParams()), (jcase, tcase)),
                ("slow", 500.0, tuple(jb.IciParams()), (jcase, tcase)),
                ("slow_link", 1.0, (5e9, 1e-5), (fused_j, fused_t))):
            out[name] = (
                jp.plan_case(jcase_n, ms_single=ms, device_counts=(1, 2, 4), trips=TRIPS,
                             params=jb.IciParams(*params)),
                tp.plan_case(tcase_n, ms_single=ms, device_counts=(1, 2, 4), trips=TRIPS,
                             params=tb.IciParams(*params),
                             censuses={2: _census(tb), 4: _census(tb)}, device="cpu"))
    return out


@pytest.mark.parametrize("name", ["fast", "slow", "slow_link"])
def test_plan_case_matches_jax(plans, name):
    """Every row (bound_by included), the recommendation and the text of
    `format_plan`; the fused case plans on its unfused twin."""
    from sr_for_cfd_tpu.parallel.planner import format_plan as jax_format
    from sr_for_cfd_tpu_torch.parallel.planner import format_plan

    want, got = plans[name]
    _close(got, want)
    assert format_plan(got) == jax_format(want)
    assert got["ms_per_step_source"] == "caller-provided"


def test_no_feasible_count_keeps_the_one_device_row():
    """JAX's plan_case takes the min of an empty list when no count is
    feasible (`ADVICE.md`, planner.py:213); the port keeps the one-device
    row and recommends it, the infeasible counts with their reasons."""
    import sr_for_cfd_tpu.parallel.planner as jp
    import sr_for_cfd_tpu_torch.parallel.planner as tp

    jcase, tcase = _cases(**SMALL)
    with pytest.raises(ValueError):
        jp.plan_case(jcase, ms_single=1.0, device_counts=(3,), trips=TRIPS)
    plan = tp.plan_case(tcase, ms_single=1.0, device_counts=(3, 16), trips=TRIPS,
                        device="cpu")
    by_n = {r["n_devices"]: r for r in plan["rows"]}
    assert sorted(by_n) == [1, 3, 16] and by_n[1]["feasible"]
    assert "not divisible by 3" in by_n[3]["reason"]
    assert "no census for 16 ranks" in by_n[16]["reason"]
    assert plan["recommended_devices"] == 1
    assert plan["recommendation"].startswith("stay single-chip")


def test_measurement_rounds_iters_up_and_names_its_device():
    """`iters` that `steps_per_kernel` does not divide (`ADVICE.md`,
    planner.py:63) is rounded up, so the fused case measures; a measured
    time names where it was measured (`ADVICE.md`, cli.py:340)."""
    import sr_for_cfd_tpu_torch.parallel.planner as tp

    _, fused = _cases(nx=10, ny=10, dt=2e-3, scheme="UPWIND", dtype="float32",
                      fused_step=True, steps_per_kernel=4, chunk_size=8)
    assert tp.measure_single_chip_ms(fused, iters=6, reps=1, device="cpu") > 0
    _, plain = _cases(nx=8, ny=8, dt=2e-3, scheme="UPWIND", dtype="float64")
    plan = tp.plan_case(plain, device_counts=(1,), trips=TRIPS, device="cpu")
    assert plan["ms_per_step_source"] == "measured live on cpu"
    assert plan["single_chip_ms_per_step"] > 0
