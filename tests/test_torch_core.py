"""The port's config, state, boundary conditions, stencils and sweeps
against the JAX package, in float64 at <= 24x24.

Inputs are made from a seed with numpy and fed to both packages. The port
keeps the JAX package's operation order, so float64 results agree to a few
ulp: tolerance 1e-12 absolute on O(1) values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu import config as jcfg
from sr_for_cfd_tpu.ops import bc as jbc
from sr_for_cfd_tpu.ops import stencil as jst
from sr_for_cfd_tpu.ops import sweeps as jsw
from sr_for_cfd_tpu.solver import state as jstate
from sr_for_cfd_tpu_torch import config as tcfg
from sr_for_cfd_tpu_torch.ops import bc as tbc
from sr_for_cfd_tpu_torch.ops import stencil as tst
from sr_for_cfd_tpu_torch.ops import sweeps as tsw
from sr_for_cfd_tpu_torch.solver import state as tstate

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

ATOL = 1e-12


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _bfs_case(mod, nx=12, ny=10, **kw):
    mesh = mod.MeshParameters(nx=nx, ny=ny, lx=10.0, ly=3.0)
    settings = mod.SolverSettings.make(dt=2e-3, scheme="UPWIND",
                                       dtype="float64", **kw)
    return mod.CaseConfig.build(mesh, mod.FluidProperties(Re=400), settings,
                                mod.BoundaryConditions.bfs(),
                                bfs=mod.BFSGeometry())


def test_settings_validation_matches_jax():
    good = dict(dt=2e-3, scheme="UPWIND", relaxation_factors={"u": 0.5})
    assert (dataclasses.asdict(tcfg.SolverSettings.make(**good))
            == dataclasses.asdict(jcfg.SolverSettings.make(**good)))
    for bad in (dict(scheme="CENTRAL"), dict(inner_scheme="sor"),
                dict(pressure_solver="fft"), dict(use_pallas=True, dtype="float64"),
                dict(steps_per_kernel=2), dict(rre_every=10, rre_depth=1),
                dict(mg_slab_rows=8)):
        for mod in (jcfg, tcfg):
            with pytest.raises(ValueError):
                mod.SolverSettings.make(**bad)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-rank gloo world for the row-decomposed solver's checks."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kw,where", [
    (dict(spmd_devices=2), "single-device step"),
    (dict(pressure_solver="tiled"), "SpmdSolver"),
    (dict(spmd_devices=2, pressure_solver="multigrid"), "SpmdSolver"),
])
def test_unported_settings_are_refused(kw, where, one_rank_group):
    """spmd_devices > 1 builds in both packages; the single-device solver
    refuses to step it, and SpmdSolver refuses pressure_solver='tiled' and
    a group whose size is not spmd_devices, with the JAX package's texts
    (a one-rank group against a one-device mesh)."""
    from sr_for_cfd_tpu.parallel.mesh import make_mesh
    from sr_for_cfd_tpu.parallel.spmd_step import SpmdSolver as JaxSpmd
    from sr_for_cfd_tpu.solver import simple as jsimple

    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver
    from sr_for_cfd_tpu_torch.solver import simple as tsimple

    def build(mod):
        return mod.CaseConfig.build(mod.MeshParameters(nx=16, ny=16),
                                    mod.FluidProperties(), mod.SolverSettings.make(**kw),
                                    mod.BoundaryConditions())

    j_case, t_case = build(jcfg), build(tcfg)
    if where == "single-device step":
        with pytest.raises(ValueError) as j:
            jsimple.simple_step(jstate.init_state(j_case), j_case,
                                jstate.inlet_profile(j_case))
        with pytest.raises(ValueError) as t:
            tsimple.simple_step(tstate.init_state(t_case, "cpu"), t_case, None)
    else:
        with pytest.raises(ValueError) as j:
            JaxSpmd(j_case, make_mesh(1, "x"))
        with pytest.raises(ValueError) as t:
            SpmdSolver(t_case, device="cpu")
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("kw", [
    dict(fused_step=True, steps_per_kernel=4, chunk_size=100),
    dict(fused_step=True, pressure_solver="multigrid"),
    dict(rre_every=100, chunk_size=1000),
])
def test_fused_and_rre_settings_build(kw):
    """The fused step and RRE are ported: both packages build these."""
    for mod in (jcfg, tcfg):
        mod.CaseConfig.build(mod.MeshParameters(nx=16, ny=16),
                             mod.FluidProperties(), mod.SolverSettings.make(**kw),
                             mod.BoundaryConditions())


@pytest.mark.parametrize("kw,match", [
    (dict(fused_step=True, steps_per_kernel=3, chunk_size=100),
     "must divide chunk_size"),
    (dict(fused_step=True, steps_per_kernel=400, chunk_size=1000),
     "must divide chunk_size"),
    (dict(fused_step=True, steps_per_kernel=2, convergence_hold=3),
     "incompatible with convergence_hold"),
    (dict(fused_step=True, mg_slab_rows=16, pressure_solver="multigrid",
          use_pallas=True), "incompatible with fused_step"),
    (dict(fused_step=True, nx=1000), r"needs ~\d+ MiB"),
])
def test_fused_settings_refused_like_jax(kw, match):
    """Both packages refuse the same fused configurations with the same
    message: the steps_per_kernel cadences and hold, streamed multigrid
    with the fused step, and a fused grid past the size gate of
    `CaseConfig.build` (~935^2)."""
    kw = dict(kw)
    n = kw.pop("nx", 16)
    for mod in (jcfg, tcfg):
        with pytest.raises(ValueError, match=match):
            mod.CaseConfig.build(mod.MeshParameters(nx=n, ny=n),
                                 mod.FluidProperties(), mod.SolverSettings.make(**kw),
                                 mod.BoundaryConditions())


# Settings drawn for the seeded comparison of the two packages' validation:
# every option that a check of `SolverSettings.__post_init__` or
# `CaseConfig.build` reads, with values on both sides of each check.
_SETTING_CHOICES = dict(
    scheme=["QUICK", "UPWIND"],
    pressure_solver=["sweeps", "multigrid", "multigrid", "tiled"],
    dtype=["float32", "float32", "float32", "float64"],
    use_pallas=[False, True],
    fused_step=[False, False, False, True],
    steps_per_kernel=[1, 1, 1, 1, 2, 5],
    chunk_size=[30, 64, 100, 280],
    rre_every=[0, 0, 0, 0, 10, 40],
    rre_depth=[1, 2, 6, 6],
    convergence_hold=[1, 1, 1, 2],
    cauchy_tol=[0.0, 0.0, 1e-3],
    cauchy_check_every=[100, 5000],
    plateau_patience=[0, 0, 5],
    plateau_check_every=[100, 2000],
    mg_slab_rows=[0, 0, 0, 0, 16, 32, 8, -16],
    mg_n_pre=[0, 1, 4, 4, 4],
    mg_n_post=[0, 1, 4, 4, 4],
    spmd_devices=[1, 1, 1, 2],
)
_MESHES = [(16, 16), (1000, 1000), (15, 16), (1201, 1200)]


def _build_outcome(mod, n, kw):
    """('ok', None) or ('refused', message) or ('unported', message)."""
    try:
        mod.CaseConfig.build(mod.MeshParameters(nx=n[0], ny=n[1]),
                             mod.FluidProperties(), mod.SolverSettings.make(**kw),
                             mod.BoundaryConditions())
    except ValueError as e:
        return "refused", str(e)
    except NotImplementedError as e:
        return "unported", str(e)
    return "ok", None


def test_settings_refused_like_jax_seeded():
    """Over 800 seeded draws of settings on 16^2 and 1000^2 meshes (and an
    odd and a past-threshold one), both packages accept the same set and
    raise the same `ValueError` text where both refuse. A configuration the
    port refuses as not yet ported (NotImplementedError) is one that JAX
    accepts, and the message names the ROADMAP item."""
    g = np.random.default_rng(20261017)
    seen = {"ok": 0, "refused": 0, "unported": 0}
    for _ in range(800):
        kw = {k: v[g.integers(len(v))] for k, v in _SETTING_CHOICES.items()}
        n = _MESHES[g.integers(len(_MESHES))]
        j_kind, j_msg = _build_outcome(jcfg, n, kw)
        t_kind, t_msg = _build_outcome(tcfg, n, kw)
        seen[t_kind] += 1
        if t_kind == "unported":
            assert j_kind == "ok", (n, kw, j_msg)
            assert "A11" in t_msg, t_msg
            continue
        assert (t_kind, t_msg) == (j_kind, j_msg), (n, kw)
    assert min(seen["ok"], seen["refused"]) > 20, seen


def test_big_grid_kernel_path_builds_and_routes(monkeypatch):
    """A 1200^2 use_pallas multigrid case builds (past 1.35M cells, as in
    the JAX package's big_grid_pallas rule) and its step sends both
    momentum solves to the tiled momentum kernel and the pressure to the
    streamed V-cycle, with momentum_check_every raised to 3."""
    from sr_for_cfd_tpu_torch.ops import momentum_kernels, stream_kernels
    from sr_for_cfd_tpu_torch.solver import simple as tsimple

    calls = []

    def fake_momentum(phi, old, ff, **kw):
        calls.append(("momentum", kw["check_every"], kw["slab_rows"]))
        return phi, 3

    def fake_pressure(p, ff, **kw):
        calls.append(("pressure", kw["slab_rows"]))
        return p, 1

    monkeypatch.setattr(momentum_kernels, "tiled_solve_momentum", fake_momentum)
    monkeypatch.setattr(stream_kernels, "stream_mg_solve_pressure", fake_pressure)
    settings = tcfg.SolverSettings.make(use_pallas=True,
                                        pressure_solver="multigrid")
    mesh = tcfg.MeshParameters(nx=1200, ny=1200)
    case = tcfg.CaseConfig.build(mesh, tcfg.FluidProperties(), settings,
                                 tcfg.BoundaryConditions())
    assert tcfg.big_grid_kernels(case.settings, case.mesh)
    state = tstate.init_state(case, "cpu")
    _, counts = tsimple.simple_step(state, case, None, with_counts=True)
    assert calls == [("momentum", 3, 256), ("momentum", 3, 256),
                     ("pressure", 256)]
    assert counts == {"u": 3, "v": 3, "p": 1}


def test_tiled_pressure_builds_and_routes(monkeypatch):
    """pressure_solver="tiled" (TPU kernel row 5) is ported: a 16^2 case
    builds, and its step sends the pressure to the tiled sweep's wrapper
    with the settings' tolerance, cap and omega."""
    from sr_for_cfd_tpu_torch.ops import tiled_kernels
    from sr_for_cfd_tpu_torch.solver import simple as tsimple

    calls = []

    def fake_pressure(p, ff, **kw):
        calls.append((kw["tol"], kw["max_iter"], kw["sor"]))
        return p, 7

    monkeypatch.setattr(tiled_kernels, "tiled_solve_pressure", fake_pressure)
    settings = tcfg.SolverSettings.make(pressure_solver="tiled", pressure_sor=1.9,
                                        inner_tolerance=1e-5, inner_max_iter=77)
    case = tcfg.CaseConfig.build(tcfg.MeshParameters(nx=16, ny=16),
                                 tcfg.FluidProperties(), settings,
                                 tcfg.BoundaryConditions())
    state = tstate.init_state(case, "cpu")
    _, counts = tsimple.simple_step(state, case, None, with_counts=True)
    assert calls == [(1e-5, 77, 1.9)]
    assert counts["p"] == 7


@pytest.mark.parametrize("preset", ["lid_driven_cavity", "double_lid_cavity", "bfs"])
def test_boundary_conditions_match_jax(preset, rng):
    jb = getattr(jcfg.BoundaryConditions, preset)()
    tb = getattr(tcfg.BoundaryConditions, preset)()
    a = rng.standard_normal((14, 11))
    for var in "uvp":
        assert dataclasses.asdict(tb.frozen(var)) == dataclasses.asdict(jb.frozen(var))
        _close(tbc.apply_bc(_t(a), tb.frozen(var)),
               jbc.apply_bc(jnp.asarray(a), jb.frozen(var)))


def test_bfs_inlet_matches_jax(rng):
    mesh = jcfg.MeshParameters(nx=12, ny=20, lx=10.0, ly=3.0)
    tmesh = tcfg.MeshParameters(nx=12, ny=20, lx=10.0, ly=3.0)
    jp = jbc.bfs_inlet_profile(mesh, jcfg.BFSGeometry(), dtype=jnp.float64)
    tp = tbc.bfs_inlet_profile(tmesh, tcfg.BFSGeometry(), dtype=torch.float64,
                               device="cpu")
    a = rng.standard_normal((14, 22))
    for k in (0, 1, 2):
        _close(tbc.apply_bfs_inlet(_t(a), k, tp), jbc.apply_bfs_inlet(jnp.asarray(a), k, jp))


def test_init_and_warm_start_state_match_jax(rng):
    jcase, tcase = _bfs_case(jcfg), _bfs_case(tcfg)
    fields = {c: rng.standard_normal((10, 12)) for c in "uvp"}
    for js, ts in ((jstate.init_state(jcase), tstate.init_state(tcase, "cpu")),
                   (jstate.warm_start_state(jcase, fields),
                    tstate.warm_start_state(tcase, fields, "cpu"))):
        for name in ("u", "v", "p", "u_old", "v_old", "p_old"):
            _close(getattr(ts, name), getattr(js, name))
        for f in ("e", "n", "w", "s"):
            _close(getattr(ts.ff, f), getattr(js.ff, f))
        jf, tf = js.interior_fields(), ts.interior_fields()
        for c in "uvp":
            np.testing.assert_allclose(tf[c], jf[c], rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="expected"):
        tstate.warm_start_state(tcase, {c: np.zeros((12, 10)) for c in "uvp"},
                                "cpu")


@pytest.mark.parametrize("make", [
    lambda case: tstate.init_state(case),
    lambda case: tstate.warm_start_state(case, {c: np.zeros((10, 12)) for c in "uvp"}),
    lambda case: tstate.inlet_profile(case),
    lambda case: tbc.bfs_inlet_profile(case.mesh, case.bfs),
], ids=["init_state", "warm_start_state", "inlet_profile", "bfs_inlet_profile"])
def test_state_helpers_default_to_the_card(make):
    """Without a device argument the helpers place tensors on the card, and
    without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        out = make(_bfs_case(tcfg))
        assert (out.u if hasattr(out, "u") else out.u_in).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(_bfs_case(tcfg))


def _fields(rng, nx, ny, dx, dy):
    u, v, p = (rng.standard_normal((nx + 2, ny + 2)) for _ in range(3))
    return ((_t(u), _t(v), _t(p)),
            (jnp.asarray(u), jnp.asarray(v), jnp.asarray(p)),
            tst.face_fluxes(_t(u), _t(v), dx, dy),
            jst.face_fluxes(jnp.asarray(u), jnp.asarray(v), dx, dy))


@pytest.mark.parametrize("nx,ny", [(24, 24), (17, 9)])
def test_stencils_match_jax(nx, ny, rng):
    dx, dy = 1.0 / nx, 0.7 / ny
    volp = dx * dy
    (tu, tv, tp), (ju, jv, jp), tff, jff = _fields(rng, nx, ny, dx, dy)
    for f in ("e", "n", "w", "s"):
        _close(getattr(tff, f), getattr(jff, f))
    _close(tff.divergence_sum(), jff.divergence_sum())
    for tflux, tdiag, jfn in ((tst.upwind_flux, tst.upwind_diag, jst.upwind_convection),
                              (tst.quick_flux, tst.quick_diag, jst.quick_convection)):
        jfc, jap = jfn(ju, jff, volp)
        _close(tflux(tu, tff), jfc)
        _close(tdiag(tff, volp), jap)
    tfd, tapd = tst.diffusion(tu, dx, dy, volp)
    jfd, japd = jst.diffusion(ju, dx, dy, volp)
    _close(tfd, jfd)
    assert tapd == japd
    trc, jrc = tst.rhie_chow_update(tff, tp, 2e-3, 1.0, dx, dy), \
        jst.rhie_chow_update(jff, jp, 2e-3, 1.0, dx, dy)
    for f in ("e", "n", "w", "s"):
        _close(getattr(trc, f), getattr(jrc, f), atol=1e-9)
    for t_out, j_out in zip(tst.project_velocity(tu, tv, tp, 2e-3, 1.0, dx, dy),
                            jst.project_velocity(ju, jv, jp, 2e-3, 1.0, dx, dy)):
        _close(t_out, j_out)
    old = rng.standard_normal((nx, ny))
    _close(tst.residual_sumsq(tu, _t(old)), jst.residual_sumsq(ju, jnp.asarray(old)), atol=1e-10)
    _close(tst.under_relax(tu, _t(old), 0.3), jst.under_relax(ju, jnp.asarray(old), 0.3))
    assert tst.under_relax(tu, _t(old), 1.0) is tu


@pytest.mark.parametrize("scheme", ["UPWIND", "QUICK"])
@pytest.mark.parametrize("inner", ["redblack", "jacobi"])
def test_inner_sweeps_match_jax(scheme, inner, rng):
    """Momentum and pressure solves: same fields, same sweep counts."""
    nx, ny = 16, 12
    dx, dy = 1.0 / nx, 0.8 / ny
    volp = dx * dy
    (tu, _, tp), (ju, _, jp), tff, jff = _fields(rng, nx, ny, dx, dy)
    old = rng.standard_normal((nx, ny)) * 0.1
    kw = dict(scheme=scheme, dx=dx, dy=dy, dt=2e-3, volp=volp, tol=1e-8,
              max_iter=200, inner_scheme=inner, check_every=2)
    t_out, t_n = tsw.solve_momentum(tu, _t(old), tff, nu=torch.tensor(0.01, dtype=torch.float64), **kw)
    j_out, j_n = jsw.solve_momentum(ju, jnp.asarray(old), jff, nu=0.01,
                                    return_count=True, **kw)
    _close(t_out, j_out, atol=1e-10)
    assert t_n == int(j_n)
    pkw = dict(dx=dx, dy=dy, dt=2e-3, rho=1.0, volp=volp, tol=1e-6,
               max_iter=120, inner_scheme=inner, check_every=8, sor=1.7)
    t_out, t_n = tsw.solve_pressure(tp, tff, **pkw)
    j_out, j_n = jsw.solve_pressure(jp, jff, return_count=True, **pkw)
    _close(t_out, j_out, atol=1e-9)
    assert t_n == int(j_n)
    assert tsw.optimal_sor(nx, ny) == jsw.optimal_sor(nx, ny)
