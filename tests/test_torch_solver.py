"""The port's non-fused SIMPLE step, host loop and detectors against the
JAX package, in float64 on the CPU.

Same inputs, same settings: the fields must agree to float64 rounding
(1e-10 absolute on O(1) fields after hundreds of steps) and every count
must be equal: outer iterations, inner sweeps and V-cycles per step, and
the iteration at which each detector stops the solve.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu.solver import simple as jsimple
from sr_for_cfd_tpu_torch.solver import cases as tcases
from sr_for_cfd_tpu_torch.solver import simple as tsimple

ATOL = 1e-10
# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def _fields_close(js, ts, atol=ATOL):
    jf, tf = js.interior_fields(), ts.interior_fields()
    for c in "uvp":
        np.testing.assert_allclose(tf[c], jf[c], rtol=0, atol=atol)


@pytest.mark.parametrize("case,kw,steps", [
    ("bfs", dict(nx=10, ny=10), 200),
    ("cavity", dict(Re=100, nx=16, ny=16, dt=2e-3), 200),
    ("cavity", dict(Re=100, nx=16, ny=16, dt=2e-3, scheme="UPWIND",
                    pressure_solver="multigrid"), 40),
])
def test_simple_step_matches_jax(case, kw, steps):
    """BFS 10x10 (UPWIND) and cavity 16x16 (QUICK) for 200 outer steps,
    and the multigrid pressure path for 40; inner counts compared step by
    step."""
    make_j = jcases.make_bfs_solver if case == "bfs" else jcases.make_cavity_solver
    make_t = tcases.make_bfs_solver if case == "bfs" else tcases.make_cavity_solver
    kw = dict(kw, dtype="float64")
    sj, st = make_j(**kw), make_t(device="cpu", **kw)
    jstep = jax.jit(functools.partial(jsimple.simple_step, case=sj.case,
                                      profile=sj.profile, with_counts=True))
    js, ts = sj.state, st.state
    for _ in range(steps):
        js, jc = jstep(js)
        ts, tc = tsimple.simple_step(ts, st.case, st.profile, nu=st._nu,
                                     with_counts=True)
        assert {k: int(v) for k, v in jc.items()} == tc
    assert ts.count == int(js.count) == steps
    np.testing.assert_allclose(ts.rms, np.asarray(js.rms), rtol=1e-9)
    _fields_close(js, ts)


@pytest.mark.parametrize("extra,converged", [
    (dict(convergence_criteria={"u": 3e-2, "v": 3e-2, "p": 3e-2},
          convergence_hold=5), True),
    (dict(cauchy_tol=1e-2, cauchy_check_every=20), True),
    (dict(plateau_patience=2, plateau_check_every=20, plateau_rtol=0.5), True),
    (dict(plateau_patience=3, plateau_rtol=0.9), False),  # host-side plateau
])
def test_detector_exits_match_jax(extra, converged):
    """Sustained hold, field-Cauchy drift, device-side and host-side
    plateau: each stops both solvers at the same iteration."""
    kw = dict(Re=100, nx=12, ny=12, dt=5e-3, scheme="UPWIND", dtype="float64",
              max_iterations=300, chunk_size=40, inner_max_iter=40, **extra)
    sj, st = jcases.make_cavity_solver(**kw), tcases.make_cavity_solver(device="cpu", **kw)
    n_j, _ = sj.solve(verbose=False, save_results=False)
    n_t, _ = st.solve(verbose=False, save_results=False)
    assert n_t == n_j < 300
    assert st.state.converged == bool(sj.state.converged) == converged
    assert st.residual_history.iterations == sj.residual_history.iterations
    _fields_close(sj, st)


def test_divergence_is_raised_at_the_same_iteration():
    kw = dict(Re=1e4, nx=8, ny=8, dt=5.0, dtype="float64", max_iterations=200,
              chunk_size=1, inner_max_iter=5)
    sj, st = jcases.make_cavity_solver(**kw), tcases.make_cavity_solver(device="cpu", **kw)
    with pytest.raises(jsimple.DivergenceError):
        sj.solve(verbose=False, save_results=False)
    with pytest.raises(tsimple.DivergenceError):
        st.solve(verbose=False, save_results=False)
    assert st.state.count == int(sj.state.count)


def test_solver_writes_the_dat_artifacts(tmp_path):
    st = tcases.make_cavity_solver(device="cpu", nx=8, ny=8, dtype="float64",
                                   max_iterations=3)
    st.solve(str(tmp_path / "run"), verbose=False, save_results=True)
    assert (tmp_path / "run_full.dat").exists()
    lines = (tmp_path / "run_centerline.dat").read_text().splitlines()
    assert lines[0] == "# Reynolds number: 100" and len(lines) == 4 + 8


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcases.make_cavity_solver(nx=8, ny=8)
