"""The port's whole-step twin (`ops/step_kernels.py`) against the JAX
package's fused Pallas step (`ops/pallas_step.py`, interpret mode on the
CPU, as tests/test_pallas.py runs it), float32.

Same numpy-seeded state into both. Fields agree within 1e-5 absolute and
p within 1e-4, the JAX package's own tolerances for its fused step against
its jnp step (XLA and PyTorch round a few operations differently; the
multigrid mode's transfers are a bf16x3 split on the TPU side and true
float32 here). Every inner count must be equal, so the inner tolerance of
each case is one its loops reach before the float32 residual floor, where
the stall policy's exits are chaotic in both packages: the BFS pressure
(O(1e3) values) uses 1e-3.
"""

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu.solver import simple as jsimple
from sr_for_cfd_tpu_torch.solver import cases as tcases
from sr_for_cfd_tpu_torch.solver import simple as tsimple

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

CASES = {
    "cavity16_quick": ("cavity", dict(Re=100, nx=16, ny=16, dt=2e-3,
                                      scheme="QUICK")),
    "bfs12x10_upwind": ("bfs", dict(Re=400, nx=12, ny=10, dt=2e-3,
                                    scheme="UPWIND", inner_tolerance=1e-3)),
}


def _pair(name, **extra):
    case, kw = CASES[name]
    make_j = jcases.make_bfs_solver if case == "bfs" else jcases.make_cavity_solver
    make_t = tcases.make_bfs_solver if case == "bfs" else tcases.make_cavity_solver
    kw = dict(kw, dtype="float32", fused_step=True, **extra)
    sj, st = make_j(**kw), make_t(device="cpu", **kw)
    rng = np.random.default_rng(11)
    fields = {c: rng.standard_normal((kw["ny"], kw["nx"])) * 0.1 for c in "uvp"}
    sj.warm_start(fields)
    st.warm_start(fields)
    return sj, st


def _close(js, ts):
    for c, atol in (("u", 1e-5), ("v", 1e-5), ("p", 1e-4)):
        np.testing.assert_allclose(getattr(ts, c).numpy(), np.asarray(getattr(js, c)),
                                   rtol=0, atol=atol)
    for c in "enws":
        np.testing.assert_allclose(getattr(ts.ff, c).numpy(),
                                   np.asarray(getattr(js.ff, c)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("mode", ["sweeps", "multigrid"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_step_twin_matches_pallas_step(name, mode, k):
    """One call of K steps: fields, the last step's rms and the inner
    counts summed over the K steps."""
    extra = dict(pressure_solver=mode, steps_per_kernel=k, chunk_size=4 * k)
    if mode == "multigrid":
        extra["mg_coarsest_sweeps"] = 10
    sj, st = _pair(name, **extra)
    js, jc = jsimple.simple_step(sj.state, sj.case, sj.profile, with_counts=True)
    ts, tc = tsimple.simple_step(st.state, st.case, st.profile, nu=st._nu,
                                 with_counts=True)
    assert tc == {key: int(val) for key, val in jc.items()}
    assert ts.count == int(js.count) == k
    np.testing.assert_allclose(ts.rms, np.asarray(js.rms), rtol=1e-4)
    _close(js, ts)


def test_fused_run_chunk_matches_jax():
    """64 steps of a 16x16 cavity as one chunk, 4 steps per call: the
    count, the rms and the fields against `jitted_run_chunk`."""
    kw = dict(Re=100, nx=16, ny=16, dt=2e-3, scheme="QUICK", dtype="float32",
              pressure_solver="sweeps", pressure_sor=1.5, inner_max_iter=16,
              max_iterations=64, chunk_size=64, fused_step=True,
              steps_per_kernel=4)
    sj = jcases.make_cavity_solver(**kw)
    st = tcases.make_cavity_solver(device="cpu", **kw)
    js = jsimple.jitted_run_chunk(sj.state, sj.profile, case=sj.case, n_steps=64)
    ts = tsimple.run_chunk(st.state, st.profile, st.case, 64, nu=st._nu)
    assert ts.count == int(js.count) == 64
    np.testing.assert_allclose(ts.rms, np.asarray(js.rms), rtol=1e-3)
    _close(js, ts)


def test_staged_point_pressure_divides_like_the_pallas_step():
    """Design (b)'s point-iteration pressure stage passes `divide=True`, so
    its update is (sor r) / ap_d as in `pallas_step.py:309` (the plain
    whole-step version divides too). On a CPU tensor the wrapper runs its
    plain version, which must equal the plain step's pressure loop bit for
    bit, count included; on the BFS grid (ap_d = -6.27, not a power of two)
    the reciprocal form of `rb_sor.cu`'s standalone mode differs."""
    from sr_for_cfd_tpu_torch.ops import step_kernels
    from sr_for_cfd_tpu_torch.ops.pressure_kernels import solve_pressure_plain
    from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes
    from sr_for_cfd_tpu_torch.ops.sweeps import sweep_loop

    _, st = _pair("bfs12x10_upwind", pressure_solver="sweeps",
                  inner_tolerance=1e-6, pressure_sor=1.7)
    case, s = st.case, st.state
    staged = object.__new__(step_kernels._Staged)  # pressure() reads the case only
    staged.case = case
    ff = face_fluxes(s.u, s.v, case.mesh.dx, case.mesh.dy)
    got, n_got = staged.pressure(s.p, ff)

    mesh, cs = case.mesh, case.settings
    inv_dx2, inv_dy2, ap_d, sor = step_kernels._coefficients(case)
    b = (case.fluid.rho / cs.dt) * ff.divergence_sum()
    ref, n_ref = sweep_loop(
        s.p, lambda f: (b - step_kernels._laplacian(f, mesh.volp, inv_dx2,
                                                    inv_dy2), ap_d),
        nx=mesh.nx, ny=mesh.ny, tol=cs.inner_tolerance,
        max_iter=cs.inner_max_iter, check_every=cs.pressure_check_every,
        sor=sor)
    assert n_got == n_ref
    assert torch.equal(got, ref)
    recip, _ = solve_pressure_plain(
        s.p, ff, dx=mesh.dx, dy=mesh.dy, dt=cs.dt, rho=case.fluid.rho,
        volp=mesh.volp, tol=cs.inner_tolerance, max_iter=n_got,
        check_every=cs.pressure_check_every, sor=cs.pressure_sor)
    assert not torch.equal(recip, got)
