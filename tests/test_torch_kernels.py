"""The port's pressure-kernel wrappers against the JAX package's Pallas
kernels (interpret mode on the CPU). The CUDA kernels themselves are held
against their plain versions on the card by tests/test_torch_cuda.py.

On a CPU tensor a wrapper runs its kernel's plain PyTorch version, so the
CPU tests here hold that plain version to the TPU kernel. Inputs are made
from a seed with numpy and fed to both packages. Tolerances are float32:
the two sides round differently (reciprocal multiply vs divide, summation
order), ~1e-7 relative per operation, and the iterations are contractive.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.ops import multigrid as jmg
from sr_for_cfd_tpu.ops.pallas_kernels import pallas_solve_pressure
from sr_for_cfd_tpu.ops.pallas_mg import _resize_matrix as jax_resize_matrix
from sr_for_cfd_tpu.ops.pallas_mg import pallas_mg_solve_pressure
from sr_for_cfd_tpu.ops.stencil import face_fluxes as jax_face_fluxes
from sr_for_cfd_tpu_torch.ops import multigrid as tmg
from sr_for_cfd_tpu_torch.ops.mg_kernels import (
    ROW_BAND,
    ROW_RESTRICT_2X,
    mg_solve_pressure_kernel,
    plan_hierarchy,
)
from sr_for_cfd_tpu_torch.ops.pressure_kernels import solve_pressure_kernel
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def _problem(rng, nx, ny, lx, ly, dtype=np.float32):
    u, v = (rng.standard_normal((nx + 2, ny + 2)) * 0.1 for _ in range(2))
    p = rng.standard_normal((nx + 2, ny + 2)) * 0.01
    dx, dy = lx / nx, ly / ny
    geo = dict(dx=dx, dy=dy, dt=2e-3, rho=1.0, volp=dx * dy)
    jax_in = (jnp.asarray(p, dtype),
              jax_face_fluxes(jnp.asarray(u, dtype), jnp.asarray(v, dtype), dx, dy))
    t = {k: torch.tensor(a, dtype=getattr(torch, np.dtype(dtype).name))
         for k, a in (("u", u), ("v", v), ("p", p))}
    torch_in = (t["p"], face_fluxes(t["u"], t["v"], dx, dy))
    return jax_in, torch_in, geo


# Exit points. XLA's CPU code and PyTorch's round a few operations
# differently (a few ulp after one sweep), so where the loop sits at its
# float32 floor (rms ~3.5e-6 on the 12x12 problem, ~1.2e-6 for the V-cycle
# at 40x12) the stall policy's decisions are chaotic in both packages. The
# tolerances below stop each solve on tolerance or on its cap, at least
# 25% away from the nearest check, before that floor.
@pytest.mark.parametrize("n,tol,max_iter", [(10, 1e-4, 256), (32, 1e-6, 96)])
def test_rb_sor_wrapper_matches_pallas_kernel(n, tol, max_iter, rng):
    """Kernel 1 (12x12 and 34x34 padded): same field to float32 rounding,
    same sweep count."""
    (pj, ffj), (pt, fft), geo = _problem(rng, n, n, 10.0, 3.0)
    kw = dict(geo, tol=tol, max_iter=max_iter, check_every=8, sor=1.0)
    ref, n_ref = pallas_solve_pressure(pj, ffj, return_count=True,
                                       interpret=True, **kw)
    out, n_out = solve_pressure_kernel(pt, fft, **kw)
    ref = np.asarray(ref)
    tol = 2e-5 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    assert n_out == int(n_ref)
    np.testing.assert_array_equal(out.numpy()[0, :], pt.numpy()[0, :])


@pytest.mark.parametrize("nx,ny,lx,ly", [(32, 32, 1.0, 1.0), (40, 12, 10.0, 3.0)])
def test_mg_wrapper_matches_pallas_kernel(nx, ny, lx, ly, rng):
    """Kernel 2 at 32x32 and at an anisotropic 40x12 (semi-coarsened
    hierarchy): same field to float32 rounding, same cycle count. The TPU
    kernel's transfers are bf16x3 products (~2^-18 relative error); the
    port's are true float32."""
    (pj, ffj), (pt, fft), geo = _problem(rng, nx, ny, lx, ly)
    kw = dict(geo, tol=3e-5)
    ref, n_ref = pallas_mg_solve_pressure(pj, ffj, return_count=True,
                                          interpret=True, **kw)
    out, n_out = mg_solve_pressure_kernel(pt, fft, **kw)
    ref = np.asarray(ref)
    tol = 2e-5 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol)
    assert n_out == int(n_ref) >= 1
    np.testing.assert_array_equal(out.numpy()[:, -1], pt.numpy()[:, -1])


def test_stall_policy_matches_jax(rng):
    """The host-side stall policy takes the JAX loop's decisions, rounding
    in float32, on traces that rise, descend, rattle and go NaN."""
    from sr_for_cfd_tpu.ops.sweeps import stall_update as jax_update
    from sr_for_cfd_tpu.ops.sweeps import stalled as jax_stalled
    from sr_for_cfd_tpu_torch.ops.sweeps import stall_update, stalled

    trace = np.concatenate([
        [1.0, 1.2, 1.1, 0.9, 0.5], 1e-3 * (1 + 0.01 * rng.standard_normal(12)),
        [0.98e-3, 0.9791e-3, np.nan, 1.0]]).astype(np.float32)
    t = np.float32
    prev_j = best_j = jnp.float32(np.inf)
    stale_j = jnp.int32(0)
    prev_t = best_t = t(np.inf)
    stale_t = 0
    for checks, rms in enumerate(trace, start=1):
        stale_j, best_j = jax_update(jnp.float32(rms), prev_j, best_j, stale_j)
        stale_t, best_t = stall_update(t(rms), prev_t, best_t, stale_t)
        prev_j, prev_t = jnp.float32(rms), t(rms)
        assert int(stale_j) == stale_t
        np.testing.assert_array_equal(np.float32(best_j), best_t)
        assert bool(jax_stalled(stale_j, checks)) == stalled(stale_t, checks)


def test_semi_coarsened_schedule_matches_jax():
    for args in ((40, 12, 0.25, 0.25), (400, 400, 0.025, 0.0075), (16, 16, 1 / 16, 0.3 / 16)):
        assert tmg._levels(*args) == jmg._levels(*args)


@pytest.mark.parametrize("n_in,n_out", [(16, 8), (25, 12), (8, 16), (12, 25), (9, 9), (400, 200)])
def test_transfer_matrices_equal_pallas_mg(n_in, n_out):
    """The port's float32 transfer matrices are the TPU kernel's, bit for bit."""
    np.testing.assert_array_equal(tmg._resize_matrix(n_in, n_out),
                                  jax_resize_matrix(n_in, n_out))


@pytest.mark.parametrize("nc", [3, 6, 25])
def test_exact2x_row_transfers_equal_matrices(nc):
    """The [1,3,3,1] restriction and [0.75,0.25] prolongation are the row
    actions of the resize matrices."""
    rng = np.random.default_rng(nc)
    r = torch.tensor(rng.standard_normal((2 * nc, 5)))
    e = torch.tensor(rng.standard_normal((nc, 5)))
    np.testing.assert_allclose(
        tmg.row_restrict_exact2x(r, nc).numpy(),
        tmg._resize_matrix(2 * nc, nc, np.float64) @ r.numpy(), atol=1e-14)
    np.testing.assert_allclose(
        tmg.row_prolong_exact2x(e).numpy(),
        tmg._resize_matrix(nc, 2 * nc, np.float64) @ e.numpy(), atol=1e-14)


def test_plan_bands_cover_every_nonzero():
    """Each output's [lo, hi) band holds all of its matrix's non-zeros, so
    the kernel's banded sums equal the dense products."""
    plan = plan_hierarchy(400, 400, 0.025, 0.0075, 0.025 * 0.0075, 8, "cpu")
    assert plan.setup.sizes[-1] == (12, 6)
    assert ROW_RESTRICT_2X in plan.row_mode and ROW_BAND in plan.row_mode
    for group, axis in ((plan.row_restrict, 0), (plan.row_prolong, 0),
                        (plan.col_restrict, 1), (plan.col_prolong, 1)):
        for bm in group:
            if bm is None:
                continue
            m = bm.mat.numpy()
            m = m if axis == 0 else m.T
            lo, hi = bm.lo.numpy(), bm.hi.numpy()
            for k in range(m.shape[0]):
                assert not m[k, :lo[k]].any() and not m[k, hi[k]:].any()


def test_mg_plain_matches_jax_multigrid_f64(rng):
    """The plain V-cycle (matrices and exact-2x stencils) solves the same
    system as the JAX package's jnp V-cycle (jax.image.resize transfers)."""
    (pj, ffj), (pt, fft), geo = _problem(rng, 40, 12, 10.0, 3.0, np.float64)
    kw = dict(geo, tol=1e-9, max_cycles=6)
    ref, n_ref = jmg.mg_solve_pressure(pj, ffj, return_count=True, **kw)
    out, n_out = tmg.mg_solve_pressure(pt, fft, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-11)
    assert n_out == int(n_ref)


def test_wrappers_reject_what_the_kernels_do_not_take():
    p = torch.zeros((12, 12), dtype=torch.float64)
    ff = face_fluxes(p, p, 0.1, 0.1)
    with pytest.raises(ValueError, match="check_every"):
        solve_pressure_kernel(p, ff, dx=0.1, dy=0.1, dt=1e-3, rho=1.0,
                              volp=0.01, check_every=0)
