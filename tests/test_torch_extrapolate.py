"""The port's RRE extrapolator (`ops/extrapolate.py`) and the RRE path of
its `run_chunk` against the JAX package, float64 on the CPU.

The same numpy-seeded snapshots go into both `rre_extrapolate`s: the jump
and its `ok` flag agree to 1e-10 (the Gram solve amplifies rounding by
kappa(G), ~1e4 here). The solver runs agree as the non-fused solver's do:
equal iteration counts, fields within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.ops import extrapolate as jrre
from sr_for_cfd_tpu.ops.stencil import FaceFluxes as JFaceFluxes
from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu_torch.ops import extrapolate as trre
from sr_for_cfd_tpu_torch.ops.stencil import FaceFluxes as TFaceFluxes
from sr_for_cfd_tpu_torch.solver import cases as tcases

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def _modes(seed, n, rhos, noise=0.0):
    """Snapshots x_k = x* + sum_j rho_j^k a_j (+ noise), k = 0..K+1."""
    rng = np.random.default_rng(seed)
    x_star = rng.standard_normal(n)
    modes = rng.standard_normal((len(rhos), n))
    rhos = np.asarray(rhos)
    snaps = np.stack([x_star + (rhos[:, None] ** k * modes).sum(axis=0)
                      + noise * rng.standard_normal(n)
                      for k in range(len(rhos) + 2)])
    return x_star, snaps


@pytest.mark.parametrize("noise", [0.0, 1e-6])
def test_rre_extrapolate_matches_jax(noise):
    _, snaps = _modes(3, 150, [0.95, 0.7, -0.5, 0.2, 0.1], noise)
    xj, okj = jrre.rre_extrapolate(jnp.asarray(snaps))
    xt, okt = trre.rre_extrapolate(torch.tensor(snaps))
    assert okt == bool(okj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_gram_coeffs_match_jax():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 40))
    g = a @ a.T
    cj = jrre.gram_coeffs(jnp.asarray(g))
    ct = trre.gram_coeffs(torch.tensor(g))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-12)
    assert abs(float(ct.sum()) - 1.0) < 1e-12


def test_flatten_and_inject_match_jax():
    """flat_size, the flatten/unflatten round trip and inject_state's
    boundary fills (BFS, so the inlet profile is reapplied)."""
    nx, ny = 12, 10
    rng = np.random.default_rng(5)
    sj = jcases.make_bfs_solver(nx=nx, ny=ny, dtype="float64")
    st = tcases.make_bfs_solver(nx=nx, ny=ny, dtype="float64", device="cpu")
    fields = [rng.standard_normal((nx + 2, ny + 2)) for _ in range(3)]
    fluxes = [rng.standard_normal((nx, ny)) for _ in range(4)]
    flat_j = jrre.flatten_state(*map(jnp.asarray, fields),
                                JFaceFluxes(*map(jnp.asarray, fluxes)))
    flat_t = trre.flatten_state(*map(torch.tensor, fields),
                                TFaceFluxes(*map(torch.tensor, fluxes)))
    assert flat_t.shape == (trre.flat_size(nx, ny),) == flat_j.shape
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    out_j = jrre.inject_state(flat_j, sj.case, sj.profile)
    out_t = trre.inject_state(flat_t, st.case, st.profile)
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(out_t[3], out_j[3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rre_exact_on_synthetic_geometric_modes():
    """K independent modes, one of them oscillating: K+1 snapshots
    recover x* up to the ridge's bias (1e-4)."""
    x_star, snaps = _modes(1, 200, [0.9, 0.6, -0.7, 0.3])
    out, ok = trre.rre_extrapolate(torch.tensor(snaps))
    assert ok
    np.testing.assert_allclose(out.numpy(), x_star, atol=1e-4)


def test_rre_rejects_noise_floor():
    """Pure-noise differences give no large accepted jump, and zero drift
    is rejected."""
    rng = np.random.default_rng(2)
    base = rng.standard_normal(300)
    snaps = np.stack([base + 1e-9 * rng.standard_normal(300) for _ in range(7)])
    out, ok = trre.rre_extrapolate(torch.tensor(snaps))
    if ok:
        assert float((out - torch.tensor(snaps[-1])).abs().max()) <= 1e3 * 2e-9 * 2
    _, ok0 = trre.rre_extrapolate(torch.tensor(np.stack([base] * 7)))
    assert not ok0


@pytest.mark.parametrize("chunk_size", [240, 60])
def test_run_chunk_with_rre_matches_jax(chunk_size):
    """A 12x12 cavity with a jump every 60 iterations (rre_every=15,
    depth 3), 240 iterations as one chunk and as four: the buffer is
    chunk-local, so both packages restart it at every chunk."""
    kw = dict(Re=100, nx=12, ny=12, dt=5e-3, scheme="UPWIND", dtype="float64",
              max_iterations=240, chunk_size=chunk_size, inner_max_iter=40,
              rre_every=15, rre_depth=3, rre_min_count=30)
    sj = jcases.make_cavity_solver(**kw)
    st = tcases.make_cavity_solver(device="cpu", **kw)
    before = trre.rre_extrapolate.attempts, trre.rre_extrapolate.taken
    n_j, _ = sj.solve(verbose=False, save_results=False)
    n_t, _ = st.solve(verbose=False, save_results=False)
    assert n_t == n_j == 240
    attempts = trre.rre_extrapolate.attempts - before[0]
    # one cycle is 60 iterations past rre_min_count=30: 3 jumps in one
    # chunk of 240, 3 in four chunks of 60 (the first chunk has none)
    assert attempts == 3
    assert trre.rre_extrapolate.taken - before[1] >= 1
    assert st.residual_history.iterations == sj.residual_history.iterations
    jf, tf = sj.interior_fields(), st.interior_fields()
    for c in "uvp":
        np.testing.assert_allclose(tf[c], jf[c], rtol=0, atol=1e-10)
