"""The port's tiled momentum loop (`ops/momentum_kernels.py`) against the
JAX package's `tiled_solve_momentum` (`ops/pallas_momentum.py`, interpret
mode on the CPU with 16-row slabs, as tests/test_pallas_momentum.py runs
it), float32.

The problem is JAX's ragged one: 72 rows in 16-row slabs. On a CPU tensor
the wrapper runs its plain version. Sweep counts must be equal and fields
agree within 2e-6 absolute, the JAX package's own bound for its kernel
against its jnp sweeps (XLA and PyTorch round a few operations
differently). The halo refusals must raise the same text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.ops.pallas_momentum import tiled_solve_momentum as j_tiled
from sr_for_cfd_tpu.ops.stencil import face_fluxes as j_face_fluxes
from sr_for_cfd_tpu_torch.ops import momentum_kernels as tm
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes as t_face_fluxes

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def _problem(n=72, seed=3):
    """tests/test_pallas_momentum.py:_problem, for both packages."""
    dx = 1.0 / n
    g = np.random.default_rng(seed)
    u = (g.standard_normal((n + 2, n + 2)) * 0.3).astype(np.float32)
    v = (g.standard_normal((n + 2, n + 2)) * 0.3).astype(np.float32)
    old = (u[1:-1, 1:-1] + (g.standard_normal((n, n)) * 0.01)
           .astype(np.float32)).astype(np.float32)
    kw = dict(dx=dx, dy=dx, dt=1e-3, nu=0.01, volp=dx * dx, tol=1e-6,
              max_iter=40)
    jax_in = (jnp.asarray(u), jnp.asarray(old),
              j_face_fluxes(jnp.asarray(u), jnp.asarray(v), dx, dx))
    tu = torch.from_numpy(u)
    torch_in = (tu, torch.from_numpy(old),
                t_face_fluxes(tu, torch.from_numpy(v), dx, dx))
    return jax_in, torch_in, kw


@pytest.mark.parametrize("check_every", [3, 1])
@pytest.mark.parametrize("scheme", ["QUICK", "UPWIND"])
def test_tiled_momentum_matches_jax(scheme, check_every):
    (ju, jold, jff), (tu, told, tff), kw = _problem()
    a, ca = j_tiled(ju, jold, jff, scheme=scheme, slab_rows=16,
                    check_every=check_every, return_count=True,
                    interpret=True, **kw)
    tm.tiled_solve_momentum.launches = 0
    b, cb = tm.tiled_solve_momentum(tu, told, tff, scheme=scheme, slab_rows=16,
                                    check_every=check_every, return_count=True,
                                    **kw)
    assert cb == int(ca)
    assert cb % check_every == 0
    assert tm.tiled_solve_momentum.launches == 0  # the plain version ran
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2e-6)
    # the ghost ring is carried through unchanged
    np.testing.assert_array_equal(b[0].numpy(), tu[0].numpy())


def test_tiled_momentum_exits_on_max_iter_in_passes():
    """A cap that is not a multiple of the sweeps per pass runs whole
    passes past it, in both packages."""
    (ju, jold, jff), (tu, told, tff), kw = _problem(n=48, seed=5)
    kw = dict(kw, tol=1e-30, max_iter=7)
    _, ca = j_tiled(ju, jold, jff, scheme="QUICK", slab_rows=16, check_every=3,
                    return_count=True, interpret=True, **kw)
    _, cb = tm.tiled_solve_momentum(tu, told, tff, scheme="QUICK", slab_rows=16,
                                    check_every=3, return_count=True, **kw)
    assert cb == int(ca) == 9


@pytest.mark.parametrize("W,slab_rows,scheme,check_every,refused", [
    (50, 16, "QUICK", 6, True),      # 18-row halo in a 16-row slab
    (50, 16, "UPWIND", 9, True),     # 18-row halo at UPWIND's 2 rows per sweep
    (302, 256, "QUICK", 6, False),
    (8194, 256, "QUICK", 6, True),   # 8192^2: slab capped to 16 rows by width
    (8194, 256, "QUICK", 3, False),  # capped to 16 rows, the 9-row halo fits
])
def test_halo_refusals_match_jax(W, slab_rows, scheme, check_every, refused):
    """Both packages accept or refuse the same halo and raise the same
    text, the width-capped one included (at padded width 8194, the 8192^2
    grid, JAX's resolve_slab_rows caps the slab at 16 rows)."""
    got = _torch_halo_outcome(W, slab_rows, scheme, check_every)
    assert got == _jax_halo_outcome(W, slab_rows, scheme, check_every)
    assert (got != "ok") == refused
    if W == 8194 and refused:
        assert "auto-shrunk to 16 at width 8194" in got


def _jax_halo_outcome(W, slab_rows, scheme, check_every):
    """Run JAX's wrapper up to its halo check on a (3, W) float32 field:
    the checks come before any slab is built."""
    f = jnp.zeros((3, W), jnp.float32)
    ff = j_face_fluxes(f, f, 1.0, 1.0)
    try:
        j_tiled(f, f[1:-1, 1:-1], ff, scheme=scheme, dx=1.0, dy=1.0, dt=1.0,
                nu=0.0, volp=1.0, tol=1e30, max_iter=1, check_every=check_every,
                slab_rows=slab_rows, interpret=True)
    except ValueError as e:
        return str(e)
    return "ok"


def _torch_halo_outcome(W, slab_rows, scheme, check_every):
    try:
        tm.check_halo(slab_rows, W, scheme, check_every)
    except ValueError as e:
        return str(e)
    return "ok"


def test_rejects_non_f32():
    (_, _, _), (tu, told, tff), kw = _problem(n=16)
    with pytest.raises(ValueError, match="float32-only"):
        tm.tiled_solve_momentum(tu.double(), told.double(), tff,
                                scheme="UPWIND", **kw)
