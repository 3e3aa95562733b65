"""The port's streamed V-cycle (`ops/stream_kernels.py`) against the JAX
package's `stream_mg_solve_pressure` (`ops/pallas_stream.py`, interpret
mode on the CPU with 16-row slabs, as tests/test_pallas_stream.py runs
it), float32.

The port has one layout; the TPU package has three (a resident coarse
correction, a recursive one, and the wide hand-off), which change where
each level is computed, not what. So one port cycle is held against all
three. Tolerance 1e-5 absolute: the TPU's column transfers are a bf16x3
split about 2^-18 off a float32 product, the port's are true float32, and
the row restriction sums its four taps in a different order where a slab
boundary splits them. Full solves compare cycle counts at a tolerance the
loop reaches before the float32 floor (where exits are chaotic in both
packages), and the refusals compare texts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.ops.pallas_stream import stream_mg_solve_pressure as j_stream
from sr_for_cfd_tpu.ops.stencil import face_fluxes as j_face_fluxes
from sr_for_cfd_tpu_torch.ops import stream_kernels as sk
from sr_for_cfd_tpu_torch.ops.stencil import face_fluxes as t_face_fluxes

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

GEOMETRIES = [
    (64, 64, 1.0, 1.0, "isotropic"),
    (72, 64, 1.0, 1.0, "ragged final slab"),
    (64, 48, 10.0, 3.0, "semi-coarsen y (BFS anisotropy)"),
    (48, 64, 3.0, 10.0, "semi-coarsen x"),
]


def _poisson_case(seed, nx, ny, lx=1.0, ly=1.0):
    """tests/test_pallas_stream.py:_poisson_case, for both packages."""
    rng = np.random.default_rng(seed)
    dx, dy = lx / nx, ly / ny
    u = (rng.standard_normal((nx + 2, ny + 2)) * 0.1).astype(np.float32)
    v = (rng.standard_normal((nx + 2, ny + 2)) * 0.1).astype(np.float32)
    p0 = (rng.standard_normal((nx + 2, ny + 2)) * 0.01).astype(np.float32)
    kw = dict(dx=dx, dy=dy, dt=1e-3, rho=1.0, volp=dx * dy)
    jax_in = (jnp.asarray(p0), j_face_fluxes(jnp.asarray(u), jnp.asarray(v), dx, dy))
    torch_in = (torch.from_numpy(p0),
                t_face_fluxes(torch.from_numpy(u), torch.from_numpy(v), dx, dy))
    return jax_in, torch_in, kw


def _port(p0, ff, **kw):
    return sk.stream_mg_solve_pressure(p0, ff, slab_rows=16, **kw)


def _tol(ref):
    """1e-5 absolute up to |p| = 10, then 1e-6 relative to max|p| (about
    five float32 ulp). PyTorch and XLA round the same V-cycle apart by a
    few ulp: on the semi-coarsen-x case (max|p| 21.3) the port's plain
    V-cycle and the JAX package's jnp V-cycle differ by 9.5e-6, and the
    port's streamed cycle, which equals its plain V-cycle there bit for bit,
    differs from the JAX kernel by 1.14e-5."""
    return 1e-6 * max(10.0, float(np.abs(ref).max()))


def _forced(nx, ny, lx, ly, cycles, **extra):
    (jp, jff), (tp, tff), kw = _poisson_case(7, nx, ny, lx, ly)
    a, ca = j_stream(jp, jff, tol=1e-30, max_cycles=cycles, slab_rows=16,
                     interpret=True, return_count=True, **extra, **kw)
    for name in ("stream_pass_a", "level1_correction", "stream_pass_b"):
        getattr(sk, name).launches = 0
    b, cb = _port(tp, tff, tol=1e-30, max_cycles=cycles, return_count=True, **kw)
    assert cb == int(ca) == cycles
    assert (sk.stream_pass_a.launches, sk.level1_correction.launches,
            sk.stream_pass_b.launches) == (0, 0, 0)  # the plain versions ran
    a = np.asarray(a)
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=_tol(a))


@pytest.mark.parametrize("nx,ny,lx,ly,label", GEOMETRIES,
                         ids=[g[-1] for g in GEOMETRIES])
def test_forced_cycle_matches_jax(nx, ny, lx, ly, label):
    """One forced cycle (tol 1e-30) against the TPU package's resident
    layout."""
    _forced(nx, ny, lx, ly, 1)


@pytest.mark.parametrize("layout,cycles,extra", [
    ("recursive", 1, dict(resident_sub_cells_max=0)),
    ("wide", 2, dict(wide_vmem_bytes=40_000)),
], ids=["recursive", "wide"])
@pytest.mark.parametrize("nx,ny,lx,ly,label", GEOMETRIES[1:3],
                         ids=[g[-1] for g in GEOMETRIES[1:3]])
def test_forced_cycles_match_the_other_jax_layouts(nx, ny, lx, ly, label,
                                                   layout, cycles, extra):
    """The TPU package's recursive coarse correction and its wide hand-off
    change where each level is computed, not what: the port's one layout
    equals them too (ragged slabs and the semi-coarsened hierarchy)."""
    _forced(nx, ny, lx, ly, cycles, **extra)


def test_full_solve_counts_and_ghosts_match_jax():
    """A full solve at 64^2: the same cycle count, the lagged exit
    included (one cycle past the jnp V-cycle's count), and the ghost ring
    left as it was."""
    from sr_for_cfd_tpu_torch.ops.multigrid import mg_solve_pressure

    (jp, jff), (tp, tff), kw = _poisson_case(3, 64, 64)
    tol = 1e-3  # reached in a few cycles, well above the float32 floor
    a, ca = j_stream(jp, jff, tol=tol, max_cycles=25, slab_rows=16,
                     interpret=True, return_count=True, **kw)
    b, cb = _port(tp, tff, tol=tol, max_cycles=25, return_count=True, **kw)
    assert cb == int(ca)
    _, c_plain = mg_solve_pressure(tp, tff, tol=tol, max_cycles=25, **kw)
    assert cb == c_plain + 1
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                               atol=_tol(np.asarray(a)))
    np.testing.assert_array_equal(b[0].numpy(), tp[0].numpy())
    np.testing.assert_array_equal(b[-1].numpy(), tp[-1].numpy())
    np.testing.assert_array_equal(b[:, 0].numpy(), tp[:, 0].numpy())
    np.testing.assert_array_equal(b[:, -1].numpy(), tp[:, -1].numpy())


@pytest.mark.parametrize("nx,ny,kw", [
    (63, 64, {}),
    (64, 64, dict(n_pre=0)),
    (64, 64, dict(n_post=0)),
    (64, 64, dict(slab_rows=24)),
    (64, 64, dict(slab_rows=16, n_pre=8)),
    (8, 8, dict(min_size=8)),
], ids=["odd grid", "n_pre=0", "n_post=0", "slab_rows%16", "halo > slab",
        "no hierarchy"])
def test_refusals_match_jax(nx, ny, kw):
    (jp, jff), (tp, tff), base = _poisson_case(1, nx, ny)
    kw = dict(dict(slab_rows=16), **kw)
    with pytest.raises(ValueError) as je:
        j_stream(jp, jff, tol=1e-3, max_cycles=2, interpret=True, **kw, **base)
    with pytest.raises(ValueError) as te:
        sk.stream_mg_solve_pressure(tp, tff, tol=1e-3, max_cycles=2, **kw, **base)
    assert str(te.value) == str(je.value)


def test_layout_refusal_of_a_wide_shallow_grid_matches_jax(monkeypatch):
    """`check_streamed_layout` raises where the TPU's layout choice does:
    a grid too wide for in-kernel transfers with a one-level sub-hierarchy
    (here forced by a tiny VMEM limit and min_size=16 at 32^2)."""
    (jp, jff), (tp, tff), base = _poisson_case(2, 32, 32)
    kw = dict(slab_rows=16, min_size=16, n_pre=1, n_post=1)
    with pytest.raises(ValueError) as je:
        j_stream(jp, jff, tol=1e-3, max_cycles=1, interpret=True,
                 wide_vmem_bytes=10_000, **kw, **base)
    monkeypatch.setattr(sk, "WIDE_VMEM_BYTES", 10_000)
    with pytest.raises(ValueError) as te:
        sk.stream_mg_solve_pressure(tp, tff, tol=1e-3, max_cycles=1, **kw, **base)
    assert "too shallow to recurse" in str(te.value)
    assert str(te.value) == str(je.value)


def test_auto_slab_rows_matches_jax():
    from sr_for_cfd_tpu.ops import pallas_stream as js

    for r in (16, 64, 256, 512):
        for w in (48, 400, 2048, 4096, 4160, 8192, 16384, 1 << 20):
            assert sk.auto_slab_rows(r, w) == js.auto_slab_rows(r, w)
    assert (sk.SLAB_ROWS, sk.SLAB_CELLS_MAX, sk.RESIDENT_SUB_CELLS_MAX,
            sk.WIDE_VMEM_BYTES) == (js.SLAB_ROWS, js.SLAB_CELLS_MAX,
                                    js.RESIDENT_SUB_CELLS_MAX, js.WIDE_VMEM_BYTES)
