"""The port's sharded V-cycle (`parallel/spmd_mg.py`) and the
row-decomposed solver's multigrid routes against the JAX package, on the
CPU: the plan without processes, the solves on four gloo ranks (one spawn
for the file, `spmd_ranks.py`) against JAX on a four-device mesh.

64^2 over four ranks keeps two levels sharded (16 and 8 rows a rank)
before the replicated tail. Tolerances: float32 V-cycles agree to 1e-5
absolute (PyTorch and XLA round the transfer products and sums a few ulp
apart, `tests/test_torch_stream.py`), with equal cycle counts at an exit
tolerance reached before the float32 floor; the float64 route to 1e-10.
On both solver routes every step's V-cycles equal those of JAX's
`SpmdSolver` (reported from inside its compiled chunk, `spmd_jax.py`) and
the first steps' momentum counts the JAX single-device solver's.
"""

import numpy as np
import pytest
import torch

import spmd_ranks
from spmd_jax import jax_single_device_counts, jax_spmd
from spmd_ranks import max_abs

torch.set_num_threads(1)

WORLD = 4
FIRST = 3  # steps whose momentum counts are held against the single-device solver
N = 64
PLAN_ARGS = (N, N, 1.0 / N, 1.0 / N, 1.0 / N ** 2)
MG_TOL = 2e-4
PALLAS_MG = dict(Re=100, nx=N, ny=N, dt=2e-3, scheme="UPWIND", dtype="float32",
                 chunk_size=10, max_iterations=20, pressure_solver="multigrid",
                 use_pallas=True)
PLAIN_MG = dict(Re=100, nx=N, ny=N, dt=2e-3, scheme="UPWIND", dtype="float64",
                chunk_size=5, max_iterations=10, pressure_solver="multigrid")


def _problem():
    g = np.random.default_rng(64)
    b = g.standard_normal((N, N)).astype(np.float32)
    return np.zeros((N, N), np.float32), b


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    x, b = _problem()
    cases = {
        "mg_plain": ("mg_solve", dict(x=x, b=b, plan_args=PLAN_ARGS,
                                      kw=dict(tol=MG_TOL, use_pallas=False))),
        "mg_kernel": ("mg_solve", dict(x=x, b=b, plan_args=PLAN_ARGS,
                                       kw=dict(tol=MG_TOL, use_pallas=True))),
        "pallas_mg": ("solve_case", dict(maker="make_cavity_solver", kw=PALLAS_MG)),
        "plain_mg": ("solve_case", dict(maker="make_cavity_solver", kw=PLAIN_MG)),
    }
    return spmd_ranks.run_ranks(tmp_path_factory.mktemp("spmd_mg4"), WORLD, cases)


def test_plan_matches_jax():
    """Level schedule, sharded prefix and every rank's operator slices."""
    from sr_for_cfd_tpu.parallel.spmd_mg import plan_spmd_mg as jax_plan

    from sr_for_cfd_tpu_torch.parallel.spmd_mg import plan_spmd_mg

    for dtype in (np.float32, np.float64):
        j = jax_plan(*PLAN_ARGS, WORLD, np.dtype(dtype))
        t = plan_spmd_mg(*PLAN_ARGS, WORLD, np.dtype(dtype))
        assert t.n_shard == j.n_shard == 2
        assert t.setup.sizes == j.sizes
        assert t.setup.spacings == j.spacings
        assert t.setup.volp_levels == j.volp_levels
        assert t.setup.scales[:t.n_shard] == j.scales
        for name in ("rstack", "pstack", "rcolT", "pcolT"):
            for a, b in zip(getattr(t, name), getattr(j, name)):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def _jax_mg(use_pallas):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from sr_for_cfd_tpu.parallel.mesh import make_mesh
    from sr_for_cfd_tpu.parallel.spmd_mg import make_spmd_mg_solve, plan_spmd_mg

    x, b = _problem()
    plan = plan_spmd_mg(*PLAN_ARGS, WORLD, np.dtype(np.float32))
    solve = make_spmd_mg_solve(plan, "x", WORLD, tol=MG_TOL, use_pallas=use_pallas,
                               interpret=True)
    fn = jax.jit(jax.shard_map(solve, mesh=make_mesh(WORLD, "x"),
                               in_specs=(P("x", None), P("x", None)),
                               out_specs=(P("x", None), P()), check_vma=False))
    out, cycles = fn(jnp.asarray(x), jnp.asarray(b))
    return np.asarray(out), int(cycles)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
def test_sharded_vcycle_matches_jax(port, use_pallas):
    """The sharded V-cycle loop on a seeded problem: equal cycles, x
    within 1e-5 absolute."""
    out, cycles = _jax_mg(use_pallas)
    got, got_cycles = port["mg_kernel" if use_pallas else "mg_plain"]
    assert 2 < got_cycles == cycles < 30
    assert max_abs(got, out) <= 1e-5


def _check_counts(got, kw, count, p_steps):
    """Every step's V-cycles equal JAX's SpmdSolver's, the first steps'
    momentum counts the single-device solver's."""
    assert len(p_steps) == count
    assert [c["p"] for c in got["per_step"]] == p_steps
    uv = [{k: c[k] for k in "uv"}
          for c in jax_single_device_counts("make_cavity_solver", kw, FIRST)]
    assert [{k: c[k] for k in "uv"} for c in got["per_step"][:FIRST]] == uv


def test_kernel_multigrid_route_matches_jax(port, monkeypatch):
    """use_pallas=True, pressure_solver='multigrid': the sharded levels'
    smoothers on the per-rank sweep (row 9), float32."""
    count, fields, p_steps = jax_spmd("make_cavity_solver", PALLAS_MG, WORLD, monkeypatch)
    got = port["pallas_mg"]
    assert got["count"] == count == PALLAS_MG["max_iterations"]
    _check_counts(got, PALLAS_MG, count, p_steps)
    for k in "uvp":
        assert max_abs(got["fields"][k], fields[k]) <= 1e-5, k


def test_plain_multigrid_route_matches_jax(port, monkeypatch):
    """The plain sharded V-cycle (communication-avoiding smoother with its
    residual by-products), float64."""
    count, fields, p_steps = jax_spmd("make_cavity_solver", PLAIN_MG, WORLD, monkeypatch)
    got = port["plain_mg"]
    assert got["count"] == count
    _check_counts(got, PLAIN_MG, count, p_steps)
    for k in "uvp":
        assert max_abs(got["fields"][k], fields[k]) <= 1e-10, k
