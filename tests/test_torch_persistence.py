"""The port's solver persistence against the JAX package's, on the CPU:
the .npz snapshot format both ways, `snapshot_every` + `resume_from` in
float64, the row-decomposed solver's checkpoint on a one-rank gloo group,
the profiler trace of a solve, the centerline .dat parser and
`VariableBCs.replace`."""

import glob
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sr_for_cfd_tpu import config as jconfig
from sr_for_cfd_tpu.io import checkpoint as jck
from sr_for_cfd_tpu.io import datfiles as jdat
from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu_torch import config as tconfig
from sr_for_cfd_tpu_torch.io import checkpoint as tck
from sr_for_cfd_tpu_torch.io import datfiles as tdat
from sr_for_cfd_tpu_torch.solver import cases as tcases

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

CAVITY = dict(Re=100, nx=12, ny=12, dt=2e-3, dtype="float64", chunk_size=100)


def _solved_pair(max_iterations=100):
    js = jcases.make_cavity_solver(max_iterations=max_iterations, **CAVITY)
    js.solve(verbose=False, save_results=False)
    ts = tcases.make_cavity_solver(device="cpu", max_iterations=max_iterations, **CAVITY)
    ts.solve(verbose=False, save_results=False)
    return js, ts


def test_npz_snapshots_are_interchangeable(tmp_path):
    """The port reads the JAX package's snapshot and the JAX package reads
    the port's: the same keys, the ghosted (nx+2, ny+2) layout, equal
    arrays and count."""
    js, ts = _solved_pair()
    jck.save_solver_state(str(tmp_path / "jax"), js.state)  # ".npz" appended
    tck.save_solver_state(str(tmp_path / "port.npz"), ts.state)
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files) == ["count", "p", "u", "v"]
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype
        assert j["u"].shape == (14, 14) and int(t["count"]) == int(j["count"]) == 100
        for k in "uvp":
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-10)
    for path in ("jax", "port"):
        jf = jck.load_solver_fields(str(tmp_path / path))
        tf = tck.load_solver_fields(str(tmp_path / path))
        assert tck.load_solver_count(str(tmp_path / path)) == 100
        for k in "uvp":
            assert tf[k].shape == (12, 12)
            np.testing.assert_array_equal(tf[k], jf[k])


def test_snapshot_every_and_resume_match_jax(tmp_path):
    """`snapshot_every` writes the snapshot at the same counts as JAX's
    (chunk boundaries 100 and 200 of 250 steps, every 100), and
    `resume_from` carries the count on: each package resumed from its own
    snapshot reaches the same count and fields (float64, within 1e-10) as
    JAX's, and the uninterrupted run's."""
    kw = dict(CAVITY, max_iterations=250)
    js = jcases.make_cavity_solver(**kw)
    js.solve(str(tmp_path / "jax"), verbose=False, save_results=False, snapshot_every=100)
    ts = tcases.make_cavity_solver(device="cpu", **kw)
    ts.solve(str(tmp_path / "port"), verbose=False, save_results=False, snapshot_every=100)
    assert ts.nVar == js.nVar == 3
    jsnap, tsnap = str(tmp_path / "jax_snapshot.npz"), str(tmp_path / "port_snapshot.npz")
    assert tck.load_solver_count(tsnap) == tck.load_solver_count(jsnap) == 200
    kw["max_iterations"] = 300
    jr = jcases.make_cavity_solver(**kw)
    jr.resume_from(jsnap)
    jn, _ = jr.solve(verbose=False, save_results=False)
    tr = tcases.make_cavity_solver(device="cpu", **kw)
    tr.resume_from(tsnap)
    assert tr.state.count == 200
    tn, _ = tr.solve(verbose=False, save_results=False)
    assert tn == jn == 300
    jf, tf = jr.interior_fields(), tr.interior_fields()
    for k in "uvp":
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=1e-10)
    assert not os.path.exists(tmp_path / "port_full.dat")


def test_spmd_checkpoint_and_resume_on_one_rank(tmp_path):
    """`SpmdSolver.checkpoint` writes the single-device snapshot (read by
    both packages' loaders), and `resume_from` restarts from it as
    `CFDSolver.resume_from` does: equal counts and fields after the resume
    (float64, one gloo rank)."""
    from sr_for_cfd_tpu_torch.parallel import mesh
    from sr_for_cfd_tpu_torch.parallel.spmd_step import SpmdSolver

    kw = dict(CAVITY, nx=16, ny=16, max_iterations=20, chunk_size=10)
    mesh.init_single_rank("cpu", str(tmp_path))
    try:
        sp = SpmdSolver(tcases.make_cavity_solver(device="cpu", **kw).case, device="cpu")
        sp.solve()
        snap = str(tmp_path / "spmd.npz")
        sp.checkpoint(snap)
        ref = tcases.make_cavity_solver(device="cpu", **kw)
        ref.solve(verbose=False, save_results=False)
        jf = jck.load_solver_fields(snap)
        for k in "uvp":
            np.testing.assert_allclose(jf[k], ref.interior_fields()[k], rtol=0, atol=1e-12)
        kw["max_iterations"] = 30
        sp2 = SpmdSolver(tcases.make_cavity_solver(device="cpu", **kw).case, device="cpu")
        sp2.resume_from(snap)
        assert sp2.local.count == 20
        sp2.solve()
        single = tcases.make_cavity_solver(device="cpu", **kw)
        single.resume_from(snap)
        single.solve(verbose=False, save_results=False)
        assert sp2.local.count == single.state.count == 30
        got = sp2.interior_fields()
        for k in "uvp":
            np.testing.assert_allclose(got[k], single.interior_fields()[k], rtol=0,
                                       atol=1e-12)
    finally:
        dist.destroy_process_group()


def test_profile_dir_leaves_a_trace(tmp_path):
    ts = tcases.make_cavity_solver(device="cpu", nx=8, ny=8, max_iterations=3)
    ts.solve(verbose=False, save_results=False, profile_dir=str(tmp_path / "trace"))
    traces = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    assert ts.state.count == 3


@pytest.mark.parametrize("nx, ny", [(12, 12), (9, 13), (14, 6)])
def test_load_centerline_dat_parses_like_jax(tmp_path, nx, ny):
    """Centerline files with equal and unequal column lengths parse to the
    same arrays in both packages."""
    rng = np.random.default_rng(nx * 100 + ny)
    var = rng.standard_normal((3, nx + 2, ny + 2))
    mesh = tconfig.MeshParameters(nx=nx, ny=ny, lx=1.0, ly=2.0)
    path = str(tmp_path / "c.dat")
    tdat.save_centerline_data(path, var, mesh, 250)
    got, want = tdat.load_centerline_dat(path), jdat.load_centerline_dat(path)
    assert [len(a) for a in got] == [ny, ny, nx, nx]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_variable_bcs_replace_is_jax_s():
    def as_tuple(vbc):
        return tuple((vbc[s].type, vbc[s].value) for s in ("left", "right", "top", "bottom"))

    t = tconfig.BoundaryConditions.bfs().frozen("u")
    j = jconfig.BoundaryConditions.bfs().frozen("u")
    tr = t.replace(top=tconfig.BoundaryCondition("neumann", 0.5))
    jr = j.replace(top=jconfig.BoundaryCondition("neumann", 0.5))
    assert as_tuple(tr) == as_tuple(jr) and as_tuple(t) == as_tuple(j)
    assert tr != t and tr.replace(top=t.top) == t
