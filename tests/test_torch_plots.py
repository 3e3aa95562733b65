"""The port's plots and artifact suite against the JAX package's, on the
CPU: `format_bc_summary`, the centerline comparison's stats, the file set
of `save_all_results` and of a hybrid run, and the suite on a machine
without h5py and matplotlib (the two .dat files and one skip line per
skipped writer)."""

import os
import sys

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu import config as jconfig
from sr_for_cfd_tpu.solver import cases as jcases
from sr_for_cfd_tpu.viz import plots as jplots
from sr_for_cfd_tpu.workflow.hybrid import run_hybrid_experiment as jax_hybrid
from sr_for_cfd_tpu_torch import config as tconfig
from sr_for_cfd_tpu_torch.io import datfiles as tdat
from sr_for_cfd_tpu_torch.io import results as tres
from sr_for_cfd_tpu_torch.solver import cases as tcases
from sr_for_cfd_tpu_torch.viz import plots as tplots
from sr_for_cfd_tpu_torch.workflow import hybrid as thybrid

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

SUITE = ("_full.dat", "_centerline.dat", ".h5", "_centerlines.png", "_contours.png",
         "_convergence.png")


def _bcs(pkg):
    bc = pkg.BoundaryConditions()
    bc.u_boundaries["left"] = pkg.BoundaryCondition("neumann", 0.25)
    bc.p_boundaries["top"] = pkg.BoundaryCondition("dirichlet", -1.5e-3)
    return [pkg.BoundaryConditions.lid_driven_cavity(),
            pkg.BoundaryConditions.double_lid_cavity(2.0),
            pkg.BoundaryConditions.bfs(), bc]


def test_format_bc_summary_is_jax_s():
    for t, j in zip(_bcs(tconfig), _bcs(jconfig)):
        assert tplots.format_bc_summary(t) == jplots.format_bc_summary(j)


@pytest.mark.parametrize("n", [10, 33])
def test_centerline_comparison_stats_are_jax_s(tmp_path, capsys, n):
    """Both packages' plots written, the same stats (within 1e-12) and the
    same printed lines."""
    rng = np.random.default_rng(n)
    mesh = tconfig.MeshParameters(nx=n, ny=n + 3, lx=10.0, ly=3.0)
    a, b = rng.standard_normal((2, 3, n + 2, n + 5))
    ml, normal = tdat.extract_centerlines(a, mesh), tdat.extract_centerlines(b, mesh)
    want = jplots.plot_centerline_comparison(str(tmp_path / "j.png"), ml, normal, 400,
                                             bc_summary="U: x")
    jout = capsys.readouterr().out
    got = tplots.plot_centerline_comparison(str(tmp_path / "t.png"), ml, normal, 400,
                                            bc_summary="U: x")
    assert capsys.readouterr().out == jout and jout.count("centerline diff") == 2
    assert set(got) == set(want) == {"U", "V"}
    for name in want:
        for stat in ("max", "mean", "rms"):
            assert got[name][stat] == pytest.approx(want[name][stat], rel=0, abs=1e-12)
    assert tplots.centerline_diff_stats(ml, normal) == got
    assert (tmp_path / "t.png").stat().st_size > 0


def test_save_all_results_writes_jax_s_suite(tmp_path):
    """The same six files as the JAX package's suite, the same .dat text
    and HDF5 group, and the plots written."""
    import h5py

    kw = dict(Re=100, nx=8, ny=8, dt=2e-3, dtype="float64", max_iterations=20,
              chunk_size=10)
    js = jcases.make_cavity_solver(**kw)
    js.solve(str(tmp_path / "jax" / "run"), verbose=False)
    ts = tcases.make_cavity_solver(device="cpu", **kw)
    ts.solve(str(tmp_path / "port" / "run"), verbose=False)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) \
        == sorted(f"run{s}" for s in SUITE)
    for s in ("_full.dat", "_centerline.dat"):
        assert (tmp_path / "port" / f"run{s}").read_text() == \
            (tmp_path / "jax" / f"run{s}").read_text()
    with h5py.File(tmp_path / "port" / "run.h5") as t, \
            h5py.File(tmp_path / "jax" / "run.h5") as j:
        assert list(t) == list(j) == ["Re100_mesh8x8"]
        for k in ("u", "v", "p"):
            np.testing.assert_allclose(t["Re100_mesh8x8"][k][()], j["Re100_mesh8x8"][k][()],
                                       rtol=0, atol=1e-10)
        assert dict(t["Re100_mesh8x8"].attrs) == dict(j["Re100_mesh8x8"].attrs)


def test_hybrid_writes_jax_s_files_and_the_comparison_plot(tmp_path, monkeypatch):
    """`run_hybrid_experiment(save_results=True)` writes the same files as
    the JAX package's into the run directory, the centerline comparison
    plot among them, with the BC subtitle; `save_results=False` writes
    nothing."""
    seen = []
    real = thybrid.plot_centerline_comparison

    def spy(filename, ml, normal, re, bc_summary=None):
        seen.append((os.path.basename(filename), bc_summary))
        return real(filename, ml, normal, re, bc_summary=bc_summary)

    monkeypatch.setattr(thybrid, "plot_centerline_comparison", spy)
    kw = dict(Re=100, lr_dim=10, hr_dim=20, case="bfs", max_iterations_coarse=20,
              max_iterations_ml=5, max_iterations_normal=5, verbose=False,
              dtype="float64", chunk_size=5, pressure_solver="multigrid",
              coarse_overrides={"pressure_solver": "sweeps"})
    rj = jax_hybrid(output_dir=str(tmp_path / "jax"), bc=jconfig.BoundaryConditions.bfs(), **kw)
    rt = thybrid.run_hybrid_experiment(output_dir=str(tmp_path / "port"),
                                       bc=tconfig.BoundaryConditions.bfs(), device="cpu", **kw)
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert "bfs_Re100_centerline_comparison.png" in files and len(files) == 3 * 6 + 1
    assert seen == [("bfs_Re100_centerline_comparison.png",
                     jplots.format_bc_summary(jconfig.BoundaryConditions.bfs()))]
    assert rt["ml_iterations"] == rj["ml_iterations"]
    seen.clear()
    thybrid.run_hybrid_experiment(output_dir=str(tmp_path / "none"), save_results=False,
                                  device="cpu", **kw)
    assert not os.path.exists(tmp_path / "none") and not seen


def test_superres_and_field_plots_write_their_files(tmp_path):
    rng = np.random.default_rng(3)
    lr, hr, pred = rng.standard_normal((10, 10)), *rng.standard_normal((2, 20, 20))
    tplots.plot_superres_comparison(lr, hr, pred, 400, "u", (10, 10), (20, 20), 0.1, 2.0,
                                    filename=str(tmp_path / "sr.png"))
    var = rng.standard_normal((3, 10, 8))
    mesh = tconfig.MeshParameters(nx=8, ny=6)
    tplots.plot_centerlines(str(tmp_path / "cl.png"), var, mesh, 100)
    tplots.plot_contours(str(tmp_path / "co.png"), var, mesh, 100, title="Cavity")
    empty = tcases.make_cavity_solver(device="cpu", nx=6, ny=6).residual_history
    tplots.plot_convergence(str(tmp_path / "cv.png"), empty, 100)
    assert sorted(os.listdir(tmp_path)) == ["cl.png", "co.png", "sr.png"]


def test_suite_without_h5py_and_matplotlib_writes_the_dat_files(tmp_path, monkeypatch,
                                                               capsys):
    """With h5py and matplotlib unimportable (as on the card's machine):
    each phase of a hybrid run writes its two .dat files, and each skipped
    writer prints one line naming its package and the files not written.
    (The port imports both only inside the functions that need them,
    `tests/test_torch_imports.py`, so blocking them here blocks them for
    the whole run.)"""
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    thybrid.run_hybrid_experiment(Re=100, lr_dim=10, hr_dim=20, case="bfs",
                                  max_iterations_coarse=20, max_iterations_ml=5,
                                  max_iterations_normal=5, verbose=False, chunk_size=5,
                                  output_dir=str(tmp_path), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 6 and all(f.endswith(("_full.dat", "_centerline.dat"))
                                   for f in files)
    h5 = [ln for ln in lines if ln.startswith("  (HDF5 group skipped: ImportError: ")]
    plots = [ln for ln in lines if ln.startswith("  (plots skipped: ImportError: ")]
    comparison = [ln for ln in lines
                  if ln.startswith("  (centerline comparison plot skipped: ImportError: ")]
    assert len(h5) == len(plots) == 3 and len(comparison) == 1 and len(lines) == 7
    assert all("h5py" in ln and ln.endswith(".h5)") for ln in h5)
    assert all("matplotlib" in ln and "_centerlines.png, " in ln and "_contours.png, " in ln
               and ln.endswith("_convergence.png)") for ln in plots)
    assert comparison[0].endswith("bfs_Re100_centerline_comparison.png)")
    base = sorted(f[:-len("_full.dat")] for f in files if f.endswith("_full.dat"))
    assert all(f"not written: {os.path.join(str(tmp_path), b)}.h5)" in " ".join(h5)
               for b in base)


def test_run_or_skip_passes_on_other_import_errors():
    def broken():
        raise ImportError("something else", name="numpy")

    with pytest.raises(ImportError, match="something else"):
        tres.run_or_skip("plots", "matplotlib", ["x.png"], broken)
