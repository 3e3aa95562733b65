"""The port's data-generation sweep (`workflow/sweep.py`), HDF5 files
(`io/hdf5.py`) and `run_to_convergence` against the JAX package's, on the
CPU.

Fused sweeps run in float32 (the JAX side's Pallas step in interpret mode,
as its own tests run it); their budget ends the run (40 steps, 10 a
launch), so that the exit counts are not decided at the float32 residual
floor, and the fields agree within the fused step's tolerances
(tests/test_torch_step.py: u, v 1e-5, p 1e-4). The non-fused sweep runs
in float64, to 1e-9. The printed lines (the auto-K notice, one progress
line per chunk, the dropped cases) must be the JAX package's.
"""

import numpy as np
import pytest
import torch

from sr_for_cfd_tpu.io import hdf5 as jhdf5
from sr_for_cfd_tpu.workflow import sweep as jsweep
from sr_for_cfd_tpu_torch.io import hdf5 as thdf5
from sr_for_cfd_tpu_torch.workflow import sweep as tsweep

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)

FUSED = dict(dt=1e-3, scheme="QUICK", double_lid=True, max_iterations=40,
             chunk_size=40, dtype="float32", fused_step=True)
# float64, criteria the three cases reach at 135, 9 and 1 steps, in
# chunks of 50: cases stop in different chunks
NON_FUSED = dict(dt=2e-3, scheme="UPWIND", double_lid=True, max_iterations=200,
                 chunk_size=50, dtype="float64",
                 convergence_criteria={"u": 0.3, "v": 0.3, "p": 3.0})


def _both(capsys, reynolds, n, **kw):
    """(jax fields, jax iterations, jax stdout, port ..., port stdout)."""
    jf, ji = jsweep.batched_cavity_solve(reynolds, n, n, **kw)
    jout = capsys.readouterr().out
    tf, ti = tsweep.batched_cavity_solve(reynolds, n, n, device="cpu", **kw)
    tout = capsys.readouterr().out
    return jf, ji, jout, tf, ti, tout


def _close(jf, tf, tols):
    assert list(tf) == list(jf)
    for re in jf:
        for c, atol in tols.items():
            np.testing.assert_allclose(tf[re][c], jf[re][c], rtol=0, atol=atol,
                                       err_msg=f"Re={re} {c}")


class _Calls:
    """Counts the calls of a function of a module while it is patched."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn = 0, getattr(module, name)

        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, counted)


def test_fused_sweep_takes_the_batched_route_and_matches_jax(capsys, monkeypatch):
    """Design (a) fits 12x12: one batched call per K = 10 steps for all
    cases, no single-case step; equal counts, fields within the fused
    step's tolerances, the same printed lines."""
    batched = _Calls(monkeypatch, tsweep, "simple_step_small_batched")
    single = _Calls(monkeypatch, tsweep, "simple_step")
    jf, ji, jout, tf, ti, tout = _both(capsys, [100, 400, 800], 12, **FUSED)
    assert (batched.n, single.n) == (4, 0)
    np.testing.assert_array_equal(ti, ji)
    assert ti.tolist() == [40, 40, 40]
    _close(jf, tf, {"u": 1e-5, "v": 1e-5, "p": 1e-4})
    assert "auto-enabled steps_per_kernel=10" in tout
    assert tout == jout


def test_fused_sweep_on_design_b_loops_over_the_cases(capsys, monkeypatch):
    """The multigrid mode runs design (b): a loop over the cases on the
    single-case step, the same result as JAX's vmapped step."""
    batched = _Calls(monkeypatch, tsweep, "simple_step_small_batched")
    single = _Calls(monkeypatch, tsweep, "simple_step")
    kw = dict(FUSED, max_iterations=20, chunk_size=20, pressure_solver="multigrid",
              mg_coarsest_sweeps=10)
    jf, ji, jout, tf, ti, tout = _both(capsys, [100, 800], 12, **kw)
    assert (batched.n, single.n) == (0, 4)
    np.testing.assert_array_equal(ti, ji)
    _close(jf, tf, {"u": 1e-5, "v": 1e-5, "p": 1e-4})
    assert tout == jout


def test_non_fused_sweep_matches_jax_float64(capsys):
    """Cases that converge at 135, 9 and 1 steps: each frozen once it
    stops, to 1e-9 of JAX's masked vmap; the same progress lines."""
    jf, ji, jout, tf, ti, tout = _both(capsys, [100, 300, 800], 12, **NON_FUSED)
    assert ji.tolist() == [135, 9, 1]
    np.testing.assert_array_equal(ti, ji)
    _close(jf, tf, {c: 1e-9 for c in "uvp"})
    assert tout == jout


def test_diverged_case_is_dropped_like_jax(capsys):
    """dt 0.2: Re 800 diverges at step 53 and is dropped with JAX's
    message; Re 100 runs its budget."""
    kw = dict(dt=0.2, scheme="UPWIND", double_lid=True, max_iterations=60,
              chunk_size=20, dtype="float64")
    jf, ji, jout, tf, ti, tout = _both(capsys, [100, 800], 12, **kw)
    assert ji.tolist() == [60, 53]
    np.testing.assert_array_equal(ti, ji)
    assert list(tf) == [100.0]
    _close(jf, tf, {c: 1e-9 for c in "uvp"})
    assert "DROPPED diverged cases Re=[800.0]" in tout
    assert tout == jout


@pytest.mark.parametrize("extra,k", [({}, 10), ({"chunk_size": 25, "max_iterations": 25}, None),
                                     ({"chunk_size": 500, "max_iterations": 1500}, 500),
                                     ({"steps_per_kernel": 20}, None),
                                     ({"plateau_patience": 2}, None)])
def test_auto_k_rule_is_jax_s(extra, k, capsys):
    """The auto-K rule and its notice (`sweep.py:59-80`): the largest K of
    (500, 250, 100, 50, 10) dividing the chunk and the budget; none where
    no K divides both or the caller set K or a detector option."""
    kw = dict(FUSED, **extra)
    tsweep._auto_steps_per_kernel(kw, kw["max_iterations"], True)
    out = capsys.readouterr().out
    assert kw.get("steps_per_kernel") == (k or extra.get("steps_per_kernel"))
    assert out == ("" if k is None else
                   f"[sweep] fused sweeps: auto-enabled steps_per_kernel={k} "
                   f"(convergence checked every {k} iterations)\n")


def test_run_to_convergence_matches_jax_float64():
    """The whole solve in one host loop: the count and fields of JAX's
    single while_loop."""
    from sr_for_cfd_tpu.solver import cases as jcases
    from sr_for_cfd_tpu.solver import simple as jsimple
    from sr_for_cfd_tpu_torch.solver import cases as tcases
    from sr_for_cfd_tpu_torch.solver import simple as tsimple

    kw = dict(Re=100, nx=12, ny=12, dt=2e-3, scheme="UPWIND", double_lid=True,
              dtype="float64", max_iterations=200,
              convergence_criteria={"u": 0.3, "v": 0.3, "p": 3.0})
    sj, st = jcases.make_cavity_solver(**kw), tcases.make_cavity_solver(device="cpu", **kw)
    js = jsimple.run_to_convergence(sj.state, sj.profile, sj.case)
    ts = tsimple.run_to_convergence(st.state, st.profile, st.case, nu=st._nu)
    assert ts.count == int(js.count) == 135 and ts.converged and bool(js.converged)
    for c in "uvp":
        np.testing.assert_allclose(getattr(ts, c).numpy(), np.asarray(getattr(js, c)),
                                   rtol=0, atol=1e-9)
    capped = tsimple.run_to_convergence(
        st.state, st.profile,
        tcases.make_cavity_solver(device="cpu", **dict(kw, max_iterations=7)).case)
    assert capped.count == 7 and not capped.converged


def _read(loader, path, lr, hr):
    return loader([str(path)], lr, hr)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype.kind == y.dtype.kind
        np.testing.assert_array_equal(x, y)


def test_generate_training_data_files_read_by_jax(tmp_path, capsys):
    """The port's per-case and combined files: JAX's loader reads the
    combined file into the same arrays, Re, components and bc types as
    the port's loader, equal to the sweep's fields."""
    kw = dict(reynolds_numbers=[100, 200], mesh_sizes=[10, 20], dt=1e-3,
              scheme="QUICK", double_lid=True, dtype="float32", fused_step=True,
              max_iterations=20, chunk_size=20, device="cpu")
    combined = tsweep.generate_training_data(output_dir=str(tmp_path / "port"), **kw)
    assert combined.endswith("simulation_result_double_lid.h5")
    for re in (100, 200):
        for n in (10, 20):
            assert (tmp_path / "port" / f"Re{re}" / f"cavity_Re{re}_mesh{n}x{n}.h5").exists()
    got = _read(jhdf5.load_paired_reynolds_multi, combined, 10, 20)
    _same(got, _read(thdf5.load_paired_reynolds_multi, combined, 10, 20))
    x_lr, x_hr, res, comps, bcs = got
    assert res.tolist() == [100.0] * 3 + [200.0] * 3
    assert comps.tolist() == ["u", "v", "p"] * 2
    assert set(bcs.tolist()) == {"double_lid(u_top=1,u_bottom=1)"}
    fields, _ = tsweep.batched_cavity_solve([100, 200], 20, 20, verbose=False,
                                            **{k: v for k, v in kw.items()
                                               if k not in ("reynolds_numbers", "mesh_sizes")})
    np.testing.assert_array_equal(x_hr[4, ..., 0], fields[200.0]["v"].astype(np.float32))


def test_jax_written_hdf5_reads_back_in_the_port(tmp_path):
    """Groups written by JAX's save_fields_hdf5 (two BC types in one file,
    a BFS group's extra attributes) load equal in both packages; the port's
    writer gives the same groups and attributes."""
    from sr_for_cfd_tpu.config import BFSGeometry as JB
    from sr_for_cfd_tpu.config import MeshParameters as JM
    from sr_for_cfd_tpu_torch.config import BFSGeometry as TB
    from sr_for_cfd_tpu_torch.config import MeshParameters as TM

    paths = {"jax": tmp_path / "jax.h5", "port": tmp_path / "port.h5"}
    for name, (save, M, B) in {"jax": (jhdf5.save_fields_hdf5, JM, JB),
                               "port": (thdf5.save_fields_hdf5, TM, TB)}.items():
        rng = np.random.default_rng(5)
        for re, bc in ((300, "lid_driven_cavity"), (800, "double_lid(u_top=1,u_bottom=1)")):
            for n in (10, 20):
                f = {c: rng.standard_normal((n, n)) for c in "uvp"}
                save(str(paths[name]), f, M(nx=n, ny=n, lx=1.0, ly=1.0), re, bc_type=bc)
        save(str(paths[name]), {c: rng.standard_normal((10, 10)) for c in "uvp"},
             M(nx=10, ny=10, lx=2.0, ly=1.0), 412.5, bfs=B())
    ref = _read(jhdf5.load_paired_reynolds_multi, paths["jax"], 10, 20)
    _same(ref, _read(thdf5.load_paired_reynolds_multi, paths["jax"], 10, 20))
    _same(ref, _read(thdf5.load_paired_reynolds_multi, paths["port"], 10, 20))
    assert ref[4].tolist() == ["lid_driven_cavity"] * 3 + ["double_lid(u_top=1,u_bottom=1)"] * 3
    import h5py

    with h5py.File(paths["jax"], "r") as a, h5py.File(paths["port"], "r") as b:
        assert list(a) == list(b) == ["Re300_mesh10x10", "Re300_mesh20x20", "Re412.5_mesh10x10",
                                      "Re800_mesh10x10", "Re800_mesh20x20"]
        for g in a:
            assert dict(a[g].attrs) == dict(b[g].attrs)
            for d in a[g]:
                np.testing.assert_array_equal(a[g][d][()], b[g][d][()])


def test_loader_dummy_fallback_is_jax_s(tmp_path):
    got = _read(thdf5.load_paired_reynolds_multi, tmp_path / "missing.h5", 10, 20)
    _same(got, _read(jhdf5.load_paired_reynolds_multi, tmp_path / "missing.h5", 10, 20))
    with pytest.raises(ValueError, match="multiple"):
        thdf5.load_paired_reynolds_multi([str(tmp_path / "missing.h5")], 10, 25)
    assert thdf5.group_name(400.0, 10, 12) == jhdf5.group_name(400.0, 10, 12) == "Re400_mesh10x12"


@pytest.mark.parametrize("call", ["mesh_devices", "use_device_mesh", "spmd_devices"])
def test_sharded_sweeps_raise_naming_a11(call, tmp_path, capsys):
    """The sharded sweeps, which raised naming A11 before they were ported
    (A11 items 1-2), run without a process group on the one-rank mesh of
    this process: `mesh_devices` gives the unsharded solve bit for bit,
    `use_device_mesh` writes the unsharded sweep's file, and
    `spmd_devices=2`, for which one rank is too few, falls back to the
    case-parallel path with JAX's notice."""
    from sr_for_cfd_tpu_torch.parallel.mesh import make_mesh

    kw = dict(max_iterations=5, chunk_size=5, dtype="float64", device="cpu", verbose=False)
    if call == "mesh_devices":
        got, got_n = tsweep.batched_cavity_solve([100, 200], 10, 10, mesh_devices=make_mesh(1),
                                                 **kw)
        want, want_n = tsweep.batched_cavity_solve([100, 200], 10, 10, **kw)
        np.testing.assert_array_equal(got_n, want_n)
        for re_val in want:
            for c in "uvp":
                np.testing.assert_array_equal(got[re_val][c], want[re_val][c])
        return
    extra = {"use_device_mesh": True} if call == "use_device_mesh" else {"spmd_devices": 2}
    got = tsweep.generate_training_data([100], [10], output_dir=str(tmp_path / "a"),
                                        **dict(kw, verbose=True), **extra)
    out = capsys.readouterr().out
    if call == "spmd_devices":
        assert ("mesh 10x10: decomposed path unavailable (case-x mesh needs 1x2=2 "
                "devices; backend has 1) - running case-parallel") in out
    want = tsweep.generate_training_data([100], [10], output_dir=str(tmp_path / "b"), **kw)
    a, b = (thdf5.load_paired_reynolds_multi([p], 10, 10) for p in (got, want))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_generate_training_data_isolates_a_failing_size(tmp_path, capsys):
    """A size whose solve raises (a fused grid too large for the JAX
    package's fused-step gate) is reported and skipped; the others are
    written."""
    combined = tsweep.generate_training_data(
        [100], [10, 1000], output_dir=str(tmp_path), dtype="float32",
        fused_step=True, max_iterations=10, chunk_size=10, device="cpu",
        verbose=False)
    out = capsys.readouterr().out
    assert "sweep error for mesh 1000x1000" in out
    x_lr, *_ = thdf5.load_paired_reynolds_multi([combined], 10, 10)
    assert x_lr.shape == (3, 10, 10, 1)


def test_defaults_are_jax_s():
    assert tsweep.DEFAULT_REYNOLDS == jsweep.DEFAULT_REYNOLDS
    assert tsweep.DEFAULT_MESH_SIZES == jsweep.DEFAULT_MESH_SIZES


def test_batched_route_fit_rule_is_the_kernel_s():
    """The sweep routes by `step_kernels.small_fits` on any device; it must
    be `fused_step.cu`'s rule: 12 padded arrays and two inlet rows of
    float32 within kSmallSmemMax (the 227 KB a block may take, less two
    256-float reduction buffers)."""
    import os
    import re

    from sr_for_cfd_tpu_torch.ops.step_kernels import SMALL_SMEM_MAX, small_fits

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = open(os.path.join(root, "sr_for_cfd_tpu_torch", "csrc", "fused_step.cu")).read()
    common = open(os.path.join(root, "sr_for_cfd_tpu_torch", "csrc", "common.cuh")).read()
    threads = int(re.search(r"#define SRCFD_THREADS (\d+)", common).group(1))
    limit = re.search(r"kSmallSmemMax = (\d+) - 2 \* SRCFD_THREADS \* sizeof\(float\)", src)
    assert limit and SMALL_SMEM_MAX == int(limit.group(1)) - 2 * threads * 4
    assert "(12 * (size_t)nx2 * ny2 + 2 * (size_t)ny2) * sizeof(float)" in src
    assert small_fits(12, 12) and small_fits(52, 52) and small_fits(62, 62)
    assert not small_fits(402, 402) and not small_fits(82, 82)
