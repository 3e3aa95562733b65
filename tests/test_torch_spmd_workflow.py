"""The port's decomposed workflow on four gloo ranks against the JAX
package on four virtual devices, on the CPU: the hybrid with
`spmd_devices=4` (its fine phases on `SpmdSolver` behind
`SpmdWorkflowAdapter`), the same run through the command line's `--spmd 4`,
`batched_spmd_cavity_solve` on a 2x2 case x x mesh, data-parallel training,
and the sweep's two routes over the ranks.

The port's ranks are spawned processes (`spmd_ranks.py`), one spawn of four
ranks for the whole file; each JAX reference runs once. Tolerances:

* the hybrid (BFS 8 -> 16, bicubic SR, float64): equal iterations in each
  phase, fields within 1e-10; the command line's run equal iterations and
  its `_full.dat` files, written by rank 0 alone, within the 6-decimal
  print of JAX's;
* `batched_spmd_cavity_solve` (four cavity cases, 16^2, multigrid,
  float64): equal counts per case, fields within 1e-10;
* data-parallel training (10 -> 20, a batch of 6 rounded to 8 over four
  ranks, float32, JAX's initial weights): the loss history within 1e-5
  relative, the kept weights the same on every rank;
* the sweep's two routes against JAX's with its backend cut to four
  devices: the cases over four ranks (`mesh_devices`) with JAX's counts
  and fields within 1e-10, and bit-equal to the sweep in one process;
  `generate_training_data(use_device_mesh=True, spmd_devices=2)` (2x2
  mesh) writes rank 0's HDF5 with JAX's groups and attributes and its
  datasets within 1e-10, a size that M does not divide on the
  case-parallel path; where the case x M mesh would leave ranks idle,
  every rank takes the case-parallel path with the notice;
* `batch_sharding` and `replicated` give each rank the block that JAX's
  shardings give its device.

The refusals of the decomposed paths carry the JAX package's texts.
"""

import os

import numpy as np
import pytest
import torch

import spmd_ranks
from spmd_ranks import max_abs

torch.set_num_threads(1)

WORLD = 4
HYBRID = dict(Re=100.0, lr_dim=8, hr_dim=16, case="bfs", max_iterations_coarse=40,
              max_iterations_ml=4, max_iterations_normal=4, use_aspect_ratio_correction=True,
              dtype="float64", fused_step=False, pressure_sor=1.0,
              pressure_solver="multigrid", steps_per_kernel=1, use_pallas=False,
              spmd_devices=WORLD, verbose=False)
# the ML phase's arguments in run_hybrid_experiment (BFS: UPWIND at 2e-3)
WARM = dict(Re=100.0, nx=16, ny=16, dt=2e-3, scheme="UPWIND", case="bfs", max_iterations=4,
            dtype="float64", fused_step=False, pressure_sor=1.0, pressure_solver="multigrid",
            steps_per_kernel=1, use_pallas=False, spmd_devices=WORLD, verbose=False,
            save_results=False)
CLI_HYBRID = ["hybrid", "--case", "bfs", "--re", "100", "--lr-dim", "8", "--hr-dim", "16",
              "--dtype", "float64", "--pressure-solver", "multigrid", "--max-iterations", "40",
              "--ml-iterations", "4", "--normal-iterations", "4", "--spmd", str(WORLD),
              "--device", "cpu", "--quiet"]
BATCH_RE = [100.0, 200.0, 300.0, 400.0]
BATCH = dict(max_iterations=6, chunk_size=4, pressure_solver="multigrid", dtype="float64")
SWEEP_RE = [100.0, 200.0, 300.0, 400.0]
SWEEP = dict(max_iterations=12, chunk_size=5, dtype="float64")
DP = dict(epochs=3, batch_size=6, seed=3, verbose=False, log_every=3)


def jax_tree(tree, jnp):
    return {k: jax_tree(v, jnp) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _dp_data():
    rng = np.random.default_rng(11)
    x_hr = rng.standard_normal((8, 20, 20, 1)).astype(np.float32)
    return x_hr.reshape(8, 10, 2, 10, 2, 1).mean(axis=(2, 4)), x_hr


def _init_state():
    """The port's initial 10 -> 20 weights for seed DP["seed"]; JAX's run
    starts from the same (its `init` replaced by them)."""
    from sr_for_cfd_tpu_torch.models.autoencoder import SuperResolutionAE, flax_init_

    module = flax_init_(SuperResolutionAE(10, 20), torch.Generator().manual_seed(DP["seed"]))
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def jax_hybrid(tmp_path_factory):
    """JAX's hybrid on four devices, its solvers recorded as the workflow
    makes them: (iterations, each phase's whole fields, the SR fields)."""
    from sr_for_cfd_tpu.workflow import hybrid as jh

    made = []
    make = jh._make_solver

    def recorded(*a, **k):
        made.append(make(*a, **k))
        return made[-1]

    out = tmp_path_factory.mktemp("jax_hybrid")
    jh._make_solver = recorded
    try:
        res = jh.run_hybrid_experiment(output_dir=str(out), save_results=False, **HYBRID)
    finally:
        jh._make_solver = make
    iterations = [res[f"{p}_iterations"] for p in ("coarse", "ml", "normal")]
    fields = {p: s.Var for p, s in zip(("coarse", "ml", "normal"), made)}
    hr = {c: np.asarray(v) for c, v in res["hr_fields"].items()}
    return iterations, fields, hr


def _read_h5(path):
    """{group: (attributes, {dataset: array})} of an HDF5 file."""
    import h5py

    with h5py.File(path, "r") as f:
        return {g: (dict(f[g].attrs), {d: f[g][d][:] for d in f[g]}) for g in f}


@pytest.fixture(scope="module")
def jax_sweeps(tmp_path_factory):
    """JAX's sweep routes with its backend cut to the four devices that the
    port has ranks: `batched_cavity_solve` over `make_mesh(4)`, and
    `generate_training_data(use_device_mesh=True, spmd_devices=2)` (16^2 on
    a 2x2 case x x mesh, 9^2 with the cases over the four devices):
    ((fields, counts), the HDF5 file read)."""
    import jax

    from sr_for_cfd_tpu.parallel.mesh import make_mesh
    from sr_for_cfd_tpu.workflow.sweep import batched_cavity_solve, generate_training_data

    four = jax.devices()[:WORLD]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda *a, **k: four)
        sweep = batched_cavity_solve(SWEEP_RE, 10, 10, mesh_devices=make_mesh(WORLD),
                                     verbose=False, **SWEEP)
        path = generate_training_data(
            BATCH_RE, [16, 9], output_dir=str(tmp_path_factory.mktemp("jax_sweep")),
            use_device_mesh=True, spmd_devices=2, verbose=False, **BATCH)
    return sweep, _read_h5(path)


def _same_h5(got, want, groups):
    """The HDF5 groups `groups` of `got` as in `want`: equal attributes,
    the same datasets, each within 1e-10."""
    for g in groups:
        attrs, data = got[g]
        assert attrs == want[g][0], g
        assert sorted(data) == sorted(want[g][1]), g
        for d in data:
            assert max_abs(data[d], want[g][1][d]) <= 1e-10, (g, d)


@pytest.fixture(scope="module")
def port(tmp_path_factory, jax_hybrid):
    """Every case of the file on one spawn of four gloo ranks: rank 0's
    results and the directory the ranks wrote to."""
    tmp = tmp_path_factory.mktemp("spmd_workflow")
    x_lr, x_hr = _dp_data()
    state = _init_state()
    cases = {
        "hybrid": ("hybrid", dict(kw=dict(HYBRID, save_results=False))),
        "warm": ("warm_fine", dict(fields=jax_hybrid[2], kw=WARM)),
        "cli": ("cli", dict(argv=CLI_HYBRID + ["--out", str(tmp / "cli")])),
        "batched": ("batched_spmd", dict(n_case=2, n_x=2, reynolds=BATCH_RE, n=16,
                                         kw=BATCH)),
        "sweep": ("sweep_over_ranks", dict(reynolds=SWEEP_RE, n=10, kw=SWEEP)),
        "files": ("sweep_files", dict(out_dir=str(tmp / "sweep"), reynolds=BATCH_RE,
                                      sizes=[16, 9], kw=dict(BATCH, spmd_devices=2,
                                                             use_device_mesh=True))),
        # 4 ranks, M = 3: a 1x3 mesh would leave rank 3 idle
        "idle": ("sweep_files", dict(out_dir=str(tmp / "idle"), reynolds=BATCH_RE,
                                     sizes=[9], kw=dict(BATCH, spmd_devices=3,
                                                        use_device_mesh=True))),
        # 4 ranks, M = 2, 3 cases: a 1x2 mesh would leave two ranks idle
        "idle3": ("sweep_files", dict(out_dir=str(tmp / "idle3"), reynolds=BATCH_RE[:3],
                                      sizes=[8], kw=dict(BATCH, spmd_devices=2))),
        "dp": ("dp_fit", dict(state=state, x_lr=x_lr, x_hr=x_hr, kw=DP)),
        "shardings": ("shardings", dict(n=8)),
    }
    ranks = tmp / "ranks"
    ranks.mkdir()
    return spmd_ranks.run_ranks(ranks, WORLD, cases), tmp


def test_hybrid_with_spmd_devices_matches_jax(port, jax_hybrid):
    """Coarse on one device, SR on each rank, the warm and cold fine phases
    row-decomposed over four ranks behind the adapter: JAX's iterations in
    every phase; the coarse and cold fields within 1e-10, the warm phase
    within 1e-10 from JAX's own SR fields (from the port's, whose float32
    bicubic SR rounds apart from JAX's, within 1e-5 of the largest value)."""
    iterations, fields, _ = jax_hybrid
    got = port[0]["hybrid"]
    assert got["iterations"] == iterations
    for phase in ("coarse", "normal"):
        assert max_abs(got["fields"][phase], fields[phase]) <= 1e-10, phase
    scale = float(np.max(np.abs(fields["ml"])))
    assert max_abs(got["fields"]["ml"], fields["ml"]) <= 1e-5 * scale
    warm_iterations, warm = port[0]["warm"]
    assert warm_iterations == iterations[1]
    assert max_abs(warm, fields["ml"]) <= 1e-10


def _read_full_dat(path):
    rows = [ln.split() for ln in open(path) if ln.strip() and not ln.startswith("#")]
    return np.array(rows, dtype=np.float64)


def test_cli_spmd_hybrid_matches_jax(port, jax_hybrid):
    """`hybrid --spmd 4` on four ranks (matplotlib blocked there): the
    results JSON printed by rank 0 alone, with JAX's iterations; each
    phase's .dat pair and .h5 written once, under the JAX package's names,
    the `_full.dat` fields within their 6-decimal print of JAX's (the warm
    phase's within its tolerance above too)."""
    import json

    from sr_for_cfd_tpu.utils.naming import coarse_run_name, fine_run_name

    iterations, fields, _ = jax_hybrid
    out = port[0]["cli"]
    assert out.count('"coarse_iterations"') == 1
    res = json.loads(out[out.index("\n{") + 1:])
    assert [res[f"{p}_iterations"] for p in ("coarse", "ml", "normal")] == iterations
    bases = {"coarse": coarse_run_name("", "bfs_", 100.0, 8, 40),
             "ml": fine_run_name("", "bfs", 100.0, 16, 16, 40, 4, "ML") + "_accelerated",
             "normal": fine_run_name("", "bfs", 100.0, 16, 16, None, 4, "NORMAL") + "_normal"}
    cli_dir = port[1] / "cli"
    assert sorted(os.listdir(cli_dir)) == sorted(
        b + s for b in bases.values() for s in (".h5", "_centerline.dat", "_full.dat"))
    for phase, base in bases.items():
        got = _read_full_dat(cli_dir / f"{base}_full.dat").reshape(fields[phase].shape)
        # the warm phase from the port's SR fields (see the test above)
        tol = 1e-5 * float(np.max(np.abs(fields[phase]))) if phase == "ml" else 0.0
        assert max_abs(got, fields[phase]) <= tol + 5.01e-7, phase


def test_batched_spmd_2x2_matches_jax(port):
    """Two cases a case row, each case's 16 rows over two ranks: every
    case's count and fields as JAX's 2x2 run."""
    from sr_for_cfd_tpu.parallel.spmd_batch import batched_spmd_cavity_solve, make_case_x_mesh

    fields, counts = batched_spmd_cavity_solve(BATCH_RE, 16, 16, make_case_x_mesh(2, 2),
                                               verbose=False, **BATCH)
    got_fields, got_counts = port[0]["batched"]
    np.testing.assert_array_equal(got_counts, counts)
    assert sorted(got_fields) == sorted(fields)
    for re_val in fields:
        for c in "uvp":
            assert max_abs(got_fields[re_val][c], fields[re_val][c]) <= 1e-10, (re_val, c)


def test_sweep_routes_over_four_ranks(port, jax_sweeps):
    """The cases in blocks over four ranks: JAX's counts and fields on four
    devices, and bit for bit the sweep in one process.
    `generate_training_data(use_device_mesh=True, spmd_devices=2)` writes
    rank 0's HDF5 as JAX's: the 16^2 cases from the 2x2 decomposed solve,
    the 9^2 ones (9 % 2 != 0) from the case-parallel path over the four
    ranks; each also as the port's own solve."""
    from sr_for_cfd_tpu_torch.workflow.sweep import batched_cavity_solve

    (j_fields, j_counts), j_file = jax_sweeps
    got, got_counts = port[0]["sweep"]
    np.testing.assert_array_equal(got_counts, j_counts)
    assert sorted(got) == sorted(j_fields)
    for re_val in j_fields:
        for c in "uvp":
            assert max_abs(got[re_val][c], j_fields[re_val][c]) <= 1e-10, (re_val, c)
    want, want_counts = batched_cavity_solve(SWEEP_RE, 10, 10, device="cpu", verbose=False,
                                             **SWEEP)
    np.testing.assert_array_equal(got_counts, want_counts)
    for re_val in want:
        for c in "uvp":
            np.testing.assert_array_equal(got[re_val][c], want[re_val][c])

    path, printed = port[0]["files"]
    assert "mesh 9x9: nx % 2 != 0 - running case-parallel" in printed
    got_file = _read_h5(path)
    assert sorted(got_file) == sorted(j_file) == sorted(
        f"Re{int(r)}_mesh{n}x{n}" for r in BATCH_RE for n in (16, 9))
    _same_h5(got_file, j_file, j_file)
    nine, _ = batched_cavity_solve(BATCH_RE, 9, 9, device="cpu", verbose=False, **BATCH)
    sixteen, _ = port[0]["batched"]
    for n, fields in ((16, sixteen), (9, nine)):
        for re_val in BATCH_RE:
            for c in "uvp":
                np.testing.assert_array_equal(
                    got_file[f"Re{int(re_val)}_mesh{n}x{n}"][1][c].reshape(n, n),
                    fields[re_val][c])


def test_sweep_falls_back_where_the_mesh_leaves_ranks_idle(port, jax_sweeps):
    """Four ranks that the case x M mesh does not fill (M = 3; M = 2 with
    three cases): every rank refuses the decomposed path alike and takes
    the case-parallel one, rather than a rank outside the mesh waiting in
    collectives the others never join. The 9^2 file is JAX's."""
    from sr_for_cfd_tpu_torch.workflow.sweep import batched_cavity_solve

    path, printed = port[0]["idle"]
    assert ("mesh 9x9: decomposed path unavailable (a 1x3 case-x mesh leaves 1 of the "
            "4 ranks idle) - running case-parallel") in printed
    got, want = _read_h5(path), jax_sweeps[1]
    nine = [f"Re{int(r)}_mesh9x9" for r in BATCH_RE]
    assert sorted(got) == sorted(nine)
    _same_h5(got, want, nine)

    path, printed = port[0]["idle3"]
    assert ("mesh 8x8: decomposed path unavailable (a 1x2 case-x mesh leaves 2 of the "
            "4 ranks idle) - running case-parallel") in printed
    eight, _ = batched_cavity_solve(BATCH_RE[:3], 8, 8, device="cpu", verbose=False, **BATCH)
    got = _read_h5(path)
    assert sorted(got) == sorted(f"Re{int(r)}_mesh8x8" for r in BATCH_RE[:3])
    for re_val in BATCH_RE[:3]:
        for c in "uvp":
            np.testing.assert_array_equal(got[f"Re{int(re_val)}_mesh8x8"][1][c].reshape(8, 8),
                                          eight[re_val][c])


def test_shardings_give_each_rank_jax_s_block(port):
    """`batch_sharding` and `replicated` over four ranks: each rank's block
    of a leading axis of 8 is the index JAX's shardings give its device."""
    from sr_for_cfd_tpu.parallel.mesh import batch_sharding, make_mesh, replicated

    mesh = make_mesh(WORLD)
    for got, sharding in zip(port[0]["shardings"], (batch_sharding(mesh), replicated(mesh))):
        index = sharding.devices_indices_map((8,))
        want = [index[d][0] for d in mesh.devices.flat]
        assert got == [(s.start or 0, 8 if s.stop is None else s.stop) for s in want]


def test_data_parallel_training_matches_jax(port, monkeypatch):
    """Four ranks, a batch of 6 rounded up to 8 (2 a rank), both packages
    from the same initial weights: JAX's loss history on make_mesh(4)
    within 1e-5 relative; every rank keeps the same weights."""
    import jax.numpy as jnp

    from sr_for_cfd_tpu.models.autoencoder import SuperResolutionAE
    from sr_for_cfd_tpu.parallel.mesh import make_mesh
    from sr_for_cfd_tpu.workflow.training import train_sr_autoencoder
    from sr_for_cfd_tpu_torch.io.checkpoint import params_to_jax

    start = params_to_jax({k: torch.as_tensor(v) for k, v in _init_state().items()}, 10, 20)
    monkeypatch.setattr(SuperResolutionAE, "init", lambda self, *a, **k: jax_tree(start, jnp))
    x_lr, x_hr = _dp_data()
    want = train_sr_autoencoder(x_lr, x_hr, 10, 20, mesh=make_mesh(WORLD), **DP)
    history, _, same = port[0]["dp"]
    assert len(history) == len(want.loss_history) == DP["epochs"]
    np.testing.assert_allclose(history, want.loss_history, rtol=1e-5, atol=0)
    assert same


@pytest.mark.parametrize("change", ["rre_every", "use_pallas", "fused_step", "tiled",
                                    "cases", "rows"])
def test_batched_spmd_refusals_are_jax_s(change):
    """The case-batched path's refusals, word for word."""
    from sr_for_cfd_tpu.parallel import spmd_batch as jb

    from sr_for_cfd_tpu_torch.parallel import spmd_batch as tb
    from sr_for_cfd_tpu_torch.parallel.mesh import Mesh

    kw = {"rre_every": dict(rre_every=10), "use_pallas": dict(use_pallas=True),
          "fused_step": dict(fused_step=True), "tiled": dict(pressure_solver="tiled"),
          "cases": {}, "rows": {}}[change]
    res = [100.0, 200.0, 300.0] if change == "cases" else [100.0, 200.0]
    n = 15 if change == "rows" else 16
    shape = {"cases": (2, 1), "rows": (1, 2)}.get(change, (1, 1))
    with pytest.raises(ValueError) as j:
        jb.batched_spmd_cavity_solve(res, n, n, jb.make_case_x_mesh(*shape), **kw)
    with pytest.raises(ValueError) as t:
        tb.batched_spmd_cavity_solve(res, n, n, Mesh(range(shape[0] * shape[1]),
                                                     ("case", "x"), shape),
                                     device="cpu", **kw)
    assert str(t.value) == str(j.value)


def test_too_few_ranks_are_refused_like_jax():
    """A mesh larger than the process group is refused as JAX refuses one
    larger than its backend, naming torchrun."""
    from sr_for_cfd_tpu import cli as jcli
    from sr_for_cfd_tpu.parallel import spmd_batch as jb

    from sr_for_cfd_tpu_torch import cli as tcli
    from sr_for_cfd_tpu_torch.parallel import mesh as tmesh
    from sr_for_cfd_tpu_torch.parallel import spmd_batch as tb

    with pytest.raises(ValueError) as j:
        jb.make_case_x_mesh(4, 4)
    with pytest.raises(ValueError) as t:
        tb.make_case_x_mesh(4, 4)
    assert str(j.value) == "case-x mesh needs 4x4=16 devices; backend has 8"
    assert str(t.value) == "case-x mesh needs 4x4=16 devices; backend has 1"
    with pytest.raises(SystemExit) as j:
        jcli.main(["cavity", "--spmd", "16"])
    with pytest.raises(SystemExit) as t:
        tcli.main(["cavity", "--spmd", "16", "--device", "cpu"])
    j_text, t_text = str(j.value.code), str(t.value.code)
    assert j_text.startswith("--spmd 16 needs 16 devices; backend has 8 (")
    assert t_text.startswith("--spmd 16 needs 16 devices; backend has 1 (")
    assert "torchrun --nproc-per-node 16" in t_text
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tmesh.make_mesh(2)
    with pytest.raises(ValueError, match="axis of 6 does not divide over the 4 ranks"):
        tmesh.batch_sharding(tmesh.Mesh(range(4), ("dp",), (4,))).block(6)
