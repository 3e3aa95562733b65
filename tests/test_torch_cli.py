"""The port's command line against the JAX package's, on the CPU: the
parser (every subcommand's options and defaults), a cavity run through
`main`, the hybrid's keyword wiring, the sweep and training through
`main`, and the subcommands that are not ported yet."""

import json
import os
import re
import sys

import h5py
import numpy as np
import pytest
import torch

from sr_for_cfd_tpu import cli as jcli
from sr_for_cfd_tpu_torch import cli as tcli

# the grids are tiny: more than one intra-op thread only adds overhead
torch.set_num_threads(1)


def _subparsers(parser):
    (action,) = [a for a in parser._actions if a.dest == "command"]
    return action.choices


def _options(parser):
    """{dest: (option strings, default, choices, nargs, type, const)} of
    every option but help and --device."""
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.type,
                     a.const)
            for a in parser._actions if a.dest not in ("help", "device")}


def test_parser_matches_jax_s():
    """The JAX package's subcommands, with the same option names, defaults,
    choices and set_defaults; `--device` (default the card) on every
    subcommand that runs a solve, a training or a measurement (`plan`
    times the single-device step)."""
    jsub, tsub = _subparsers(jcli.build_parser()), _subparsers(tcli.build_parser())
    assert list(tsub) == list(jsub) == ["cavity", "bfs", "hybrid", "sweep", "train",
                                        "bench", "plan"]
    for name, jp in jsub.items():
        tp = tsub[name]
        assert _options(tp) == _options(jp), name
        assert {k: v for k, v in tp._defaults.items() if k != "fn"} == \
            {k: v for k, v in jp._defaults.items() if k != "fn"}, name
        devices = [a for a in tp._actions if a.dest == "device"]
        if name == "bench":
            assert not devices
        else:
            assert devices[0].default == "cuda" and devices[0].choices == ["cuda", "cpu"]


def _converged(out):
    (line,) = [ln for ln in out.splitlines() if "Converged in" in ln]
    return int(re.search(r"Converged in (\d+) iterations", line).group(1))


def test_cavity_via_main_matches_jax_s(tmp_path, capsys):
    """The same iteration count and the same artifact suite as the JAX
    package's CLI (12^2, float64, UPWIND at dt 3.2e-2, to convergence)."""
    argv = ["cavity", "--re", "100", "--nx", "12", "--dt", "3.2e-2", "--scheme", "UPWIND",
            "--dtype", "float64", "--chunk-size", "2000", "--quiet"]
    jcli.main(argv + ["--out", str(tmp_path / "jax" / "cav")])
    jn = _converged(capsys.readouterr().out)
    assert tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port" / "cav")]) \
        is None
    assert _converged(capsys.readouterr().out) == jn < 100000
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert len(os.listdir(tmp_path / "port")) == 6
    assert (tmp_path / "port" / "cav_centerline.dat").read_text() == \
        (tmp_path / "jax" / "cav_centerline.dat").read_text()


def _hybrid_kw(monkeypatch, argv):
    """The keywords `cmd_hybrid` passes to `run_hybrid_experiment`, and the
    JSON it prints of the results."""
    import sr_for_cfd_tpu_torch.workflow.hybrid as hybrid

    seen = {}

    def fake_run(**kw):
        seen.update(kw)
        return {"hr_fields": None, "coarse_fields": None, "solvers": None,
                "centerline_diff": {}, "speedup": 1.0, "kernel_launches": {"ml": {}}}

    monkeypatch.setattr(hybrid, "run_hybrid_experiment", fake_run)
    tcli.main(["hybrid", "--quiet", *argv])
    return seen


def test_hybrid_rre_fine_wiring(monkeypatch, capsys):
    """--rre-fine threads rre_every/rre_depth into the fine-phase keywords
    (warm and cold runs) while --rre stays coarse-only via
    coarse_overrides; --chunk-size and --plateau go through only when
    changed; the JSON drops the fields and solvers and keeps the launches."""
    seen = _hybrid_kw(monkeypatch, [
        "--ml-iterations", "10", "--normal-iterations", "10", "--rre", "2000",
        "--rre-fine", "5000", "--rre-depth", "3", "--device", "cpu"])
    assert seen["rre_every"] == 5000
    assert seen["rre_depth"] == 3
    assert seen["coarse_overrides"]["rre_every"] == 2000
    assert seen["device"] == "cpu"
    assert "chunk_size" not in seen and "plateau_patience" not in seen
    out = json.loads(capsys.readouterr().out)
    assert out == {"centerline_diff": {}, "speedup": 1.0, "kernel_launches": {"ml": {}}}
    seen = _hybrid_kw(monkeypatch, ["--chunk-size", "50", "--plateau", "3"])
    assert seen["chunk_size"] == 50 and seen["plateau_patience"] == 3
    assert seen["device"] == "cuda" and "coarse_overrides" not in seen
    assert "rre_every" not in seen


def test_sweep_and_train_via_main(tmp_path, capsys, monkeypatch):
    """The JAX CLI test's sweep (Re 100 and 200 at 10^2 and 20^2, float64
    UPWIND; cut to 50 steps) gives the JAX CLI's combined HDF5 groups and
    fields (within 1e-10); training on it through `main` prints its loss
    and exports the msgpack triple (TensorFlow kept out: the Keras export
    prints its skip line)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    argv = ["sweep", "--re-list", "100", "200", "--mesh-sizes", "10", "20", "--dt", "2e-3",
            "--dtype", "float64", "--scheme", "UPWIND", "--max-iterations", "50",
            "--quiet"]
    jcli.main(argv + ["--out", str(tmp_path / "jd")])
    tcli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "d")])
    combined = str(tmp_path / "d" / "simulation_result_double_lid.h5")
    with h5py.File(combined) as t, \
            h5py.File(tmp_path / "jd" / "simulation_result_double_lid.h5") as j:
        assert sorted(t) == sorted(j) and len(t) == 4
        for g in j:
            for k in ("u", "v", "p"):
                np.testing.assert_allclose(t[g][k][()], j[g][k][()], rtol=0, atol=1e-10)
    capsys.readouterr()
    tcli.main([
        "train", combined, "--lr-dim", "10", "--hr-dim", "20",
        "--epochs", "3", "--batch-size", "2", "--test-re", "200",
        "--out", str(tmp_path / "m"), "--suffix", "clitest", "--quiet", "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "Final loss" in out and "(Keras .h5 export skipped: ModuleNotFoundError" in out
    for name in ("vanilla_encoder10_to_20_clitest.msgpack",
                 "vanilla_decoder20_from_10_clitest.msgpack",
                 "vanilla_superres_10to20_clitest.msgpack",
                 "standardization_stats_10to20_clitest.txt"):
        assert (tmp_path / "m" / name).exists(), name


@pytest.mark.parametrize("argv, item", [
    (["bench"], "A9"), (["plan"], "A11"),
    (["cavity", "--spmd", "2", "--device", "cpu"], "A11"),
    (["bfs", "--spmd", "2", "--device", "cpu"], "A11"),
    (["hybrid", "--spmd", "2", "--device", "cpu"], "A11"),
    (["sweep", "--spmd", "2", "--device", "cpu"], "A11"),
    (["sweep", "--device-mesh", "--device", "cpu"], "A11"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_unported_subcommands_exit_naming_their_item(argv, item, monkeypatch, tmp_path,
                                                      capsys):
    """`bench` exits non-zero naming its ROADMAP item. The commands that
    exited naming A11 before they were ported now run: `plan` on the CPU
    measures the single-device ms/step here, runs the census of 2 ranks in
    gloo child processes and writes its JSON (the source naming the CPU);
    the decomposed commands need a process group of N ranks: without one,
    `cavity`, `bfs` and `hybrid` with `--spmd 2` exit before any solve,
    naming `torchrun --nproc-per-node 2`, and `sweep` hands `--spmd` and
    `--device-mesh` to `generate_training_data`."""
    import sr_for_cfd_tpu_torch.workflow.sweep as sweep

    if argv == ["plan"]:
        out = tmp_path / "plan.json"
        tcli.main(argv + ["--device", "cpu", "--nx", "8", "--ny", "8", "--dt", "2e-3",
                          "--re", "100", "--scheme", "UPWIND", "--dtype", "float64",
                          "--devices", "1", "2", "--trip-window", "2", "--json", str(out)])
        text = capsys.readouterr().out
        plan = json.loads(out.read_text())
        assert item not in text and "decomposition plan: 8x8" in text
        assert [r["n_devices"] for r in plan["rows"]] == [1, 2]
        assert all(r["feasible"] for r in plan["rows"])
        assert plan["rows"][1]["collective_calls_per_step"] > 0
        assert plan["ms_per_step_source"] == "measured live on cpu"
        return

    if argv[0] == "sweep":
        seen = {}
        monkeypatch.setattr(sweep, "generate_training_data",
                            lambda **kw: seen.update(kw) or "combined.h5")
        tcli.main(argv)
        assert (seen["spmd_devices"], seen["use_device_mesh"]) == \
            ((2, False) if "--spmd" in argv else (1, True))
        return
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    text = str(e.value.code)
    if argv[0] == "bench":
        assert e.value.code != 0 and f"item {item}" in text
    else:
        assert text.startswith("--spmd 2 needs 2 devices; backend has 1 (")
        assert "torchrun --nproc-per-node 2" in text


def test_sweep_without_h5py_raises_before_solving(monkeypatch, tmp_path):
    import sr_for_cfd_tpu_torch.workflow.sweep as sweep

    def solve(*a, **k):
        raise AssertionError("solved before the h5py check")

    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setattr(sweep, "batched_cavity_solve", solve)
    with pytest.raises(ImportError, match="h5py"):
        tcli.main(["sweep", "--device", "cpu", "--out", str(tmp_path / "d")])
